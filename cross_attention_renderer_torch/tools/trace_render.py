"""Write a ``torch.profiler`` trace of three flagship render blocks.

  python -m cross_attention_renderer_torch.tools.trace_render \\
      [--out logs/trace_render] [--path std|sorted] [--blocks 3] \\
      [--device cuda]

Port of the JAX repository's ``tools/trace_render.py``: the flagship V=2
model (bf16, seed-0 parameters) on ``make_scene(0)`` at 256x256, the
pyramid encoded once and packed once, then one 8,192-ray block rendered
once as a warm-up and ``--blocks`` times (default 3) inside
``utils/profiling.py:trace``, which writes ``<out>/trace.json`` (a Chrome
trace: chrome://tracing or Perfetto; the model's ``car.*`` spans, such
as ``car.geometry``, ``car.address_math`` and ``car.attention``, lie on
the kernels' clock beside them). ``--out`` defaults to
``logs/trace_render`` under the working directory, which git ignores.
``--path sorted`` traces the sorted stream (K5) in place of the default
path (K2 and K1). Prints the ten kernels of most device time, the trace's
path and the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from cross_attention_renderer_torch.tools import _card


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--out', default='logs/trace_render')
    p.add_argument('--path', default='std', choices=['std', 'sorted'])
    p.add_argument('--blocks', type=int, default=3)
    _card.add_device_flag(p)
    return p


def run(opt, dev, hw: int = _card.H, rays: int = _card.RAY_BLOCK,
        **model_kw) -> list:
    """Renders and traces; returns the profiler's key averages, most device
    (or, on the CPU, host) time first."""
    from cross_attention_renderer_torch.ops.grid_sample import pack_pyramid
    from cross_attention_renderer_torch.utils.profiling import trace
    model = _card.flagship(2, dev, sorted_stream=opt.path == 'sorted',
                           **model_kw)
    scene = _card.full_scene(2, dev, hw)
    block = _card.with_uv(scene, scene['query']['uv'][:, :, :rays])
    with torch.inference_mode():
        z = model.encode(scene)
        zp = pack_pyramid(z) if model.uses_packed_tables else None
        model(block, z=z, z_packed=zp)
        _card.sync(dev)
        with trace(opt.out, cuda=dev.type == 'cuda') as prof:
            for _ in range(opt.blocks):
                out = model(block, z=z, z_packed=zp)
            float(out['rgb'].sum())
    key = 'device_time_total' if dev.type == 'cuda' else 'cpu_time_total'
    return sorted(prof.key_averages(), key=lambda e: getattr(e, key, 0.0),
                  reverse=True)


def main(argv=None) -> list:
    opt = parser().parse_args(argv)
    dev = _card.device('trace_render', opt.device)
    _card.print_card(dev)
    events = run(opt, dev)
    key = 'device_time_total' if dev.type == 'cuda' else 'cpu_time_total'
    for e in events[:10]:
        print(f'{getattr(e, key, 0.0) / 1e3 / opt.blocks:9.3f} ms a block '
              f'{e.count // opt.blocks:6d}x  {e.key[:90]}')
    print(f'trace written to {opt.out}/trace.json', flush=True)
    return events


if __name__ == '__main__':
    main()
