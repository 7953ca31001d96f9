"""Timing of one flagship 8,192-ray render block on one NVIDIA card.

  python -m cross_attention_renderer_torch.tools.bench_block \\
      [std|sorted|take] [--iters 6] [--device cuda]

Port of the JAX repository's ``tools/bench_block.py``: the flagship V=2
model (bf16, seed-0 parameters) renders the first 8,192 rays of
``make_scene(0)`` at 256x256 from a cached, packed pyramid; one warm-up
block, then ``--iters`` blocks on the host's clock between
synchronisations. Modes: ``std`` the default path (K2 and K1), ``sorted``
the sorted stream (K5), ``take`` the unfused exchange on the packed take
path (``fused_epilogue=False``, the JAX tool's take mode). Prints ms a
block, rays/s and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import torch

from cross_attention_renderer_torch.tools import _card

MODES = {'std': {}, 'sorted': dict(sorted_stream=True),
         'take': dict(fused_epilogue=False)}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('mode', nargs='?', default='std', choices=sorted(MODES))
    p.add_argument('--iters', type=int, default=6)
    _card.add_device_flag(p)
    return p


def block_ms(model, scene, iters: int, dev, rays: int = _card.RAY_BLOCK
             ) -> tuple:
    """(mean ms a block, the last block's rgb) of the first ``rays`` rays
    of ``scene``, the pyramid encoded and packed once."""
    from cross_attention_renderer_torch.ops.grid_sample import pack_pyramid
    block = _card.with_uv(scene, scene['query']['uv'][:, :, :rays])
    with torch.inference_mode():
        z = model.encode(scene)
        zp = pack_pyramid(z) if model.uses_packed_tables else None
        float(model(block, z=z, z_packed=zp)['rgb'].sum())
        t0 = time.perf_counter()
        for _ in range(iters):
            out = model(block, z=z, z_packed=zp)['rgb']
        float(out.sum())
    return (time.perf_counter() - t0) * 1e3 / iters, out


def main(argv=None) -> dict:
    opt = parser().parse_args(argv)
    dev = _card.device('bench_block', opt.device)
    _card.print_card(dev)
    model = _card.flagship(2, dev, **MODES[opt.mode])
    ms, _ = block_ms(model, _card.full_scene(2, dev), opt.iters, dev)
    print(f'{opt.mode}: {ms:.1f} ms/block  '
          f'{_card.RAY_BLOCK / (ms * 1e-3):.0f} rays/s', flush=True)
    return {'mode': opt.mode, 'ms_per_block': ms}


if __name__ == '__main__':
    main()
