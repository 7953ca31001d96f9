"""The sorted-stream path against the default path at the flagship's
shapes, on one NVIDIA card.

  python -m cross_attention_renderer_torch.tools.bench_sorted_stream \\
      [--iters 4] [--device cuda]

Port of the JAX repository's ``tools/bench_sorted_stream.py``: one
8,192-ray block of ``make_scene(0)`` at 256x256 rendered by the flagship
V=2 model (seed-0 parameters) in bf16 on the default path (K2, K1), in
bf16 on the sorted stream (K5, K1) and in f32 on the default path, each
model encoding the scene once and packing its pyramid once; ``--iters``
blocks after a warm-up each (half for f32), on the host's clock between
synchronisations (``bench_block.block_ms``). Prints
ms a block and rays/s a configuration, the parity of each bf16 image with
the f32 one (max and mean abs difference beside the rgb scale), and the
card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from cross_attention_renderer_torch.tools import _card
from cross_attention_renderer_torch.tools.bench_block import block_ms


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--iters', type=int, default=4)
    _card.add_device_flag(p)
    return p


def measure(opt, dev, hw: int = _card.H, rays: int = _card.RAY_BLOCK,
            **model_kw) -> dict:
    scene = _card.full_scene(2, dev, hw)
    runs = {}
    for name, dtype, kw, n in (
            ('std bf16', torch.bfloat16, {}, opt.iters),
            ('sorted', torch.bfloat16, dict(sorted_stream=True), opt.iters),
            ('std f32', torch.float32, {}, max(1, opt.iters // 2))):
        model = _card.flagship(2, dev, dtype=dtype, **kw, **model_kw)
        ms, rgb = block_ms(model, scene, n, dev, rays)
        runs[name] = (ms, rgb.float())
        print(f'{name:9s}: {ms:8.1f} ms/block  '
              f'{rays / (ms * 1e-3):10.0f} rays/s', flush=True)
        del model
    f32 = runs['std f32'][1]
    scale = float(f32.abs().mean())
    parity = {}
    for name, o in (('std_bf16 vs f32', runs['std bf16'][1]),
                    ('sorted   vs f32', runs['sorted'][1]),
                    ('sorted   vs std_bf16',
                     runs['sorted'][1] - runs['std bf16'][1] + f32)):
        d = (o - f32).abs()
        parity[name] = (float(d.max()), float(d.mean()))
        print(f'{name}: max={parity[name][0]:.3e} '
              f'mean={parity[name][1]:.3e} (rgb scale {scale:.2f})',
              flush=True)
    return {'ms': {k: v[0] for k, v in runs.items()}, 'parity': parity}


def main(argv=None) -> dict:
    opt = parser().parse_args(argv)
    dev = _card.device('bench_sorted_stream', opt.device)
    _card.print_card(dev)
    return measure(opt, dev)


if __name__ == '__main__':
    main()
