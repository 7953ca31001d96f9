"""Render throughput above two views at the reference's 3-view operating
point, on one NVIDIA card.

  python -m cross_attention_renderer_torch.tools.bench_v3 [--iters 4] \\
      [--blocks 16] [--npoints 0] [--views 3] [--device cuda]

Port of the JAX repository's ``tools/bench_v3.py`` on its ``bench.py``'s
protocol: the flagship model (bf16, seed-0 parameters) at ``--views``
context views (3 by default; 48 samples above two views, models.py:47-54,
unless ``--npoints``), ``make_scene(0)`` at 256x256, the pyramid encoded
once, the 65,536-ray image rendered by ``make_scan_renderer`` in
``--blocks`` blocks (16 of 4,096 rays, the reference's halved chunk at 3
views, eval_realestate10k.py:144-149); one warm-up image, then
``--iters`` images on the host's clock between synchronisations. At V >= 3
the default exchange is kernel K3 with S = V streams. Prints the first
image's time (build and warm-up), ms an image and rays/s, and the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import time

import torch

from cross_attention_renderer_torch.tools import _card

RAY_BLOCK = 4096
N_BLOCKS = _card.H * _card.W // RAY_BLOCK


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--iters', type=int, default=4)
    p.add_argument('--blocks', type=int, default=N_BLOCKS)
    p.add_argument('--npoints', type=int, default=0,
                   help='0 = the reference default (48 above two views)')
    p.add_argument('--views', type=int, default=3)
    _card.add_device_flag(p)
    return p


def image_times(model, scene, n_chunks: int, iters: int, dev) -> tuple:
    """(first image s, mean ms an image over ``iters`` after it) of the
    scan renderer, on bench.py's protocol."""
    from cross_attention_renderer_torch.train.evaluation import (
        make_scan_renderer)
    render = make_scan_renderer(model, n_chunks)
    uv = scene['query']['uv']
    with torch.inference_mode():
        z = model.encode(scene)
    _card.sync(dev)
    t0 = time.perf_counter()
    float(render(scene, z, uv)[0].sum())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        rgb, _ = render(scene, z, uv)
    float(rgb.sum())
    return first, (time.perf_counter() - t0) * 1e3 / iters


def measure(opt, dev, hw: int = _card.H, **model_kw) -> dict:
    model = _card.flagship(opt.views, dev, npoints=opt.npoints, **model_kw)
    scene = _card.full_scene(opt.views, dev, hw)
    first, ms = image_times(model, scene, opt.blocks, opt.iters, dev)
    return {'first_s': first, 'ms_per_image': ms,
            'rays_per_s': hw * hw / (ms * 1e-3),
            'npoints': model.n_samples}


def main(argv=None) -> dict:
    opt = parser().parse_args(argv)
    dev = _card.device('bench_v3', opt.device)
    _card.print_card(dev)
    r = measure(opt, dev)
    print(f'first image: {r["first_s"]:.1f} s (build and warm-up, {dev})')
    print(f'V={opt.views} full image: {r["ms_per_image"]:.0f} ms  '
          f'{r["rays_per_s"] / 1e3:.1f}k rays/s '
          f'(npoints={r["npoints"]})', flush=True)
    return r


if __name__ == '__main__':
    main()
