"""Quality and speed of the fast-eval renderers on trained parameters.

  python -m cross_attention_renderer_torch.tools.eval_pruned \\
      --params PATH.npz [--pruned 16,24] [--narrow 64,64,64] [--worlds 4] \\
      [--dtype bf16|f32] [--n-chunks 4] [--config medium|tiny] \\
      [--world plane|boxes] [--device cuda|cpu]

The port of the JAX repository's ``tools/eval_pruned.py``. Loads the
parameters that ``capability_run --save`` wrote (or the JAX tool's file:
``utils/params_io.load_params`` converts it), renders the full 64x64 query
image of ``--worlds`` unseen worlds (seeds 200000 + i) seven ways
(``train/evaluation.py``) and prints each mode's mean PSNR against the
ground truth and its render time:

  dense          the uniform render at the config's npoints
  uniform_fine   the uniform render at n_fine samples (the naive cut)
  pruned         coarse-to-fine: n_coarse uniform, then n_fine placed
  narrow         per-scene PCA narrowing to ``--narrow``
  q8             int8 cell tables
  narrow+pruned  the two composed
  all(n+p+q8)    the three composed

A mode's time is the wall time of ``iters`` (8) images after one warm-up,
between ``torch.cuda.synchronize()`` calls, the latent encoded once a
world beforehand. On the card the renders run K1 and K2 (int8 tables for
q8); the warm-up image of the first world records each mode's launches.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch

from cross_attention_renderer_torch.ops import epipolar_attention as EA
from cross_attention_renderer_torch.ops import fused_render as FR
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.tools.capability_run import (
    CONFIGS, H, W, build_model, load_world, psnr, to_scene)
from cross_attention_renderer_torch.train.evaluation import (
    make_fast_renderer, make_pruned_renderer, make_scan_renderer)
from cross_attention_renderer_torch.utils.params_io import load_params

# the V=2 staged path's kernels, whose launches a mode's image records
KERNELS = (EA.epipolar_attention, GE.fused_exchange_epilogue,
           FR.fused_render_core)


def renderers(model, n_chunks: int, pruned: tuple, narrow: tuple
              ) -> dict[str, Callable]:
    """Each mode's whole-image renderer, ``fn(scene, z, uv) -> (rgb,
    valid)``."""
    n_coarse, n_fine = pruned
    return {
        'dense': make_scan_renderer(model, n_chunks),
        'uniform_fine': make_scan_renderer(model.clone(npoints=n_fine),
                                           n_chunks),
        'pruned': make_pruned_renderer(model, n_chunks, n_coarse, n_fine),
        'narrow': make_fast_renderer(model, n_chunks, narrow=narrow),
        'q8': make_fast_renderer(model, n_chunks, q8=True),
        'narrow+pruned': make_fast_renderer(model, n_chunks, pruned=pruned,
                                            narrow=narrow),
        'all(n+p+q8)': make_fast_renderer(model, n_chunks, pruned=pruned,
                                          narrow=narrow, q8=True),
    }


def _sync(device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def timed(render: Callable, scene: dict, z, uv, iters: int = 8,
          launches: dict = None):
    """(the image, seconds an image) over ``iters`` images after one
    warm-up; ``launches``, where given, receives the warm-up's launches
    by kernel name."""
    device = uv.device
    before = [k.launches for k in KERNELS]
    rgb, _ = render(scene, z, uv)
    _sync(device)
    if launches is not None:
        launches.update({k.__name__: k.launches - n
                         for k, n in zip(KERNELS, before)})
    t0 = time.perf_counter()
    for _ in range(iters):
        rgb, _ = render(scene, z, uv)
    _sync(device)
    return rgb, (time.perf_counter() - t0) / iters


def evaluate(model, world: str = 'plane', worlds: int = 4,
             pruned: tuple = (16, 24), narrow: tuple = (64, 64, 64),
             n_chunks: int = 4, iters: int = 8, device='cuda') -> dict:
    """Every mode's PSNR and time on the unseen worlds. Returns {mode:
    {'psnr', 'ms', 'rays_per_s', 'launches'}}, the means over the
    worlds (launches: the first world's warm-up image)."""
    dev = torch.device(device)
    renders = renderers(model, n_chunks, pruned, narrow)
    rows = {k: [] for k in renders}
    times = {k: [] for k in renders}
    launches = {k: {} for k in renders}
    for wi in range(worlds):
        scene = to_scene(load_world(200000 + wi, world), dev)
        gt = scene['query']['rgb']
        uv = scene['query']['uv']
        with torch.inference_mode():
            z = model.encode(scene)
        for name, render in renders.items():
            rgb, dt = timed(render, scene, z, uv, iters,
                            launches[name] if wi == 0 else None)
            rows[name].append(psnr(rgb.float().cpu(), gt.cpu()))
            times[name].append(dt)
    return {k: {'psnr': float(np.mean(rows[k])),
                'ms': 1e3 * float(np.mean(times[k])),
                'rays_per_s': H * W / float(np.mean(times[k])),
                'launches': launches[k]} for k in renders}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--params', required=True)
    ap.add_argument('--pruned', default='16,24', metavar='C,F')
    ap.add_argument('--narrow', default='64,64,64', metavar='K1,K2,K3',
                    help='PCA-narrowed widths a level (the medium '
                         "config's full widths: 128,128,64)")
    ap.add_argument('--worlds', type=int, default=4,
                    help='number of unseen eval worlds')
    ap.add_argument('--dtype', default='bf16', choices=['f32', 'bf16'])
    ap.add_argument('--n-chunks', type=int, default=4)
    ap.add_argument('--config', default='medium', choices=list(CONFIGS),
                    help='the capability_run --config of --params')
    ap.add_argument('--world', default='plane', choices=['plane', 'boxes'],
                    help='the capability_run --world of --params')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = ap.parse_args(argv)
    n_coarse, n_fine = (int(x) for x in args.pruned.split(','))
    narrow = tuple(int(x) for x in args.narrow.split(','))

    model = build_model(args.config, args.dtype, args.device).eval()
    model.load_state_dict(load_params(args.params))
    table = evaluate(model, args.world, args.worlds, (n_coarse, n_fine),
                     narrow, args.n_chunks, device=args.device)

    print(f'\n{args.config}: npoints={model.n_samples} dense | '
          f'uniform@{n_fine} | pruned {n_coarse}+{n_fine} | '
          f'narrow {args.narrow} ({args.worlds} unseen worlds, '
          f'{H}x{W}, dtype={args.dtype})')
    for name, row in table.items():
        print(f'{name:>13}: psnr {row["psnr"]:6.2f} dB  '
              f'render {row["ms"]:7.1f} ms/image  '
              f'({row["rays_per_s"]:,.0f} rays/s)')
    return table


if __name__ == '__main__':
    main()
