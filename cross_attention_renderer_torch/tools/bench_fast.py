"""Throughput of the fast-eval render modes at flagship shapes, on one
NVIDIA card.

  python -m cross_attention_renderer_torch.tools.bench_fast \\
      [--pruned 16,24] [--narrow 128,128,64] [--iters 4] \\
      [--modes dense,pruned,narrow,q8,all] [--views 2] [--fused_render]

The counterpart of the JAX repository's ``tools/bench_fast.py``, with
its ``bench.py``'s protocol: the flagship model (122M DPT-hybrid, bf16
compute, random weights from seed 0) on ``make_scene(0)`` at 256x256, the
encoder latent computed once, the full 65,536-ray image rendered in 8
blocks of 8,192 rays; per mode one warm-up image (its time printed as the
first call's), then ``--iters`` images between ``torch.cuda.synchronize()``
calls. The modes (``train/evaluation.py``):

  dense   the uniform 64-sample render (48 at ``--views 3``)
  pruned  coarse-to-fine sampling at ``--pruned``
  narrow  per-scene PCA narrowing to ``--narrow``
  q8      int8 cell tables
  nq8     narrow and q8
  all     the three composed

Throughput only: the levers' image quality needs trained weights, which the
repository does not ship. Prints the card's name and power limit, a line a
mode, and a JSON object of the modes' numbers last. Exits 1, printing no
result, without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

H = W = 256
RAY_BLOCK = 8192
N_BLOCKS = (H * W) // RAY_BLOCK


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--pruned', default='16,24')
    ap.add_argument('--narrow', default='128,128,64')
    ap.add_argument('--iters', type=int, default=4)
    ap.add_argument('--modes', default='dense,pruned,narrow,q8,all')
    ap.add_argument('--views', type=int, default=2, choices=(2, 3))
    ap.add_argument('--fused_render', action='store_true',
                    help='the fused V=2 render core (K4)')
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print('bench_fast: no CUDA device', file=sys.stderr)
        return 1
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from cross_attention_renderer_torch.tools.bench_train import card_line
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer, make_scan_renderer)
    pruned = tuple(int(x) for x in args.pruned.split(','))
    narrow = tuple(int(x) for x in args.narrow.split(','))
    dev = torch.device('cuda')
    scene = make_scene(0, n_view=args.views, H=H, W=W, n_rays=H * W,
                       full_image=True, device=dev)
    model = CrossAttentionRenderer(n_view=args.views, dtype=torch.bfloat16,
                                   fused_render=args.fused_render,
                                   device=dev).eval()
    with torch.inference_mode():
        z = model.encode(scene)
    uv = scene['query']['uv']
    builders = {
        'dense': lambda: make_scan_renderer(model, N_BLOCKS),
        'pruned': lambda: make_fast_renderer(model, N_BLOCKS, pruned=pruned),
        'narrow': lambda: make_fast_renderer(model, N_BLOCKS, narrow=narrow),
        'q8': lambda: make_fast_renderer(model, N_BLOCKS, q8=True),
        'nq8': lambda: make_fast_renderer(model, N_BLOCKS, narrow=narrow,
                                          q8=True),
        'all': lambda: make_fast_renderer(model, N_BLOCKS, pruned=pruned,
                                          narrow=narrow, q8=True),
    }
    card = card_line()
    print(f'card: {card} | {torch.cuda.get_device_name(0)}', flush=True)
    print(f'flagship 256x256, V={args.views}, bf16, fused_render='
          f'{args.fused_render}, pruned={pruned}, narrow={narrow}',
          flush=True)
    results = {}
    for name in args.modes.split(','):
        render = builders[name]()
        t0 = time.perf_counter()
        render(scene, z, uv)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.iters):
            rgb, _ = render(scene, z, uv)
        torch.cuda.synchronize()
        image_s = (time.perf_counter() - t0) / args.iters
        if not bool(torch.isfinite(rgb.float()).all()):
            raise RuntimeError(f'bench_fast: the {name} image is not finite')
        results[name] = {'image_ms': image_s * 1e3,
                         'rays_per_s': H * W / image_s,
                         'first_call_s': first_s}
        print(f'{name:>7}: {image_s * 1e3:8.1f} ms/image  '
              f'{H * W / image_s:10,.0f} rays/s  (first call '
              f'{first_s:.2f} s)', flush=True)
    print(json.dumps({'bench_fast': results, 'card': card,
                      'views': args.views,
                      'fused_render': args.fused_render}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
