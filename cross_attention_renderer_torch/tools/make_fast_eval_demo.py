"""The fast-eval comparison strip: ground truth | dense | uniform cut |
pruned.

  python -m cross_attention_renderer_torch.tools.make_fast_eval_demo \\
      --params PATH.npz [--config tiny|medium] [--world boxes|plane] \\
      [--seed 200001] [--pruned C,F] [--out PATH.png] [--device cuda|cpu]

The port of the JAX repository's ``tools/make_fast_eval_demo.py``: the
parameters that ``capability_run --save`` wrote (f32 compute) render the
unseen world ``--seed`` (``eval_pruned`` scores 200000 + i) three ways,
in 4 ray blocks: dense at the config's npoints, uniform at n_fine samples
and coarse-to-fine pruned (default npoints / 2 coarse + npoints / 2
fine). Prints each render's PSNR and writes one PNG strip with
``utils/image.py:write_png``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from cross_attention_renderer_torch.tools.capability_run import (
    CONFIGS, H, W, build_model, load_world, psnr, to_scene, to_uint8)
from cross_attention_renderer_torch.train.evaluation import (
    make_pruned_renderer, make_scan_renderer)
from cross_attention_renderer_torch.utils.image import write_png
from cross_attention_renderer_torch.utils.params_io import load_params

DEFAULT_OUT = str(Path(__file__).resolve().parents[1] / 'build'
                  / 'fast_eval_boxes.png')


def main(argv=None) -> dict:
    """Returns {label: PSNR} of the three renders."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--params', required=True)
    ap.add_argument('--config', default='tiny', choices=list(CONFIGS))
    ap.add_argument('--world', default='boxes', choices=['plane', 'boxes'])
    ap.add_argument('--seed', type=int, default=200001,
                    help='world seed (eval_pruned uses 200000 + i)')
    ap.add_argument('--pruned', default=None, metavar='C,F',
                    help='default: npoints/2 coarse + npoints/2 fine')
    ap.add_argument('--out', default=DEFAULT_OUT)
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = ap.parse_args(argv)

    model = build_model(args.config, 'f32', args.device).eval()
    model.load_state_dict(load_params(args.params))
    P = model.n_samples
    nc, nf = ((int(x) for x in args.pruned.split(','))
              if args.pruned else (P // 2, P // 2))

    scene = to_scene(load_world(args.seed, args.world),
                     torch.device(args.device))
    with torch.inference_mode():
        z = model.encode(scene)
    uv = scene['query']['uv']
    gt = scene['query']['rgb'].float().cpu().numpy().reshape(H, W, 3)

    renders = {
        f'dense@{P}': make_scan_renderer(model, 4),
        f'uniform@{nf}': make_scan_renderer(model.clone(npoints=nf), 4),
        f'pruned {nc}+{nf}': make_pruned_renderer(model, 4, nc, nf),
    }
    tiles, labels, scores = [gt], ['ground truth'], {}
    for name, render in renders.items():
        rgb, _ = render(scene, z, uv)
        img = rgb.float().cpu().numpy().reshape(H, W, 3)
        tiles.append(img)
        scores[name] = psnr(img, gt)
        labels.append(f'{name}: {scores[name]:.2f} dB')
    print(' | '.join(labels))

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    write_png(args.out, to_uint8(np.concatenate(tiles, axis=1)))
    print(f'wrote {args.out}')
    return scores


if __name__ == '__main__':
    main()
