"""Trajectory-render throughput: full 256x256 frames/s with the pyramid
cached, on one NVIDIA card.

  python -m cross_attention_renderer_torch.tools.bench_traj \\
      [--fast] [--pruned C,F] [--narrow K1,K2,K3] [--q8] [--frames 4] \\
      [--device cuda]

Port of the JAX repository's ``tools/bench_traj.py`` and its protocol
(render_realestate10k_traj.py:84-185): the flagship V=2 model (bf16, seed-0
parameters) encodes ``make_scene(0)`` once; then every frame renders the
full image in 8,192-ray blocks (``make_scan_renderer``) from a new query
pose, the frame's pose moved 0.01 a frame along each axis, the poses made
before the timed loop. One warm-up frame, then ``--frames`` frames on the
host's clock between synchronisations. ``--fast`` (or ``--pruned``,
``--narrow``, ``--q8`` alone) renders through ``make_fast_renderer``
(``--fast``: pruned 8,16, narrow 128,128,64 and q8). Prints ms a frame,
frames/s and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import torch

from cross_attention_renderer_torch.tools import _card

FRAMES = 4


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--fast', action='store_true')
    p.add_argument('--pruned', default=None, metavar='C,F')
    p.add_argument('--narrow', default=None, metavar='K1,K2,K3')
    p.add_argument('--q8', action='store_true')
    p.add_argument('--frames', type=int, default=FRAMES)
    _card.add_device_flag(p)
    return p


def levers(opt) -> tuple:
    """(pruned, narrow, q8) from the flags, as the JAX tool reads them."""
    pruned = (tuple(int(x) for x in opt.pruned.split(','))
              if opt.pruned else ((8, 16) if opt.fast else None))
    narrow = (tuple(int(x) for x in opt.narrow.split(','))
              if opt.narrow else ((128, 128, 64) if opt.fast else None))
    return pruned, narrow, opt.q8 or opt.fast


def measure(opt, dev, hw: int = _card.H, n_chunks: int = 0,
            **model_kw) -> dict:
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer, make_scan_renderer)
    pruned, narrow, q8 = levers(opt)
    n_chunks = n_chunks or hw * hw // _card.RAY_BLOCK
    model = _card.flagship(2, dev, **model_kw)
    scene = _card.full_scene(2, dev, hw)
    if pruned or narrow or q8:
        render_image = make_fast_renderer(model, n_chunks, pruned=pruned,
                                          narrow=narrow, q8=q8)
        print(f'fast mode: pruned={pruned} narrow={narrow} q8={q8}',
              flush=True)
    else:
        render_image = make_scan_renderer(model, n_chunks)
    uv = scene['query']['uv']
    with torch.inference_mode():
        z = model.encode(scene)
    c2w0 = scene['query']['cam2world']
    poses = []
    for f in range(opt.frames):
        c2w = c2w0.clone()
        c2w[:, :, :3, 3] += 0.01 * f
        poses.append(c2w)

    def frame(c2w):
        s = dict(scene)
        s['query'] = dict(scene['query'], cam2world=c2w)
        return render_image(s, z, uv)[0]

    float(frame(c2w0).sum())
    _card.sync(dev)
    t0 = time.perf_counter()
    for c2w in poses:
        out = frame(c2w)
    float(out.sum())
    dt = (time.perf_counter() - t0) / opt.frames
    return {'ms_per_frame': dt * 1e3, 'frames_per_s': 1 / dt,
            'pruned': pruned, 'narrow': narrow, 'q8': q8}


def main(argv=None) -> dict:
    opt = parser().parse_args(argv)
    dev = _card.device('bench_traj', opt.device)
    _card.print_card(dev)
    r = measure(opt, dev)
    print(f'trajectory: {r["ms_per_frame"]:.0f} ms/frame  '
          f'{r["frames_per_s"]:.2f} frames/s ({_card.H}x{_card.W}, '
          f'{_card.RAY_BLOCK}-ray chunks, z cached)', flush=True)
    return r


if __name__ == '__main__':
    main()
