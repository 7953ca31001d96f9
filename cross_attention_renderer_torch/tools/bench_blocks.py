"""Ray-block-size sweep of the flagship image render on one NVIDIA card.

  python -m cross_attention_renderer_torch.tools.bench_blocks \\
      [--chunks 4,8,16,32] [--iters 4] [--device cuda]

Port of the JAX repository's ``tools/bench_blocks.py`` on its
``bench.py``'s protocol: the flagship V=2 model (bf16, seed-0
parameters), ``make_scene(0)`` at 256x256 with its pyramid encoded once;
for each chunk count the 65,536-ray image rendered by
``make_scan_renderer`` in that many blocks, one warm-up image then
``--iters`` images on the host's clock. The block size moves the working
set of the exchange and the per-block fixed costs (the address math).
Prints ms an image and rays/s a chunk count, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse

from cross_attention_renderer_torch.tools import _card
from cross_attention_renderer_torch.tools.bench_v3 import image_times


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--chunks', default='4,8,16,32')
    p.add_argument('--iters', type=int, default=4)
    _card.add_device_flag(p)
    return p


def main(argv=None) -> list:
    opt = parser().parse_args(argv)
    dev = _card.device('bench_blocks', opt.device)
    _card.print_card(dev)
    model = _card.flagship(2, dev)
    scene = _card.full_scene(2, dev)
    rows = []
    for n_chunks in (int(x) for x in opt.chunks.split(',')):
        _, ms = image_times(model, scene, n_chunks, opt.iters, dev)
        rays = _card.H * _card.W
        rows.append({'n_chunks': n_chunks, 'ms_per_image': ms})
        print(f'n_chunks={n_chunks:3d} block={rays // n_chunks:6d} rays  '
              f'{ms:7.1f} ms/image  {rays / ms:7.1f}k rays/s', flush=True)
    return rows


if __name__ == '__main__':
    main()
