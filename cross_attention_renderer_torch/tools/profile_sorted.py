"""Per-component timings of the sorted-stream path on one NVIDIA card.

  python -m cross_attention_renderer_torch.tools.profile_sorted \\
      [--iters 20] [--m 1048576] [--device cuda]

Port of the JAX repository's ``tools/profile_sorted.py``: at the flagship
sample-stream size M = 2^20 (2 views x 8,192 rays x 64 samples) over 2
images, the mean device time (CUDA events, ``--iters`` calls after a
warm-up) of each component of the sorted stream (``ops/sorted_gather.py``):
the sort (``sort_stream``: the key, the stable argsort, the takes), the
unsort of a (M, 288) bf16 row and the take of a (M, 3) f32 payload; then,
at each flagship pyramid level, the corners (``_corners_flat``), kernel
K5 (``resident_gather``, the renderer's gather) and K6
(``windowed_gather``, the JAX tool's) against the plain counterpart of
``_take_gather`` (``take_gather``) on the same bf16 table. Prints one line a
component and the card's name and power limit.
"""

from __future__ import annotations

import argparse

import torch

from cross_attention_renderer_torch.tools import _card

M = 1 << 20
B = 2
LEVELS = ((64, 64, 256), (128, 128, 256), (256, 256, 64))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--iters', type=int, default=20)
    p.add_argument('--m', type=int, default=M,
                   help='samples in the stream (default 2^20)')
    _card.add_device_flag(p)
    return p


def measure(m: int, iters: int, dev, levels=LEVELS) -> dict:
    """{component: ms}; prints a line for each."""
    from cross_attention_renderer_torch.ops import sorted_gather as SG
    out = {}

    def bench(name, fn, n=iters):
        out[name] = ms = _card.mean_ms(fn, n, dev)
        print(f'{name:42s} {ms:8.3f} ms', flush=True)

    g = torch.Generator(device='cpu').manual_seed(0)
    coords = (torch.rand(B, m // B, 2, generator=g) * 2 - 1).to(dev)
    key_hw = (256, 256)
    bench('sort_stream (argsort + takes)',
          lambda: SG.sort_stream(coords, key_hw))
    stream = SG.sort_stream(coords, key_hw)
    wide = torch.randn(m, 288, generator=g).to(dev, torch.bfloat16)
    bench('unsort (M,288) bf16 take', lambda: SG.unsort(wide, stream))
    narrow = torch.randn(m, 3, generator=g).to(dev)
    bench('narrow (M,3) f32 take',
          lambda: narrow.index_select(0, stream.perm.long()))
    for (h, w, c) in levels:
        fm = torch.randn(B * h * w, c, generator=g).to(dev, torch.bfloat16)
        bench(f'corners         {h}x{w}',
              lambda: SG._corners_flat(h, w, stream.coords, stream.image_id,
                                       'border'))
        idx, wt = SG._corners_flat(h, w, stream.coords, stream.image_id,
                                   'border')
        n = max(1, iters // 3)
        bench(f'resident_gather {h}x{w}x{c} (K5)',
              lambda: SG.resident_gather(fm, idx, wt), n)
        bench(f'windowed_gather {h}x{w}x{c} (K6)',
              lambda: SG.windowed_gather(fm, idx, wt), n)
        bench(f'take_gather     {h}x{w}x{c} (plain)',
              lambda: SG.take_gather(fm, idx, wt), n)
    return out


def main(argv=None) -> dict:
    opt = parser().parse_args(argv)
    dev = _card.device('profile_sorted', opt.device)
    _card.print_card(dev)
    print(f'device: {dev}, M = {opt.m}', flush=True)
    return measure(opt.m, opt.iters, dev)


if __name__ == '__main__':
    main()
