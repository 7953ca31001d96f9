"""Error of approximating the cross-view gather by 1-D interpolation along
the other view's epipolar segment (a CPU analysis).

  python -m cross_attention_renderer_torch.tools.cross_interp_error \\
      [--rays 2048]

Port of the JAX repository's ``tools/cross_interp_error.py``. At V=2,
element (v, r, p) of the exchange gathers frame k = 1 - v's pyramid at the
projection of view v's sample into frame k, a point on frame k's epipolar
segment of the same ray. On ``make_scene(0)``'s first ``--rays`` rays
(256x256, 64 samples; ``stream_stats.stream_geometry``) it recovers that
point's segment parameter t', reports the fraction inside [0, 1] and the
distance off the segment's line, then, at three smoothed random feature
maps (numpy seed 0, 64 channels at 64, 128 and 256 squared), compares the
exact gather (``ops/grid_sample.py``, zeros padding) with linear
interpolation between 2P - 1 uniform samples of frame k's segment: the
covered fraction and the error's 50th and 99th percentiles and maximum.
Prints the JAX tool's lines. Runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cross_attention_renderer_torch.tools.stream_stats import (
    B, H, P, V, stream_geometry)

R = 2048


def analyse(R: int = R) -> dict:
    from cross_attention_renderer_torch.ops.grid_sample import grid_sample
    g = stream_geometry(R)
    start, end, valid = g['start'], g['end'], g['valid']
    pix = g['pix'].reshape(B, V, R, P, 2)
    st = start.reshape(B, V, R, 2)
    en = end.reshape(B, V, R, 2)
    st_k = st.flip(1)[..., None, :]                        # (B,V,R,1,2)
    en_k = en.flip(1)[..., None, :]
    d = en_k - st_k
    tp = ((pix - st_k) * d).sum(-1) / (d * d).sum(-1).clamp_min(1e-12)
    foot = st_k + tp[..., None] * d
    off = torch.linalg.vector_norm(pix - foot, dim=-1)
    inside = (tp >= 0.0) & (tp <= 1.0)
    vmask = valid.reshape(B, V, R).flip(1)[..., None]
    out = {'inside': float(inside.float().mean()),
           'inside_valid': float((inside & (vmask > 0)).sum()
                                 / (vmask > 0).sum() / P),
           'off_p50': float(np.percentile(off.numpy(), 50)),
           'off_p99': float(np.percentile(off.numpy(), 99)), 'levels': []}
    print(f"cross t' inside [0,1]: {out['inside']:.4f}  (valid-seg only: "
          f"{out['inside_valid']:.4f})")
    print(f"off-line distance (ndc): p50={out['off_p50']:.2e} "
          f"p99={out['off_p99']:.2e}")

    D = 2 * P - 1
    dense_t = torch.linspace(0.0, 1.0, D)
    dense_pix = (st[..., None, :] + (en - st)[..., None, :]
                 * dense_t[:, None]).reshape(B * V, R * D, 2)
    rng = np.random.default_rng(0)
    for (h, w_, C) in ((64, 64, 64), (128, 128, 64), (256, 256, 64)):
        fm = torch.from_numpy(rng.normal(0, 1, (B * V, h, w_, C))
                              .astype(np.float32))
        fm = (fm + fm.roll(1, 1) + fm.roll(1, 2) + fm.roll(-1, 1)
              + fm.roll(-1, 2)) / 5.0
        exact = grid_sample(fm, pix.reshape(B * V, R * P, 2), 'zeros')
        dense = grid_sample(fm, dense_pix, 'zeros').reshape(B, V, R, D, C)
        dense_k = dense.flip(1)
        tq = tp.clamp(0.0, 1.0) * (D - 1)
        i0 = tq.floor().clamp(0, D - 2).long()
        frac = (tq - i0)[..., None]
        g0 = dense_k.gather(3, i0[..., None].expand(*i0.shape, C))
        g1 = dense_k.gather(3, (i0 + 1)[..., None].expand(*i0.shape, C))
        interp = g0 * (1 - frac) + g1 * frac
        e = exact.reshape(B, V, R, P, C).numpy()
        i_ = interp.numpy()
        m = (inside & (off < 1e-3)).numpy()[..., None]
        scale = np.abs(e).mean()
        err = np.abs(i_ - e) * m
        sel = err[m.repeat(C, -1) > 0]
        row = {'hw': (h, w_), 'covered': float(m.mean()),
               'p50': float(np.percentile(sel, 50)),
               'p99': float(np.percentile(sel, 99)), 'max': float(err.max()),
               'scale': float(scale)}
        out['levels'].append(row)
        print(f"{h}x{w_}: covered={row['covered']:.3f} "
              f"err p50={row['p50']:.2e} p99={row['p99']:.2e} "
              f"max={row['max']:.2e} (feat scale {scale:.2f})", flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--rays', type=int, default=R)
    opt = p.parse_args(argv)
    return analyse(opt.rays)


if __name__ == '__main__':
    main()
