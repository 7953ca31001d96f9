"""Window-coverage statistics of the renderer's epipolar sample streams
(a CPU analysis).

  python -m cross_attention_renderer_torch.tools.stream_stats [--rays 8192]

Port of the JAX repository's ``tools/stream_stats.py``: the coordinate
math of ``CrossAttentionRenderer.forward`` and ``_sorted_exchange_v2`` on
``make_scene(0)`` (V=2, 256x256, 64 samples, the first ``--rays`` rays of
the full image, the first bench block), then, per pyramid level and
(sample block S, window Wn), the fraction of the bilinear corners outside
their block's window of Wn rows, and the percentiles of a block's row span,
for the self stream (sorted by its own rows) and the cross stream (riding
the self stream's order). Prints one line a level, stream and (S, Wn), in
the JAX tool's format. Runs on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cross_attention_renderer_torch import geometry as G

H = W = 256
R = 8192
P = 64
B, V = 1, 2
WINDOWS = ((2048, 512), (2048, 1024), (1024, 1024))


def stream_geometry(R: int = R, n_rays: int = 0) -> dict:
    """The renderer's V=2 geometry on ``make_scene(0)``'s first ``R`` rays
    (of a scene drawn with ``n_rays``, the full image by default): the self
    samples ``pixel_val`` (B*V, R, P, 2), the cross samples ``pix`` (B, V,
    R*P, 2; view v's points projected into view 1 - v), the segments'
    ``start``, ``end`` (B*V, R, 2) and ``valid``."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    scene = make_scene(0, batch=B, n_view=V, H=H, W=W,
                       n_rays=n_rays or H * W, full_image=True, device='cpu')
    ctx, qry = scene['context'], scene['query']
    ctx_c2w = ctx['cam2world'].float()
    q_c2w = torch.linalg.inv(ctx_c2w) @ qry['cam2world'].float()
    uv = qry['uv'][:, 0, :R][:, None].expand(B, V, R, 2).float()
    q_intr = qry['intrinsics'].float().expand(B, V, 4, 4)
    lf = G.plucker_embedding(q_c2w.reshape(B * V, 4, 4),
                             uv.reshape(B * V, R, 2),
                             q_intr.reshape(B * V, 4, 4))
    ctx_intr = ctx['intrinsics'].float().reshape(B * V, 4, 4)
    origins = G.ray_origin(q_c2w).reshape(B * V, 1, 3).expand(B * V, R, 3)
    intr_norm = torch.cat([ctx_intr[:, :2] / H, ctx_intr[:, 2:]], dim=1)
    start, end, valid = G.epipolar_segments_ndc(origins, lf[..., :3],
                                                intr_norm)
    interval = torch.linspace(0.0, 1.0, P, dtype=start.dtype)[:, None]
    pixel_val = start[..., None, :] + (end - start)[..., None, :] * interval
    eye = torch.eye(4).expand(B * V, 4, 4)
    pt, _, _ = G.epipolar_point_3d(lf, pixel_val, eye, H, W, ctx_intr)
    pt_views = pt.reshape(B, V, R, P, 3)
    rel = torch.linalg.inv(ctx_c2w)[:, :, None] @ ctx_c2w[:, None]
    pt_in = G.transform_points(pt_views[:, None], rel[:, :, :, None, None])
    pt_in = torch.where(torch.isfinite(pt_in), pt_in, torch.zeros_like(pt_in))
    pt_cross = torch.stack([pt_in[:, 1 - v, v] for v in range(V)], dim=1)
    proj = G.project_pinhole(pt_cross.reshape(B, V, R * P, 3),
                             ctx['intrinsics'].float().flip(1))
    pix = G.pixel_to_ndc(proj[..., :2], H, W)
    return {'pixel_val': pixel_val, 'pix': pix, 'start': start, 'end': end,
            'valid': valid}


def outside_frac(idx: np.ndarray, S: int, Wn: int) -> tuple:
    """(fraction of corners outside their S-sample block's window of Wn
    rows from the block's lowest row rounded down to 256, the 50th / 90th /
    99th percentiles of a block's row span)."""
    M = idx.shape[0]
    pad = (-M) % S
    idxp = np.pad(idx, ((0, pad), (0, 0)), mode='edge')
    blk = idxp.reshape(-1, S * 4)
    lo = (blk.min(1) // 256) * 256
    out = (idxp < lo.repeat(S)[:, None]) | (
        idxp >= (lo + Wn).repeat(S)[:, None])
    return out[:M].mean(), np.percentile(
        blk.max(1) - blk.min(1), [50, 90, 99])


def stats(R: int = R) -> list:
    """One dict a (level, stream, S, Wn), printed as the JAX tool prints
    them."""
    from cross_attention_renderer_torch.ops.sorted_gather import (
        _corners_flat, sort_stream)
    g = stream_geometry(R)
    stream = sort_stream(g['pixel_val'].reshape(B * V, R * P, 2), (H, W))
    M = B * V * R * P
    pix_s = g['pix'].reshape(M, 2).index_select(0, stream.perm.long())
    cross_id = stream.image_id ^ 1
    rows = []
    for (h, w_) in ((64, 64), (128, 128), (256, 256)):
        for name, coords, ids in (('self ', stream.coords, stream.image_id),
                                  ('cross', pix_s, cross_id)):
            idx, _ = _corners_flat(h, w_, coords, ids, 'border')
            idx_np = idx.numpy()
            for S, Wn in WINDOWS:
                frac, spans = outside_frac(idx_np, S, Wn)
                rows.append({'hw': (h, w_), 'stream': name.strip(), 'S': S,
                             'W': Wn, 'out': float(frac),
                             'spans': [float(x) for x in spans]})
                print(f'{h}x{w_} {name} S={S:5d} W={Wn:5d} '
                      f'out={frac:.5f} span p50/90/99='
                      f'{spans[0]:.0f}/{spans[1]:.0f}/{spans[2]:.0f}',
                      flush=True)
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--rays', type=int, default=R)
    opt = p.parse_args(argv)
    return stats(opt.rays)


if __name__ == '__main__':
    main()
