"""Inputs of the exchange streams' address math (``ops/stream_takes.py``),
shared by its CPU tests and its card test. Imports neither JAX nor the JAX
package.

A case is the geometry of one ray block: B scenes of V context views, R
rays of P samples each, and a pyramid of 3 or 4 levels on an H x W image
(H != W, so that a swapped axis shows). The cameras of scene 0's first two
views are pure translations by binary fractions, so their relative
transforms, and the points below, are exact; every other camera is also
rotated. With ``plant`` the first samples of every view carry the inputs at
the edges of the math:
  * points that are NaN, +-inf or near the f32 limit (scrubbed to 0, or
    projected to non-finite pixels, which the 1e10 sentinel replaces);
  * points behind the camera (negative depth);
  * in scene 0, points whose depth in the other translated view is exactly
    -1e-12, so that project_pinhole divides by zero (the 1e10 sentinel);
  * self-stream ndc coords exactly on the cell edges of every level, on the
    image borders (+-1), just outside them, and NaN or inf;
and many cross-stream samples fall outside the other view, so that 'zeros'
padding leaves them dead (row 0, zero weights).
"""

from __future__ import annotations

import numpy as np
import torch

LEVEL_HW = {3: lambda H, W: ((H // 4, W // 4), (H // 2, W // 2), (H, W)),
            4: lambda H, W: ((H // 2, W // 2), (H // 4, W // 4),
                             (H // 8, W // 8), (H // 16, W // 16))}


def _rotation(rng) -> np.ndarray:
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(0.05, 0.4)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _edge_coords(level_hw) -> list[float]:
    """ndc x (for width w) or y values that land exactly on a cell edge of
    some level, on the image border, and just outside it."""
    vals = [-1.0, 1.0, -1.0 - 2 ** -10, 1.0 + 2 ** -10, 0.0]
    for _, w in level_hw:
        for i in (-1, 0, 1, w // 2, w - 2, w - 1, w):
            # (c + 1) * w / 2 - 0.5 == i exactly
            vals.append(float(np.float32((2 * i + 1) / w - 1)))
    return vals


def stream_case(V: int, levels: int, B: int, R: int, P: int, seed: int = 0,
                H: int = 48, W: int = 64, plant: bool = True,
                device='cpu') -> dict:
    """{level_hw, pixel_val (B*V, R*P, 2), pt_views (B, V, R, P, 3),
    ctx_c2w, ctx_intr (B, V, 4, 4), H, W}: f32 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    level_hw = LEVEL_HW[levels](H, W)
    c2w = np.tile(np.eye(4, dtype=np.float64), (B, V, 1, 1))
    intr = np.tile(np.eye(4, dtype=np.float64), (B, V, 1, 1))
    for b in range(B):
        for v in range(V):
            if b == 0 and v < 2:
                c2w[b, v, :3, 3] = (0.25 * v, -0.125 * v, 0.0)
            else:
                c2w[b, v, :3, :3] = _rotation(rng)
                c2w[b, v, :3, 3] = rng.uniform(-0.5, 0.5, 3)
            intr[b, v, 0, 0] = W * rng.uniform(0.8, 1.2)
            intr[b, v, 1, 1] = H * rng.uniform(0.8, 1.2)
            intr[b, v, 0, 2] = W / 2 + rng.uniform(-2, 2)
            intr[b, v, 1, 2] = H / 2 + rng.uniform(-2, 2)
    z = rng.uniform(0.5, 5.0, (B, V, R, P))
    xy = rng.uniform(-0.8, 0.8, (B, V, R, P, 2)) * z[..., None]
    pt = np.concatenate([xy, z[..., None]], axis=-1).astype(np.float32)
    pix = rng.uniform(-1.1, 1.1, (B * V, R * P, 2)).astype(np.float32)
    if plant:
        f32 = np.float32
        planted = [(np.nan, 0.5, 1.0), (np.inf, 0.0, 1.0), (0.1, -np.inf, 2.0),
                   (0.0, 0.0, np.nan), (3e38, 1.0, 1.0), (1e30, -1e30, 1e-3),
                   (0.3, -0.2, -2.0), (-1.0, 0.5, -0.5), (0.0, 0.0, 0.0)]
        flat = pt.reshape(B, V, R * P, 3)
        n = min(len(planted), R * P)
        flat[:, :, :n] = np.array(planted[:n], dtype=np.float32)
        if R * P > n + 2:
            # scene 0's translated views share their depth axis: depth
            # -1e-12 in the other view is depth -1e-12 here
            flat[0, :2, n] = (0.25, 0.125, -f32(1e-12))
            flat[0, :2, n + 1] = (0.0, 0.0, -f32(1e-12))
        edges = _edge_coords(level_hw) + [np.nan, np.inf, -np.inf]
        rows = np.array(edges, dtype=np.float32)
        grid = np.stack(np.meshgrid(rows, rows[::-1]), -1).reshape(-1, 2)
        k = min(len(grid), R * P)
        start = R * P - k
        pix[:, start:] = grid[:k]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)
                                   ).to(device)
    return {'level_hw': level_hw, 'pixel_val': t(pix), 'pt_views': t(pt),
            'ctx_c2w': t(c2w), 'ctx_intr': t(intr), 'H': H, 'W': W}
