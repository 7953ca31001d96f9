"""Synthetic posed scenes for tests and the smoke run.

Port of ``make_scene``, ``look_at_cam2world`` and ``make_intrinsics`` of
``cross_attention_renderer_tpu/data/synthetic.py``: the same numpy draws
from the same seed, returned as torch tensors on the requested device, in
the scene-dict layout the renderer consumes.
"""

from __future__ import annotations

import numpy as np
import torch


def look_at_cam2world(eye: np.ndarray, at: np.ndarray,
                      up=(0.0, 1.0, 0.0)) -> np.ndarray:
    z = at - eye
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, eye
    return m


def make_intrinsics(H: int, W: int, focal_scale: float = 1.0) -> np.ndarray:
    k = np.eye(4)
    k[0, 0] = k[1, 1] = 0.98 * H * focal_scale
    k[0, 2], k[1, 2] = W / 2.0, H / 2.0
    return k


def make_scene(seed: int, batch: int = 1, n_view: int = 2, H: int = 64,
               W: int = 64, n_rays: int = 128, full_image: bool = False,
               dtype: torch.dtype = torch.float32,
               device='cuda') -> dict:
    """A random posed scene: context cameras on a radius-2 shell looking at
    the origin, the query camera between them (wide-baseline stereo)."""
    rng = np.random.default_rng(seed)
    ctx_c2w = np.zeros((batch, n_view, 4, 4))
    qry_c2w = np.zeros((batch, 1, 4, 4))
    for b in range(batch):
        base = rng.normal(0, 1, 3)
        base = 2.0 * base / np.linalg.norm(base)
        for v in range(n_view):
            eye = base + rng.normal(0, 0.35, 3)
            ctx_c2w[b, v] = look_at_cam2world(eye, rng.normal(0, 0.05, 3))
        qry_eye = base + rng.normal(0, 0.2, 3)
        qry_c2w[b, 0] = look_at_cam2world(qry_eye, rng.normal(0, 0.05, 3))

    intr = np.broadcast_to(make_intrinsics(H, W), (batch, n_view, 4, 4))
    q_intr = np.broadcast_to(make_intrinsics(H, W), (batch, 1, 4, 4))
    rgb = rng.uniform(-1, 1, (batch, n_view, H, W, 3))
    if full_image:
        i, j = np.meshgrid(np.arange(W), np.arange(H), indexing='xy')
        uv = np.stack([i, j], -1).reshape(1, 1, -1, 2).astype(np.float64)
        uv = np.broadcast_to(uv, (batch, 1, H * W, 2))
        gt = rng.uniform(-1, 1, (batch, 1, H * W, 3))
    else:
        uv = rng.uniform(0, min(H, W) - 1, (batch, 1, n_rays, 2))
        gt = rng.uniform(-1, 1, (batch, 1, n_rays, 3))

    def f(x):
        return torch.tensor(np.ascontiguousarray(x), dtype=dtype,
                            device=device)

    return {
        'context': {'rgb': f(rgb), 'cam2world': f(ctx_c2w),
                    'intrinsics': f(intr)},
        'query': {'cam2world': f(qry_c2w), 'intrinsics': f(q_intr),
                  'uv': f(uv), 'rgb': f(gt),
                  'mask': torch.zeros((batch,), dtype=dtype, device=device)},
    }
