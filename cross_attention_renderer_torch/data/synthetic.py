"""Synthetic posed scenes for tests, the smoke run and the corpus writers.

Port of ``cross_attention_renderer_tpu/data/synthetic.py``: random scenes
(:func:`make_scene`) and the analytic worlds, multi-view consistent
renders of a textured plane (:func:`make_plane_scene`) or of textured
rectangles floating over it (:func:`make_boxes_scene`). The same numpy
draws and arithmetic from the same seed, returned as torch tensors on the
requested device, in the scene-dict layout the renderer consumes.
``_render_boxes`` and ``_world_rects`` also draw the frames of the corpus
writers (``tools/make_corpus.py``, ``tools/make_co3d_corpus.py``).
:func:`noise_world_pair` renders the known-pose image pair that the pose
path is checked on (the world of the JAX package's classical-matcher
test).
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


def _tensor(x, dtype, device):
    return torch.tensor(np.ascontiguousarray(x), dtype=dtype, device=device)


def _plane_color(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Deterministic multi-octave texture on the z=0 plane, range [-1, 1]:
    a smooth base octave and two fine ones (periods ~40 px and ~12 px at the
    256x256 operating distance), so that frames carry real high-frequency
    content."""
    r = np.sin(2.1 * x) * np.cos(1.3 * y)
    g = np.sin(1.7 * x + 0.5) * np.sin(2.9 * y)
    b = np.cos(1.1 * x * y + 1.0)
    fine = (0.6 * np.sin(16.3 * x + 0.7) * np.cos(14.9 * y)
            + 0.4 * np.sin(61.0 * x + 2.0 * y + 0.3)
            * np.cos(57.0 * y - 3.0 * x))
    fine2 = (0.6 * np.cos(15.1 * y - 1.1) * np.sin(17.7 * x)
             + 0.4 * np.cos(63.0 * y + 1.7 * x) * np.sin(55.0 * x + 0.9))
    base = np.stack([r, g, b], -1)
    detail = np.stack([fine, fine2, 0.5 * (fine - fine2)], -1)
    return 0.7 * base + 0.3 * detail


def _render_plane(c2w: np.ndarray, K: np.ndarray, H: int, W: int
                  ) -> np.ndarray:
    """The textured z=0 plane rendered analytically from a camera."""
    i, j = np.meshgrid(np.arange(W), np.arange(H), indexing='xy')
    x = (i - K[0, 2]) / K[0, 0]
    y = (j - K[1, 2]) / K[1, 1]
    dirs_cam = np.stack([x, y, np.ones_like(x)], -1)
    dirs = dirs_cam @ c2w[:3, :3].T
    origin = c2w[:3, 3]
    t = -origin[2] / np.where(np.abs(dirs[..., 2]) < 1e-6, 1e-6,
                              dirs[..., 2])
    pts = origin[None, None] + t[..., None] * dirs
    rgb = _plane_color(pts[..., 0], pts[..., 1])
    return np.where((t > 0)[..., None], rgb, -1.0)


def _analytic_scene(render, seed: int, n_view: int, H: int, W: int,
                    n_rays: int, dtype, device) -> dict:
    """The scene dict of an analytic world; ``render(c2w) -> (H, W, 3)``
    is a function of the world alone."""
    rng = np.random.default_rng(seed)
    K = make_intrinsics(H, W)

    def cam(eye_seed):
        r = np.random.default_rng(eye_seed)
        eye = np.array([r.uniform(-0.6, 0.6), r.uniform(-0.6, 0.6),
                        -2.0 + r.uniform(-0.3, 0.3)])
        return look_at_cam2world(eye, np.array([0.0, 0.0, 0.0]),
                                 up=(0.0, 1.0, 0.0))

    ctx_c2w = np.stack([cam(1000 * seed + v) for v in range(n_view)])
    qry_c2w = cam(1000 * seed + 777)[None]
    ctx_rgb = np.stack([render(c) for c in ctx_c2w])
    qry_img = render(qry_c2w[0])

    i, j = np.meshgrid(np.arange(W), np.arange(H), indexing='xy')
    uv_full = np.stack([i, j], -1).reshape(-1, 2).astype(np.float64)
    rgb_full = qry_img.reshape(-1, 3)
    if n_rays:
        sel = rng.permutation(H * W)[:n_rays]
        uv, gt = uv_full[sel], rgb_full[sel]
    else:
        uv, gt = uv_full, rgb_full

    def f(x):
        return _tensor(x, dtype, device)

    return {
        'context': {'rgb': f(ctx_rgb[None]),
                    'cam2world': f(ctx_c2w[None]),
                    'intrinsics': f(np.broadcast_to(K, (1, n_view, 4, 4)))},
        'query': {'cam2world': f(qry_c2w[None]),
                  'intrinsics': f(K[None, None]),
                  'uv': f(uv[None, None]), 'rgb': f(gt[None, None]),
                  'mask': torch.zeros((1,), dtype=dtype, device=device)},
    }


def make_plane_scene(seed: int, n_view: int = 2, H: int = 64, W: int = 64,
                     n_rays: int = 0, dtype: torch.dtype = torch.float32,
                     device='cuda') -> dict:
    """A multi-view consistent scene: every view is an analytic render of
    one textured plane, so a correct renderer can learn to synthesise
    held-out views (unlike :func:`make_scene`'s noise)."""
    K = make_intrinsics(H, W)
    return _analytic_scene(lambda c: _render_plane(c, K, H, W), seed,
                           n_view, H, W, n_rays, dtype, device)


def _world_rects(seed: int, n_rects: int) -> list:
    """The floating rectangles of one boxes world: (z, x0, x1, y0, y1,
    texture shift), z in (-1.1, -0.25), between the cameras (z ~ -2) and
    the base plane (z = 0)."""
    r = np.random.default_rng(31 * seed + 7)
    rects = []
    for _ in range(n_rects):
        z = float(r.uniform(-1.1, -0.25))
        cx, cy = r.uniform(-0.9, 0.9, 2)
        hw, hh = r.uniform(0.15, 0.55, 2)
        shift = float(r.uniform(0.0, 20.0))
        rects.append((z, cx - hw, cx + hw, cy - hh, cy + hh, shift))
    return rects


def _render_boxes(c2w: np.ndarray, K: np.ndarray, H: int, W: int,
                  rects: list) -> np.ndarray:
    """The textured base plane with textured rectangles floating over it
    at several depths (occlusion, depth discontinuities), rendered
    analytically from a camera; the nearest hit wins."""
    i, j = np.meshgrid(np.arange(W), np.arange(H), indexing='xy')
    x = (i - K[0, 2]) / K[0, 0]
    y = (j - K[1, 2]) / K[1, 1]
    dirs = np.stack([x, y, np.ones_like(x)], -1) @ c2w[:3, :3].T
    origin = c2w[:3, 3]
    dz = np.where(np.abs(dirs[..., 2]) < 1e-6, 1e-6, dirs[..., 2])

    t_base = -origin[2] / dz
    base_hit = t_base > 0
    pts = origin[None, None] + t_base[..., None] * dirs
    rgb = np.where(base_hit[..., None],
                   _plane_color(pts[..., 0], pts[..., 1]), -1.0)
    best_t = np.where(base_hit, t_base, np.inf)

    for (z, x0, x1, y0, y1, shift) in rects:
        t_k = (z - origin[2]) / dz
        p = origin[None, None] + t_k[..., None] * dirs
        hit = ((t_k > 1e-6) & (t_k < best_t)
               & (p[..., 0] >= x0) & (p[..., 0] <= x1)
               & (p[..., 1] >= y0) & (p[..., 1] <= y1))
        rgb = np.where(hit[..., None],
                       _plane_color(p[..., 0] + shift, p[..., 1] - shift),
                       rgb)
        best_t = np.where(hit, t_k, best_t)
    return rgb


def make_boxes_scene(seed: int, n_view: int = 2, H: int = 64, W: int = 64,
                     n_rays: int = 0, n_rects: int = 4,
                     dtype: torch.dtype = torch.float32,
                     device='cuda') -> dict:
    """A multi-view consistent world with occlusion: ``n_rects`` floating
    textured rectangles over the textured base plane."""
    K = make_intrinsics(H, W)
    rects = _world_rects(seed, n_rects)
    return _analytic_scene(lambda c: _render_boxes(c, K, H, W, rects), seed,
                           n_view, H, W, n_rays, dtype, device)


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
        return _tensor(x, dtype, device)

    return {
        'context': {'rgb': f(rgb), 'cam2world': f(ctx_c2w),
                    'intrinsics': f(intr)},
        'query': {'cam2world': f(qry_c2w), 'intrinsics': f(q_intr),
                  'uv': f(uv), 'rgb': f(gt),
                  'mask': torch.zeros((batch,), dtype=dtype, device=device)},
    }


def _value_noise(u, v, tex, cells_per_unit):
    n = tex.shape[0]
    fu = (u * cells_per_unit) % n
    fv = (v * cells_per_unit) % n
    i0 = np.floor(fu).astype(int) % n
    j0 = np.floor(fv).astype(int) % n
    i1, j1 = (i0 + 1) % n, (j0 + 1) % n
    a, b = fu - np.floor(fu), fv - np.floor(fv)
    return (tex[j0, i0] * (1 - a) * (1 - b) + tex[j0, i1] * a * (1 - b)
            + tex[j1, i0] * (1 - a) * b + tex[j1, i1] * a * b)


def _render_noise_world(c2w: np.ndarray, K: np.ndarray, H: int, W: int,
                        tex: np.ndarray) -> np.ndarray:
    """Grayscale (H, W) render of a non-planar world (base plane z=0 and
    three floating squares) with a two-octave value-noise texture; an
    essential matrix from coplanar points would be degenerate."""
    rects = [(0.0, 0.0, 0.9, 0.45), (-0.6, 0.5, 0.6, 0.3),
             (0.55, -0.45, 0.75, 0.35)]
    i, j = np.meshgrid(np.arange(W), np.arange(H), indexing='xy')
    x = (i - K[0, 2]) / K[0, 0]
    y = (j - K[1, 2]) / K[1, 1]
    dirs = np.stack([x, y, np.ones_like(x)], -1) @ c2w[:3, :3].T
    o = c2w[:3, 3]

    def shade(p, shift):
        return (0.6 * _value_noise(p[..., 0] + shift, p[..., 1], tex, 16)
                + 0.4 * _value_noise(p[..., 0] - 3.3 * shift,
                                     p[..., 1] + 9.9 * shift, tex, 64))

    tb = -o[2] / dirs[..., 2]
    g = shade(o[None, None] + tb[..., None] * dirs, 0.0)
    tbest = np.where(tb > 0, tb, np.inf)
    for idx, (cx, cy, zr, s) in enumerate(rects):
        tr = (zr - o[2]) / dirs[..., 2]
        p = o[None, None] + tr[..., None] * dirs
        hit = ((tr > 0) & (np.abs(p[..., 0] - cx) < s)
               & (np.abs(p[..., 1] - cy) < s) & (tr < tbest))
        g = np.where(hit, shade(p, 7.3 * (idx + 1)), g)
        tbest = np.where(hit, tr, tbest)
    return g.astype(np.float32)


def noise_world_pair(K: np.ndarray, H: int = 256, W: int = 256,
                     seed: int = 3) -> tuple:
    """A known-pose grayscale pair of the value-noise world, for the pose
    path's checks (the JAX package's classical-matcher test world):
    (gray0, gray1, cam2world0, cam2world1), rendered with the pixel-unit
    intrinsics ``K`` (3, 3) the pose solve will assume."""
    c2w0 = look_at_cam2world(np.array([0.1, -0.1, 2.0]), np.zeros(3))
    c2w1 = look_at_cam2world(np.array([0.45, 0.05, 1.9]), np.zeros(3))
    tex = np.random.default_rng(seed).uniform(0, 1, (512, 512))
    return (_render_noise_world(c2w0, K, H, W, tex),
            _render_noise_world(c2w1, K, H, W, tex), c2w0, c2w1)
