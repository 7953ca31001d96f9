"""Ray / pinhole-camera / Plücker geometry.

Port of ``cross_attention_renderer_tpu/geometry/rays.py``: batched over any
leading dims, branchless NaN scrubbing, and the scale-normalized f32 Plücker
intersection in place of the reference's f64 one (DEVIATIONS.md). All of it
runs in f32.

Conventions: OpenCV pinhole cameras, 4x4 ``cam2world``; intrinsics with
``fx = K[0,0], fy = K[1,1], cx = K[0,2], cy = K[1,2]``; ``uv`` in pixel
units; ndc in [-1, 1] with the align_corners=True mapping
``x_pix = (x_ndc + 1) / 2 * (W - 1)``; a Plücker line is ``(d, o x d)``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

# Written where the reference writes 1e10 after scrubbing NaN/Inf from
# pinhole projections (geometry.py:390-391).
_FAR_SENTINEL = 1e10


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(v: Tensor, keepdim: bool = False) -> Tensor:
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _normalize(v: Tensor, eps: float = 1e-12) -> Tensor:
    return v / _norm(v, keepdim=True).clamp_min(eps)


def _scrub(x: Tensor, value: float) -> Tensor:
    return torch.where(torch.isfinite(x), x, torch.full_like(x, value))


def ray_origin(cam2world: Tensor) -> Tensor:
    """Camera center in world coordinates."""
    return cam2world[..., :3, 3]


def parse_intrinsics(intrinsics: Tensor) -> tuple[Tensor, Tensor, Tensor,
                                                  Tensor]:
    """(fx, fy, cx, cy), each of shape ``intrinsics.shape[:-2]``."""
    return (intrinsics[..., 0, 0], intrinsics[..., 1, 1],
            intrinsics[..., 0, 2], intrinsics[..., 1, 2])


def ndc_to_pixel(xy_ndc: Tensor, H: int, W: int) -> Tensor:
    x = (xy_ndc[..., 0] + 1.0) * 0.5 * (W - 1)
    y = (xy_ndc[..., 1] + 1.0) * 0.5 * (H - 1)
    return torch.stack([x, y], dim=-1)


def pixel_to_ndc(xy_pix: Tensor, H: int, W: int) -> Tensor:
    x = xy_pix[..., 0] / (W - 1) * 2.0 - 1.0
    y = xy_pix[..., 1] / (H - 1) * 2.0 - 1.0
    return torch.stack([x, y], dim=-1)


def lift(x: Tensor, y: Tensor, z: Tensor, intrinsics: Tensor,
         homogeneous: bool = False) -> Tensor:
    """Unproject pixel coords at depth ``z`` into camera space; K has shape
    (..., 3+, 3+) and x/y/z (..., N)."""
    fx, fy, cx, cy = (v[..., None] for v in parse_intrinsics(intrinsics))
    x_lift = (x - cx) / fx * z
    y_lift = (y - cy) / fy * z
    parts = [x_lift, y_lift, z] + ([torch.ones_like(z)] if homogeneous
                                   else [])
    return torch.stack(parts, dim=-1)


def project_pinhole(xyz_cam: Tensor, intrinsics: Tensor) -> Tensor:
    """Camera-space points -> (x_pix, y_pix, z), with the reference's 1e-12
    denominator guard and NaN/Inf -> 1e10 scrub."""
    fx, fy, cx, cy = (v[..., None] for v in parse_intrinsics(intrinsics))
    x, y, z = xyz_cam[..., 0], xyz_cam[..., 1], xyz_cam[..., 2]
    x_proj = fx * x / (z + 1e-12) + cx
    y_proj = fy * y / (z + 1e-12) + cy
    return _scrub(torch.stack([x_proj, y_proj, z], dim=-1), _FAR_SENTINEL)


def transform_points(pts: Tensor, transform: Tensor) -> Tensor:
    """Apply 4x4 transforms to 3D points (broadcasting leading dims)."""
    t = transform[..., :3, :]
    return (pts[..., 0:1] * t[..., 0] + pts[..., 1:2] * t[..., 1]
            + pts[..., 2:3] * t[..., 2] + t[..., 3])


def points_to_cam(world_pts: Tensor, cam2world: Tensor) -> Tensor:
    """World points -> camera coordinates via inverse(cam2world)."""
    return transform_points(world_pts, torch.linalg.inv(cam2world))


def world_from_xy_depth(xy_pix: Tensor, depth: Tensor, cam2world: Tensor,
                        intrinsics: Tensor) -> Tensor:
    pts_cam = lift(xy_pix[..., 0], xy_pix[..., 1], depth, intrinsics)
    return transform_points(pts_cam, cam2world[..., None, :, :])


def ray_directions(uv_pix: Tensor, cam2world: Tensor,
                   intrinsics: Tensor) -> Tensor:
    """Normalized world-space ray directions through pixels ``uv_pix``."""
    z = torch.ones(uv_pix.shape[:-1], dtype=uv_pix.dtype,
                   device=uv_pix.device)
    pixel_points = world_from_xy_depth(uv_pix, z, cam2world, intrinsics)
    return _normalize(pixel_points - ray_origin(cam2world)[..., None, :])


def ray_directions_cam(uv_ndc: Tensor, intrinsics: Tensor, H: int,
                       W: int) -> Tensor:
    """Normalized camera-space ray directions through ndc coords."""
    xy = ndc_to_pixel(uv_ndc, H, W)
    z = torch.ones(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
    return _normalize(lift(xy[..., 0], xy[..., 1], z, intrinsics))


def plucker_embedding(cam2world: Tensor, uv_pix: Tensor,
                      intrinsics: Tensor) -> Tensor:
    """Plücker coordinates (d, o x d) of rays through pixels ``uv_pix``."""
    dirs = ray_directions(uv_pix, cam2world, intrinsics)
    origin = ray_origin(cam2world)[..., None, :].expand_as(dirs)
    return torch.cat([dirs, _cross(origin, dirs)], dim=-1)


def plucker_intersection(line_1: Tensor, line_2: Tensor,
                         eps: float = 1e-12) -> tuple[Tensor, Tensor]:
    """Mutually closest points of two Plücker lines, f32-stable form:
    ``p1 = (-m1 x (l2 x n_hat) + (m2 . n_hat) l1) / |n|``, n = l1 x l2."""
    l1, m1 = line_1[..., :3], line_1[..., 3:]
    l2, m2 = line_2[..., :3], line_2[..., 3:]
    n = _cross(l1, l2)
    n_norm = _norm(n, keepdim=True)
    n_hat = n / n_norm.clamp_min(eps)
    inv = 1.0 / n_norm.clamp_min(eps)
    p1 = (-_cross(m1, _cross(l2, n_hat))
          + (m2 * n_hat).sum(-1, keepdim=True) * l1) * inv
    p2 = (_cross(m2, _cross(l1, n_hat))
          - (m1 * n_hat).sum(-1, keepdim=True) * l2) * inv
    return p1, p2


def plucker_parallel(line_1: Tensor, line_2: Tensor,
                     tol: float = 1e-6) -> Tensor:
    return _norm(_cross(line_1[..., :3], line_2[..., :3])) < tol


def epipolar_point_3d(query_ray: Tensor, pixel_val_ndc: Tensor,
                      context_cam2world: Tensor, H: int, W: int,
                      intrinsics: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Point on the query ray closest to the context ray through each ndc
    epipolar sample, plus the inter-line distance and a parallel mask.

    Args: query_ray (B, R, 6); pixel_val_ndc (B, R, P, 2);
      context_cam2world (B, 4, 4); intrinsics (B, 3+, 3+) in pixel units.
    Returns: (point (B, R, P, 3), dist (B, R, P, 1), parallel (B, R, P)).
    """
    b, r = query_ray.shape[:2]
    p = pixel_val_ndc.shape[-2]
    pix = ndc_to_pixel(pixel_val_ndc, H, W).reshape(b, r * p, 2)
    ctx_plucker = plucker_embedding(context_cam2world, pix,
                                    intrinsics).reshape(b, r, p, 6)
    q = query_ray[..., None, :].expand_as(ctx_plucker)
    p1, p2 = plucker_intersection(q, ctx_plucker)
    parallel = plucker_parallel(q, ctx_plucker)
    dist = _norm(p2 - p1, keepdim=True)
    return _scrub(p1, 0.0), dist, parallel


def essential_matrix(c2w_1: Tensor, c2w_2: Tensor) -> Tensor:
    """Essential matrix between two cameras. Ref: geometry.py:22-36."""
    R = torch.einsum('...ij,...ik->...jk', c2w_2[..., :3, :3],
                     c2w_1[..., :3, :3])
    T = ray_origin(c2w_2) - ray_origin(c2w_1)
    x, y, z = T[..., 0], T[..., 1], T[..., 2]
    zero = torch.zeros_like(x)
    S = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    return R @ S


def fundamental_matrix(c2w_1: Tensor, c2w_2: Tensor, intr_1: Tensor,
                       intr_2: Tensor) -> Tensor:
    """Fundamental matrix from poses + intrinsics. Ref: geometry.py:39-45."""
    E = essential_matrix(c2w_1, c2w_2)
    k1 = torch.linalg.inv(intr_1[..., :3, :3])
    k2 = torch.linalg.inv(intr_2[..., :3, :3])
    return k1.transpose(-1, -2) @ E @ k2
