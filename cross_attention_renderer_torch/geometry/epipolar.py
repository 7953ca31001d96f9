"""Epipolar line-segment projection.

Port of ``cross_attention_renderer_tpu/geometry/epipolar.py``: projects rays
into a camera and clips the segment [t=0, t=inf) against the image frame,
returning normalized (0..1) endpoints and an ``overlaps_image`` flag. The
reference's four-case mask assignment (epipolar.py:241-251) is two
``torch.where`` selects:

  * endpoint at t=0: the origin's projection if it lands inside the frame,
    else the first frame-border intersection (min t);
  * endpoint at t=inf: the vanishing point if inside the frame, else the
    last frame-border intersection (max t);
  * overlaps_image = both chosen endpoints are valid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class PointProjection(NamedTuple):
    t: Tensor        # ray parameter (xyz = o + t d)
    xy: Tensor       # image-plane xy, normalized to [0, 1]
    valid: Tensor    # in front of the camera and inside the unit square


class RaySegmentProjection(NamedTuple):
    t_min: Tensor
    t_max: Tensor
    xy_min: Tensor
    xy_max: Tensor
    overlaps_image: Tensor   # when False the other fields are meaningless


def _in_bounds(xy: Tensor, eps: float = 1e-6) -> Tensor:
    return ((xy >= -eps) & (xy <= 1.0 + eps)).all(dim=-1)


def _in_front(xyz: Tensor, eps: float = 1e-6) -> Tensor:
    return xyz[..., -1] > -eps


def _apply(mat: Tensor, vecs: Tensor) -> Tensor:
    """(..., 3, 3) applied to (..., N, 3) row vectors."""
    return vecs @ mat.transpose(-1, -2)


def _project_normalized(xyz: Tensor, intrinsics: Tensor,
                        eps: float = 1e-8) -> Tensor:
    pts = xyz / (xyz[..., -1:] + eps)
    return _apply(intrinsics, pts)[..., :2]


def _intersect_image_coordinate(intrinsics: Tensor, origins: Tensor,
                                directions: Tensor, dim: int,
                                coordinate_value: float) -> PointProjection:
    """Intersect the ray's image-plane projection with one border line:
    ``dim`` 0 is the vertical border x = value, 1 the horizontal y = value.
    """
    other = 1 - dim
    fs = intrinsics[..., None, dim, dim]
    fo = intrinsics[..., None, other, other]
    cs = intrinsics[..., None, dim, 2]
    co = intrinsics[..., None, other, 2]
    os_, oo = origins[..., dim], origins[..., other]
    ds, do = directions[..., dim], directions[..., other]
    oz, dz = origins[..., 2], directions[..., 2]

    c = (coordinate_value - cs) / fs
    # Infinities from zero denominators fail the bounds check below.
    t = (c * oz - os_) / (ds - c * dz)
    coord_other = co + fo * (oo * (c * dz - ds) + do * (os_ - c * oz)) / (
        dz * os_ - ds * oz)
    coord_same = torch.full_like(coord_other, coordinate_value)
    xy = torch.stack([coord_same, coord_other] if dim == 0
                     else [coord_other, coord_same], dim=-1)
    xyz = origins + t[..., None] * directions
    return PointProjection(t=t, xy=xy, valid=_in_bounds(xy) & _in_front(xyz))


def _reduce_projections(projs: list[PointProjection],
                        reduction: str) -> PointProjection:
    """Per ray, the valid intersection of least (or greatest) t."""
    t = torch.stack([p.t for p in projs])
    xy = torch.stack([p.xy for p in projs])
    valid = torch.stack([p.valid for p in projs])
    lowest = float('inf') if reduction == 'min' else float('-inf')
    t_masked = torch.where(valid, t, torch.full_like(t, lowest))
    sel = (t_masked.argmin(dim=0) if reduction == 'min'
           else t_masked.argmax(dim=0))[None]
    xy_sel = torch.gather(xy, 0, sel[..., None].expand(1, *xy.shape[1:]))
    return PointProjection(t=torch.gather(t_masked, 0, sel)[0], xy=xy_sel[0],
                           valid=torch.gather(valid, 0, sel)[0])


def project_rays(origins: Tensor, directions: Tensor, extrinsics: Tensor,
                 intrinsics: Tensor, epsilon: float = 1e-6
                 ) -> RaySegmentProjection:
    """Project rays into a camera as clipped epipolar segments.

    Args: origins, directions (C, R, 3) in world space; extrinsics (C, 4, 4)
    cam2world of the target camera; intrinsics (C, 3+, 3+) normalized for a
    0..1 image plane."""
    intrinsics = intrinsics[..., :3, :3]
    world_to_cam = torch.linalg.inv(extrinsics)
    rot = world_to_cam[..., :3, :3]
    origins_cam = _apply(rot, origins) + world_to_cam[..., None, :3, 3]
    dirs_cam = _apply(rot, directions)

    border = [
        _intersect_image_coordinate(intrinsics, origins_cam, dirs_cam, 0, 0.0),
        _intersect_image_coordinate(intrinsics, origins_cam, dirs_cam, 0, 1.0),
        _intersect_image_coordinate(intrinsics, origins_cam, dirs_cam, 1, 0.0),
        _intersect_image_coordinate(intrinsics, origins_cam, dirs_cam, 1, 1.0),
    ]
    frame_min = _reduce_projections(border, 'min')
    frame_max = _reduce_projections(border, 'max')

    # Projection at t=0. An origin exactly at the camera projects via its
    # direction; one merely on the zero-depth plane is invalid.
    mask_depth_zero = origins_cam[..., -1] < epsilon
    mask_at_camera = torch.linalg.vector_norm(origins_cam, dim=-1) < epsilon
    origins_for_proj = torch.where(mask_at_camera[..., None], dirs_cam,
                                   origins_cam)
    xy_zero = _project_normalized(origins_for_proj, intrinsics)
    valid_zero = (_in_bounds(xy_zero) & _in_front(origins_for_proj)
                  & ~(mask_depth_zero & ~mask_at_camera))

    # Projection at t=inf: the vanishing point of the direction.
    xy_inf = _project_normalized(dirs_cam, intrinsics)
    valid_inf = _in_bounds(xy_inf) & _in_front(dirs_cam)

    t_min = torch.where(valid_zero, torch.zeros_like(frame_min.t),
                        frame_min.t)
    xy_min = torch.where(valid_zero[..., None], xy_zero, frame_min.xy)
    valid_min = valid_zero | frame_min.valid
    t_max = torch.where(valid_inf, torch.full_like(frame_max.t,
                                                   float('inf')),
                        frame_max.t)
    xy_max = torch.where(valid_inf[..., None], xy_inf, frame_max.xy)
    valid_max = valid_inf | frame_max.valid
    return RaySegmentProjection(t_min=t_min, t_max=t_max, xy_min=xy_min,
                                xy_max=xy_max,
                                overlaps_image=valid_min & valid_max)


def epipolar_segments_ndc(origins: Tensor, directions: Tensor,
                          intrinsics_norm: Tensor
                          ) -> tuple[Tensor, Tensor, Tensor]:
    """Identity extrinsics, ndc output: (start, end, valid), NaN/Inf
    scrubbed to 0 (models.py:238-258)."""
    eye = torch.eye(4, dtype=origins.dtype, device=origins.device).expand(
        *origins.shape[:-2], 4, 4)
    seg = project_rays(origins, directions, eye, intrinsics_norm)
    start = (seg.xy_min - 0.5) * 2.0
    end = (seg.xy_max - 0.5) * 2.0
    start = torch.where(torch.isfinite(start), start, torch.zeros_like(start))
    end = torch.where(torch.isfinite(end), end, torch.zeros_like(end))
    return start, end, seg.overlaps_image.to(origins.dtype)
