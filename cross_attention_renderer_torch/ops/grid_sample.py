"""Packed-cell bilinear sampling: the address and weight math of the
epipolar gather.

PyTorch port of ``cross_attention_renderer_tpu/ops/grid_sample.py``
(``pack_cells``, ``pack_pyramid``, ``cell_rows_and_slot_weights``,
``grid_sample_packed``, ``grid_sample`` and the pyramid wrappers) with the
semantics of ``F.grid_sample(..., mode='bilinear', align_corners=False)``
and ``border`` or ``zeros`` padding. Layout is channel-last: (B, H, W, C)
features, (B, N, 2) ndc coordinates in (x, y) order.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

Tensor = torch.Tensor

# Float cell origins are clamped here before the int32 conversion: far
# sentinel projections (1e10) would overflow it, and both sides of the clamp
# give the same clipped cell and the same zero weights.
_COORD_LIMIT = float(2 ** 24)


def pack_cells(features: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, H, W, 4C) cell table.

    ``packed[y, x] = [T[y,x] | T[y,x+1] | T[y+1,x] | T[y+1,x+1]]`` with
    edge-clamped shifts: each sample fetches its whole 2x2 cell as one row.
    """
    shift_x = torch.cat([features[:, :, 1:], features[:, :, -1:]], dim=2)
    shift_y = torch.cat([features[:, 1:], features[:, -1:]], dim=1)
    shift_xy = torch.cat([shift_x[:, 1:], shift_x[:, -1:]], dim=1)
    return torch.cat([features, shift_x, shift_y, shift_xy], dim=-1)


def pack_pyramid(pyramid: Sequence[Tensor]) -> tuple[Tensor, ...]:
    """:func:`pack_cells` for every level of a feature pyramid."""
    return tuple(pack_cells(fm) for fm in pyramid)


def cell_rows_and_slot_weights(hw: tuple[int, int], coords_ndc: Tensor,
                               padding_mode: str = 'border',
                               image_id: Optional[Tensor] = None,
                               weight_dtype: Optional[torch.dtype] = None
                               ) -> tuple[Tensor, Tensor]:
    """Cell row index + per-slot bilinear weights for a packed-cell table.

    The cell origin is clamped to [0, H-2] x [0, W-2]; each true corner's
    weight lands in the slot its clamped position occupies within that cell
    (at the image edge both x-corners clamp to the same column and their
    weights add, which is torch's border behaviour). For 'zeros' the
    out-of-bounds corners lose their weight first, and samples whose whole
    cell is out of bounds point at row 0 with all-zero weights.

    Args:
      hw: (H, W) of the unpacked feature map.
      coords_ndc: (B, N, 2) in [-1, 1], (x, y), align_corners=False.
      padding_mode: 'border' or 'zeros'.
      image_id: optional (B, N) int32 table image of each sample (default:
        its own batch row), e.g. image 1 - v for the V=2 cross stream.
      weight_dtype: type of the weights (default f32).

    Returns:
      (cell (B, N) int32 rows of the (B*H*W, 4C)-flattened packed table,
      w_slot (B, N, 4) weights).
    """
    H, W = hw
    B, N = coords_ndc.shape[:2]
    x = (coords_ndc[..., 0] + 1.0) * W * 0.5 - 0.5
    y = (coords_ndc[..., 1] + 1.0) * H * 0.5 - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wdt = weight_dtype or torch.float32
    wx = (x - x0).to(wdt)
    wy = (y - y0).to(wdt)
    x0i = x0.clamp(-_COORD_LIMIT, _COORD_LIMIT).to(torch.int32)
    y0i = y0.clamp(-_COORD_LIMIT, _COORD_LIMIT).to(torch.int32)

    x0c = x0i.clamp(0, W - 2)
    y0c = y0i.clamp(0, H - 2)
    if image_id is None:
        image_id = torch.arange(B, dtype=torch.int32,
                                device=coords_ndc.device)[:, None]
    cell = (image_id * (H * W) + y0c * W + x0c).to(torch.int32)

    w_slot = [0.0, 0.0, 0.0, 0.0]
    for dy, wy_c in ((0, 1 - wy), (1, wy)):
        for dx, wx_c in ((0, 1 - wx), (1, wx)):
            w_c = wx_c * wy_c
            if padding_mode == 'zeros':
                inb = ((x0i + dx >= 0) & (x0i + dx <= W - 1)
                       & (y0i + dy >= 0) & (y0i + dy <= H - 1))
                w_c = w_c * inb.to(w_c.dtype)
            sx = (x0i + dx).clamp(0, W - 1) - x0c           # {0, 1}
            sy = (y0i + dy).clamp(0, H - 1) - y0c
            for k in range(4):
                hit = ((sy * 2 + sx) == k).to(w_c.dtype)
                w_slot[k] = w_slot[k] + w_c * hit
    w_slot = torch.stack(w_slot, dim=-1)                    # (B, N, 4)
    if padding_mode == 'zeros':
        dead = w_slot.sum(dim=-1) <= 0.0
        cell = torch.where(dead, torch.zeros_like(cell), cell)
    return cell, w_slot


def grid_sample_packed(packed: Tensor, coords_ndc: Tensor,
                       padding_mode: str = 'border') -> Tensor:
    """Bilinear sample from a :func:`pack_cells` table: one row take per
    sample, then the four slots combined in the table's type
    (grid_sample.py:128-160). (B, H, W, 4C) at (B, N, 2) -> (B, N, C)."""
    B, H, W, C4 = packed.shape
    C = C4 // 4
    N = coords_ndc.shape[1]
    cell, w_slot = cell_rows_and_slot_weights(
        (H, W), coords_ndc, padding_mode, weight_dtype=packed.dtype)
    vals = packed.reshape(B * H * W, C4).index_select(
        0, cell.reshape(-1).long())                     # (B*N, 4C)
    w = w_slot.reshape(B * N, 4)
    out = None
    for k in range(4):
        term = vals[:, k * C:(k + 1) * C] * w[:, k:k + 1]
        out = term if out is None else out + term
    return out.reshape(B, N, C)


def grid_sample(features: Tensor, coords_ndc: Tensor,
                padding_mode: str = 'border') -> Tensor:
    """Sample (B, H, W, C) ``features`` bilinearly at (B, N, 2) ndc
    ``coords_ndc`` -> (B, N, C) (torch ``grid_sample`` semantics,
    align_corners=False)."""
    return grid_sample_packed(pack_cells(features), coords_ndc, padding_mode)


def grid_sample_pyramid(pyramid: Sequence[Tensor], coords_ndc: Tensor,
                        padding_mode: str = 'border') -> Tensor:
    """Every level of a feature pyramid sampled at the same coords, the
    channels concatenated (reference models.py:278)."""
    return torch.cat([grid_sample(fm, coords_ndc, padding_mode)
                      for fm in pyramid], dim=-1)


def grid_sample_pyramid_packed(packed_pyramid: Sequence[Tensor],
                               coords_ndc: Tensor,
                               padding_mode: str = 'border') -> Tensor:
    """:func:`grid_sample_pyramid` over tables packed once per image."""
    return torch.cat([grid_sample_packed(p, coords_ndc, padding_mode)
                      for p in packed_pyramid], dim=-1)
