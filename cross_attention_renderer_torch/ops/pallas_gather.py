"""Bilinear gather over a whole feature table (kernel K7) and the gather
dispatch of the unfused V>=3 exchange.

PyTorch port of ``cross_attention_renderer_tpu/ops/pallas_gather.py``
(``_corner_indices``, ``_onehot_gather``, ``grid_sample_pallas`` forward,
``grid_sample_auto``). The TPU kernel contracts a one-hot selector over the
whole table on the MXU; the CUDA kernel (``csrc/bilinear_gather.cu``, shared
by K5-K8, see :mod:`~cross_attention_renderer_torch.ops.sorted_gather`)
reads the four corner rows of each sample.
"""

from __future__ import annotations

import torch

from cross_attention_renderer_torch.ops.grid_sample import (
    bilinear_corners, grid_sample)
from cross_attention_renderer_torch.ops.sorted_gather import (launch_gather,
                                                             plain_gather)

Tensor = torch.Tensor

GATHERS = ('take', 'onehot', 'banded')
BANDED_TABLE_BYTES = 4 * 1024 * 1024   # K8 only for tables this small


def _corner_indices(features_shape, coords_ndc: Tensor, padding_mode: str
                    ) -> tuple[Tensor, Tensor]:
    """(B, N, 2) ndc -> (B, N, 4) int32 corner rows of each image's
    (H * W, C) table and their (B, N, 4) weights (the semantics of
    ``ops.grid_sample``; :func:`~cross_attention_renderer_torch.ops.
    grid_sample.bilinear_corners`). Its clamp of far coordinates can give
    rows other than JAX's only where the weight is 0."""
    return bilinear_corners(features_shape[1:3], coords_ndc, padding_mode)


def flat_corners(features: Tensor, coords_ndc: Tensor, padding_mode: str
                 ) -> tuple[Tensor, Tensor]:
    """:func:`_corner_indices` with the batch folded into the row index:
    (B * N, 4) int32 rows of the (B * H * W, C) table and (B * N, 4) f32
    weights, as the JAX ``_forward``s of K7 and K8 build them."""
    B, H, W, C = features.shape
    N = coords_ndc.shape[1]
    idx, w = _corner_indices(features.shape, coords_ndc, padding_mode)
    base = torch.arange(B, dtype=torch.int32,
                        device=idx.device)[:, None, None] * (H * W)
    return ((idx + base).reshape(B * N, 4),
            w.reshape(B * N, 4).to(torch.float32))


def onehot_gather(fm_flat: Tensor, idx: Tensor, w: Tensor) -> Tensor:
    """(rows, C) table, (N, 4) corner rows and weights -> (N, C) in the
    table's type: kernel K7 (JAX ``_onehot_gather``).

    CPU tensors take the plain version
    (:func:`~cross_attention_renderer_torch.ops.sorted_gather.take_gather`);
    CUDA tensors launch the kernel or raise."""
    if fm_flat.device.type == 'cpu':
        return plain_gather(fm_flat, idx, w, fm_flat.dtype)
    return launch_gather(onehot_gather, 'onehot_gather_bf16', fm_flat, idx,
                         w, fm_flat.dtype)


onehot_gather.launches = 0   # kernel launches, for the chip smoke test
onehot_gather.last_plan = None


def grid_sample_pallas(features: Tensor, coords_ndc: Tensor,
                       padding_mode: str = 'border') -> Tensor:
    """Bilinear ``grid_sample`` of (B, H, W, C) ``features`` at (B, N, 2)
    ndc ``coords_ndc`` -> (B, N, C), through K7 (forward of JAX
    ``grid_sample_pallas``; its custom VJP comes with training)."""
    B, H, W, C = features.shape
    idx, w = flat_corners(features, coords_ndc, padding_mode)
    out = onehot_gather(features.reshape(B * H * W, C), idx, w)
    return out.reshape(B, -1, C)


def grid_sample_auto(features: Tensor, coords_ndc: Tensor,
                     padding_mode: str = 'border',
                     gather: str = 'take') -> Tensor:
    """Bilinear sample through the gather ``gather`` names, with JAX
    ``grid_sample_auto``'s precedence, the argument standing in for its two
    environment switches:

    * ``'banded'`` (``CAR_BANDED_GATHER``): K8 where the table's bf16 bytes
      B * H * W * C * 2 are at most 4 MiB, else the take path;
    * ``'onehot'`` (``CAR_PALLAS_GATHER``): K7;
    * ``'take'``: the packed-cell take path
      (:func:`~cross_attention_renderer_torch.ops.grid_sample.grid_sample`).
    """
    from cross_attention_renderer_torch.ops.experimental import (
        banded_gather as BG)
    if gather not in GATHERS:
        raise ValueError(f'gather must be one of {GATHERS}, got {gather!r}')
    B, H, W, C = features.shape
    small_table = B * H * W * C * 2 <= BANDED_TABLE_BYTES
    if gather == 'banded' and small_table:
        return BG.grid_sample_banded(features, coords_ndc, padding_mode)
    if gather == 'onehot':
        return grid_sample_pallas(features, coords_ndc, padding_mode)
    return grid_sample(features, coords_ndc, padding_mode)
