"""Bilinear gather for small tables (kernel K8).

PyTorch port of ``cross_attention_renderer_tpu/ops/experimental/
banded_gather.py`` (``_banded_gather``, ``grid_sample_banded`` forward).
The TPU kernel walks the table in bands of 1024 rows behind a hit mask and
sums each band's selector product in f32; the CUDA kernel
(``csrc/bilinear_gather.cu``, shared by K5-K8) reads the four corner rows
of each sample, sums in f32 and casts to the table's type, as the TPU
wrapper does.
"""

from __future__ import annotations

import torch

from cross_attention_renderer_torch.ops.pallas_gather import flat_corners
from cross_attention_renderer_torch.ops.sorted_gather import (launch_gather,
                                                             plain_gather)

Tensor = torch.Tensor


def banded_gather(fm_flat: Tensor, idx: Tensor, w: Tensor) -> Tensor:
    """(rows, C) table, (N, 4) corner rows and weights -> (N, C) in the
    table's type: kernel K8 (JAX ``_banded_gather``).

    CPU tensors take the plain version
    (:func:`~cross_attention_renderer_torch.ops.sorted_gather.take_gather`);
    CUDA tensors launch the kernel or raise."""
    if fm_flat.device.type == 'cpu':
        return plain_gather(fm_flat, idx, w, fm_flat.dtype)
    return launch_gather(banded_gather, 'banded_gather_bf16', fm_flat, idx,
                         w, fm_flat.dtype)


banded_gather.launches = 0   # kernel launches, for the chip smoke test
banded_gather.last_plan = None


def grid_sample_banded(features: Tensor, coords_ndc: Tensor,
                       padding_mode: str = 'border') -> Tensor:
    """Bilinear ``grid_sample`` of (B, H, W, C) ``features`` at (B, N, 2)
    ndc ``coords_ndc`` -> (B, N, C), through K8 (forward of JAX
    ``grid_sample_banded``; its custom VJP comes with training)."""
    B, H, W, C = features.shape
    idx, w = flat_corners(features, coords_ndc, padding_mode)
    out = banded_gather(features.reshape(B * H * W, C), idx, w)
    return out.reshape(B, -1, C)
