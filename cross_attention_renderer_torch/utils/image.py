"""Image utilities: ImageNet normalization and exact bilinear resizing.

Port of ``cross_attention_renderer_tpu/utils/image.py``. The resize is two
separable interpolation matrix products (out = Wy @ img @ Wx^T), exact for
both align_corners conventions: the DPT fusion upsample uses
align_corners=True (midas/blocks.py:335-337), the position-embedding resize
align_corners=False (midas/vit.py:116). Layout is channel-last.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_imagenet(rgb01: torch.Tensor) -> torch.Tensor:
    """Channel-last ImageNet normalization. Ref: utils/util.py:21-31."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32,
                        device=rgb01.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=rgb01.device)
    return (rgb01 - mean) / std


@functools.lru_cache(maxsize=64)
def _interp_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    """(n_out, n_in) bilinear interpolation weights."""
    if n_out == 1:
        src = np.zeros(1)
    elif align_corners:
        src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    else:
        scale = n_in / n_out
        src = (np.arange(n_out) + 0.5) * scale - 0.5
    src = np.clip(src, 0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w_hi = src - lo
    mat = np.zeros((n_out, n_in), np.float32)
    mat[np.arange(n_out), lo] += 1.0 - w_hi
    mat[np.arange(n_out), hi] += w_hi
    mat.flags.writeable = False    # shared by every caller of the cache
    return mat


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int],
                    align_corners: bool = False) -> torch.Tensor:
    """Resize (..., H, W, C) to (..., H_out, W_out, C) bilinearly."""
    H, W = x.shape[-3], x.shape[-2]
    Ho, Wo = out_hw
    if (H, W) == (Ho, Wo):
        return x
    wy = torch.tensor(_interp_matrix(H, Ho, align_corners), dtype=x.dtype,
                      device=x.device)
    wx = torch.tensor(_interp_matrix(W, Wo, align_corners), dtype=x.dtype,
                      device=x.device)
    x = torch.einsum('oh,...hwc->...owc', wy, x)
    return torch.einsum('ow,...hwc->...hoc', wx, x)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """The DPT fusion upsample: x2, bilinear, align_corners=True."""
    H, W = x.shape[-3], x.shape[-2]
    return resize_bilinear(x, (2 * H, 2 * W), align_corners=True)
