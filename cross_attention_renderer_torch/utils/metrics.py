"""Image quality metrics (PSNR, SSIM), matching the reference eval protocol.

Port of ``cross_attention_renderer_tpu/utils/metrics.py``. Ref:
``eval_realestate10k.py:181-199``: images mapped to [0, 1], invalid rays
greyed to 0.5 in both prediction and target, MSE -> PSNR, and skimage's
``structural_similarity(win_size=11, multichannel=True,
gaussian_weights=True)``. The reference passes float images without
``data_range``, which old skimage resolves to 2.0 (float images assumed in
[-1, 1]) although they lie in [0, 1]; ``data_range`` defaults to 2.0 for
parity (DEVIATIONS.md) and can be set to 1.0 for the strict definition.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def mse(pred: Tensor, target: Tensor) -> Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: Tensor, target: Tensor) -> Tensor:
    """-10 log10(mse); images in [0, 1]. Ref img2mse / mse2psnr."""
    return -10.0 * torch.log10(mse(pred, target))


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(win: int, sigma: float) -> np.ndarray:
    r = np.arange(win) - (win - 1) / 2
    k = np.exp(-(r ** 2) / (2 * sigma ** 2))
    k = k / k.sum()
    return np.outer(k, k).astype(np.float32)


def ssim(pred: Tensor, target: Tensor, win_size: int = 11,
         sigma: float = 1.5, data_range: float = 2.0) -> Tensor:
    """Gaussian-weighted SSIM, channels averaged (skimage semantics).

    pred / target: (H, W, C) float images. The window runs as a depthwise
    'valid' convolution, the channels as a batch."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    kern = torch.as_tensor(_gaussian_kernel(win_size, sigma),
                           device=pred.device, dtype=pred.dtype)[None, None]

    def filt(x):
        # (H, W, C) -> (C, 1, H, W) -> (H', W', C)
        y = F.conv2d(x.permute(2, 0, 1)[:, None], kern)
        return y[:, 0].permute(1, 2, 0)

    ux, uy = filt(pred), filt(target)
    uxx, uyy = filt(pred * pred), filt(target * target)
    uxy = filt(pred * target)
    # skimage's covariances with Gaussian weights: vx = E[x^2] - E[x]^2
    vx = uxx - ux * ux
    vy = uyy - uy * uy
    vxy = uxy - ux * uy
    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)
    return torch.mean(num / den)


def eval_image_metrics(pred01: Tensor, target01: Tensor,
                       valid_mask: Tensor) -> dict:
    """Grey out invalid rays in both images, then MSE / PSNR / SSIM.

    Ref: eval_realestate10k.py:181-197."""
    pred = pred01 * valid_mask + 0.5 * (1 - valid_mask)
    target = target01 * valid_mask + 0.5 * (1 - valid_mask)
    m = mse(pred, target)
    return {'mse': m, 'psnr': -10.0 * torch.log10(m),
            'ssim': ssim(pred, target), 'pred': pred, 'target': target}
