"""Training losses.

Port of ``cross_attention_renderer_tpu/losses/lf_loss.py`` (behavioural
reference: the reference repo's ``loss_functions.py``):

* L1 image loss with NaN zeroing (loss_functions.py:74-80);
* the depth variance regulariser on 32x32 ray patches, gated by the
  per-sample patch mask and weighted by ``l2_weight``
  (loss_functions.py:120-129);
* LPIPS (VGG) on 32x32 patches x0.1 under the same mask gate
  (loss_functions.py:102-118), through ``losses.lpips.load_lpips``.

Every loss is a function of (model_out, gt) -> scalar; no modules, no state.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

Tensor = torch.Tensor

PATCH = 32  # LPIPS and depth losses run on 32x32 ray patches (loss_functions.py:107)


def image_loss(model_out: dict, gt: dict) -> Tensor:
    """Mean absolute error with NaN scrubbing (loss_functions.py:74-80)."""
    gt_rgb = torch.nan_to_num(gt['rgb'], nan=0.0)
    rgb = torch.nan_to_num(model_out['rgb'], nan=0.0)
    return (gt_rgb - rgb).abs().mean()


def depth_smoothness_loss(model_out: dict, gt: dict,
                          l2_weight: float = 1e-3) -> Tensor:
    """Variance of the attention depth over each 32x32 patch, masked to
    patch-sampled rays (loss_functions.py:120-129). Ray sets that are not a
    whole number of patches give 0: the patch sampler sets the mask only
    for whole patches (realestate10k_dataio.py:380-393)."""
    depth = model_out['depth_ray'][..., 0]
    if depth.numel() % (PATCH * PATCH) != 0:
        return depth.new_zeros(())
    depth = depth.reshape(-1, PATCH * PATCH)
    mean = depth.mean(dim=-1, keepdim=True)
    dist = l2_weight * (depth - mean).square().mean(dim=-1)
    mask = gt['mask'].reshape(-1)
    return (dist * mask).mean()


class LFLoss:
    """The composite loss (``LFLoss``, loss_functions.py:83-132).

    Args:
      l2_weight: the depth-variance weight (the reference's --l2_coeff).
      depth: add the depth smoothness term (training only).
      lpips_fn: optional (pred, gt) -> per-image LPIPS; when set it runs on
        32x32 patches with weight 0.1 (loss_functions.py:115-118).
    """

    def __init__(self, l2_weight: float = 1e-3, depth: bool = False,
                 lpips_fn: Optional[Callable] = None):
        self.l2_weight = l2_weight
        self.depth = depth
        self.lpips_fn = lpips_fn

    def __call__(self, model_out: dict, gt: dict, val: bool = False) -> dict:
        losses = {'img_loss': image_loss(model_out, gt)}
        if self.lpips_fn is not None:
            pred = model_out['rgb'].reshape(-1, PATCH, PATCH, 3)
            target = gt['rgb'].reshape(-1, PATCH, PATCH, 3)
            mask = gt['mask'].reshape(-1)
            if mask.shape[0] == pred.shape[0]:
                pred = pred * mask[:, None, None, None]
                target = target * mask[:, None, None, None]
            losses['lpips_loss'] = 0.1 * self.lpips_fn(pred, target).mean()
        if self.depth and not val:
            losses['depth_loss'] = depth_smoothness_loss(
                model_out, gt, self.l2_weight)
        return losses


def total_loss(losses: dict) -> Tensor:
    """The sum of every loss's mean."""
    return sum(torch.as_tensor(v).mean() for v in losses.values())
