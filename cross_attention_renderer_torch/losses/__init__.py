"""Losses and perceptual metrics: ``lf_loss`` (the training losses) and
``lpips`` (VGG16 LPIPS)."""

from cross_attention_renderer_torch.losses.lf_loss import (
    LFLoss,
    depth_smoothness_loss,
    image_loss,
    total_loss,
)

__all__ = ['LFLoss', 'depth_smoothness_loss', 'image_loss', 'total_loss']
