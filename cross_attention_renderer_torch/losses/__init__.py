"""Losses and perceptual metrics: ``lpips`` (VGG16 LPIPS)."""
