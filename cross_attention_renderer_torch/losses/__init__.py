"""Losses and perceptual metrics: ``lf_loss`` (the training losses) and
``lpips`` (VGG16 LPIPS)."""
