"""The encoders: the DPT hybrid (ResNetV2 stem, multi-view ViT, DPT
fusion), the ResNet34 taps (``spatial``) and the U-Net down path (``unet``)."""
