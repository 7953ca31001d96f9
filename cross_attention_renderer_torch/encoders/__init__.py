"""The DPT-hybrid encoder: ResNetV2 stem, multi-view ViT, DPT fusion."""
