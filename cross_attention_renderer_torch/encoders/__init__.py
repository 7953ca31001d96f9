"""The encoders: the DPT hybrid (ResNetV2 stem, multi-view ViT, DPT
fusion), the ResNet34 taps (``spatial``) and the U-Net down path (``unet``)."""

from cross_attention_renderer_torch.encoders.dpt import DPTHybridEncoder
from cross_attention_renderer_torch.encoders.resnetv2 import ResNetV2Stem
from cross_attention_renderer_torch.encoders.spatial import SpatialEncoder
from cross_attention_renderer_torch.encoders.unet import UNetEncoder
from cross_attention_renderer_torch.encoders.vit import MultiViewViT

__all__ = ['DPTHybridEncoder', 'MultiViewViT', 'ResNetV2Stem',
           'SpatialEncoder', 'UNetEncoder']
