"""The renderer and its light-field decoder."""

from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.models.resnet_fc import (
    ResnetBlockFC, ResnetFC)

__all__ = ['CrossAttentionRenderer', 'ResnetBlockFC', 'ResnetFC']
