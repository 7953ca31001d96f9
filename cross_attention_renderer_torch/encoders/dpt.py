"""DPT feature decoder + the full hybrid encoder.

Port of ``cross_attention_renderer_tpu/encoders/dpt.py``: the R50 stem, the
multi-view ViT and the RefineNet fusion cascade, truncated like the
reference to the two highest-resolution fusion maps:

  encoder(rgb, rel_pose) -> (path_2: (B*V, H/4, W/4, features),
                             path_1: (B*V, H/2, W/2, features))
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cross_attention_renderer_torch.encoders.resnetv2 import ResNetV2Stem
from cross_attention_renderer_torch.encoders.vit import MultiViewViT
from cross_attention_renderer_torch.layers import Conv, Dense
from cross_attention_renderer_torch.utils.image import (
    upsample2x_align_corners)

Tensor = torch.Tensor


class ProjectReadout(nn.Module):
    """Fold the cls token into every spatial token (readout='project')."""

    def __init__(self, width: int = 768, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.project = Dense(2 * width, width, dtype=dtype)

    def forward(self, tokens_with_cls: Tensor) -> Tensor:
        cls, tokens = tokens_with_cls[:, :1], tokens_with_cls[:, 1:]
        x = torch.cat([tokens, cls.expand_as(tokens)], dim=-1)
        return F.gelu(self.project(x))


class ResidualConvUnit(nn.Module):
    """ReLU -> conv3x3 -> ReLU -> conv3x3, residual."""

    def __init__(self, features: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(features, features, 3, padding=1, dtype=dtype)
        self.conv2 = Conv(features, features, 3, padding=1, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        y = self.conv2(torch.relu(self.conv1(torch.relu(x))))
        return y + x


class FeatureFusionBlock(nn.Module):
    """RefineNet fusion: add the refined skip (when there is one), refine,
    upsample x2 (align_corners=True), project."""

    def __init__(self, features: int = 256, has_skip: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if has_skip:
            self.rcu1 = ResidualConvUnit(features, dtype)
        self.rcu2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv(features, features, 1, dtype=dtype)

    def forward(self, x: Tensor, skip: Tensor | None = None) -> Tensor:
        if skip is not None:
            x = x + self.rcu1(skip)
        x = upsample2x_align_corners(self.rcu2(x))
        return self.out_conv(x)


class DPTHybridEncoder(nn.Module):
    """R50 stem + multi-view ViT + DPT fusion, truncated at [path_2, path_1].

    The input rgb must already be ImageNet-normalized."""

    def __init__(self, features: int = 256, vit_width: int = 768,
                 vit_depth: int = 12, vit_heads: int = 12,
                 resnet_layers: tuple[int, int, int] = (3, 4, 9),
                 resnet_width: int = 64, pretrain_grid: int = 14,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        self.vit_width = vit_width
        self.backbone = ResNetV2Stem(resnet_layers, resnet_width, dtype)
        taps = ((8, 11) if vit_depth == 12
                else (max(vit_depth * 3 // 4 - 1, 0), vit_depth - 1))
        stage = [resnet_width * 4 * 2 ** i for i in range(3)]
        self.vit = MultiViewViT(stage[2], vit_width, vit_depth, vit_heads,
                                taps, pretrain_grid, dtype, remat)
        self.ProjectReadout_0 = ProjectReadout(vit_width, dtype)
        self.ProjectReadout_1 = ProjectReadout(vit_width, dtype)
        self.post3_conv = Conv(vit_width, vit_width, 1, dtype=dtype)
        self.post4_conv1 = Conv(vit_width, vit_width, 1, dtype=dtype)
        self.post4_conv2 = Conv(vit_width, vit_width, 3, stride=2, padding=1,
                                dtype=dtype)
        for i, d_in in enumerate((stage[0], stage[1], vit_width, vit_width)):
            setattr(self, f'layer{i + 1}_rn',
                    Conv(d_in, features, 3, padding=1, use_bias=False,
                         dtype=dtype))
        for i in range(1, 5):
            setattr(self, f'refinenet{i}',
                    FeatureFusionBlock(features, i != 4, dtype))

    def forward(self, rgb: Tensor, rel_pose16: Tensor
                ) -> tuple[Tensor, Tensor]:
        """rgb: (B, V, H, W, 3); rel_pose16: (B, V, 16)."""
        B, V, H, W, _ = rgb.shape
        stage0, stage1, stage2 = self.backbone(rgb.reshape(B * V, H, W, 3))
        Hg, Wg = stage2.shape[1], stage2.shape[2]
        tap3, tap4 = self.vit(stage2.reshape(B, V, Hg, Wg, -1), rel_pose16)

        def to_grid(readout, tokens):
            return readout(tokens).reshape(B * V, Hg, Wg, self.vit_width)

        layer3 = self.post3_conv(to_grid(self.ProjectReadout_0, tap3))
        layer4 = self.post4_conv2(self.post4_conv1(
            to_grid(self.ProjectReadout_1, tap4)))

        path4 = self.refinenet4(self.layer4_rn(layer4))
        path3 = self.refinenet3(path4, self.layer3_rn(layer3))
        path2 = self.refinenet2(path3, self.layer2_rn(stage1))
        path1 = self.refinenet1(path2, self.layer1_rn(stage0))
        return path2, path1
