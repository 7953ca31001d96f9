"""pixelNeRF-style multi-scale ResNet34 encoder (``--model resnet``).

Port of ``cross_attention_renderer_tpu/encoders/spatial.py`` (the
reference's ``SpatialEncoder``, encoder.py:12-104, with GroupNorm(32) in
place of BatchNorm, as there): ResNet34's conv1 .. layer3 without the first
max-pool, the four taps returned coarsest first, channel-last:

  encoder(rgb (N, H, W, 3)) -> (256 @ H/8, 128 @ H/4, 64 @ H/2, 64 @ H/2)

(concatenated width 512). The modules carry the Flax names (``conv1``,
``norm1``, ``layer{1,2,3}_b{i}`` with ``conv1``, ``norm1``, ``conv2``,
``norm2``, ``proj``, ``proj_norm``), so ``convert.params_from_jax`` maps
the JAX parameters one to one. The blocks' norms take Flax's two-pass
variance (``use_fast_variance=False``), which ``F.group_norm`` computes;
the stem's takes Flax's default one-pass variance, equal up to rounding.
"""

from __future__ import annotations

import torch
from torch import nn

from cross_attention_renderer_torch.layers import Conv, GroupNorm

Tensor = torch.Tensor

# flax.linen.GroupNorm's epsilon
GN_EPS = 1e-6


class BasicBlock(nn.Module):
    """Two 3x3 conv + GroupNorm, the first with ReLU, a 1x1 conv + norm
    projection where the width or the stride changes, ReLU after the
    residual add."""

    def __init__(self, d_in: int, features: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(d_in, features, 3, stride, padding=1,
                          use_bias=False, dtype=dtype)
        self.norm1 = GroupNorm(features, 32, GN_EPS, dtype)
        self.conv2 = Conv(features, features, 3, padding=1, use_bias=False,
                          dtype=dtype)
        self.norm2 = GroupNorm(features, 32, GN_EPS, dtype)
        self.needs_proj = d_in != features or stride != 1
        if self.needs_proj:
            self.proj = Conv(d_in, features, 1, stride, use_bias=False,
                             dtype=dtype)
            self.proj_norm = GroupNorm(features, 32, GN_EPS, dtype)

    def forward(self, x: Tensor) -> Tensor:
        y = torch.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        if self.needs_proj:
            x = self.proj_norm(self.proj(x))
        return torch.relu(y + x)


class SpatialEncoder(nn.Module):
    """ResNet34 layers conv1 .. layer3 (3, 4 and 6 blocks), multi-scale
    taps in reversed order."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 2, padding=3, use_bias=False, dtype=dtype)
        self.norm1 = GroupNorm(64, 32, GN_EPS, dtype)
        d_in = 64
        for layer, (width, n_blocks) in enumerate(((64, 3), (128, 4),
                                                   (256, 6)), start=1):
            for i in range(n_blocks):
                stride = 2 if i == 0 and layer > 1 else 1
                setattr(self, f'layer{layer}_b{i}',
                        BasicBlock(d_in, width, stride, dtype))
                d_in = width
        self.blocks = (3, 4, 6)

    def forward(self, rgb: Tensor) -> tuple[Tensor, ...]:
        x = torch.relu(self.norm1(self.conv1(rgb)))
        taps = [x]                       # 64 @ H/2
        # use_first_pool=False (models.py:64): layer1 stays at H/2.
        for layer, n_blocks in enumerate(self.blocks, start=1):
            for i in range(n_blocks):
                x = getattr(self, f'layer{layer}_b{i}')(x)
            taps.append(x)               # 64 @ H/2, 128 @ H/4, 256 @ H/8
        return tuple(reversed(taps))
