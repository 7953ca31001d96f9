"""ResNetV2 hybrid stem of the DPT-hybrid encoder (R50+ViT-B/16).

Port of ``cross_attention_renderer_tpu/encoders/resnetv2.py``: weight-
standardized convs with TF-SAME padding, GroupNorm(32) bottlenecks without
pre-activation, stage widths 256/512/1024 at strides /4, /8, /16, all three
stage outputs returned. Channel-last (NHWC) at the module boundaries.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cross_attention_renderer_torch.layers import (GroupNorm, conv_nhwc,
                                                   lecun_normal_)

Tensor = torch.Tensor


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """TF-SAME padding of one axis; asymmetric (one more after) when the
    total is odd, which ``F.conv2d(padding='same')`` cannot express at
    stride > 1."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class StdConv(nn.Module):
    """Weight-standardized conv with TF-SAME padding and no bias (timm
    ``StdConv2dSame``): the kernel is standardized per output channel over
    (in, kh, kw) with the biased variance, in f32. The trunk uses eps 1e-8,
    the stem conv 1e-6 (models.py:93)."""

    def __init__(self, d_in: int, features: int, kernel_size: int,
                 stride: int = 1, eps: float = 1e-8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, d_in, kernel_size, kernel_size))
        self.stride, self.eps, self.dtype = stride, eps, dtype

    def reset_parameters(self, g: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), g)

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight
        mean = w.mean(dim=(1, 2, 3), keepdim=True)
        var = w.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        w = (w - mean) / torch.sqrt(var + self.eps)
        k = w.shape[-1]
        pads = (_same_pads(x.shape[1], k, self.stride)
                + _same_pads(x.shape[2], k, self.stride))
        return conv_nhwc(x.to(self.dtype), w.to(self.dtype), None,
                         self.stride, pads)


def max_pool_same(x: Tensor, window: int, stride: int) -> Tensor:
    """Max pool with TF-SAME padding by a finite -1e30 (the JAX package's
    choice, which keeps the TPU backward free of NaN)."""
    top, bottom = _same_pads(x.shape[1], window, stride)
    left, right = _same_pads(x.shape[2], window, stride)
    y = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              value=-1e30)
    return F.max_pool2d(y, window, stride).permute(0, 2, 3, 1)


class GroupNormRelu(nn.Module):
    """GroupNorm(32), optionally + ReLU (timm ``GroupNormAct``)."""

    def __init__(self, features: int, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(features, 32, 1e-5, dtype)
        self.act = act

    def forward(self, x: Tensor) -> Tensor:
        x = self.GroupNorm_0(x)
        return torch.relu(x) if self.act else x


class Bottleneck(nn.Module):
    """Non-preact bottleneck: conv-norm-relu twice, conv3-norm3, ReLU after
    the residual add; the projection shortcut is conv + norm."""

    def __init__(self, d_in: int, mid: int, out: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.needs_proj = d_in != out or stride != 1
        if self.needs_proj:
            self.downsample_conv = StdConv(d_in, out, 1, stride, dtype=dtype)
            self.downsample_norm = GroupNormRelu(out, act=False, dtype=dtype)
        self.conv1 = StdConv(d_in, mid, 1, dtype=dtype)
        self.norm1 = GroupNormRelu(mid, dtype=dtype)
        self.conv2 = StdConv(mid, mid, 3, stride, dtype=dtype)
        self.norm2 = GroupNormRelu(mid, dtype=dtype)
        self.conv3 = StdConv(mid, out, 1, dtype=dtype)
        self.norm3 = GroupNormRelu(out, act=False, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        shortcut = (self.downsample_norm(self.downsample_conv(x))
                    if self.needs_proj else x)
        y = self.norm1(self.conv1(x))
        y = self.norm2(self.conv2(y))
        y = self.norm3(self.conv3(y))
        return torch.relu(y + shortcut)


class ResNetV2Stem(nn.Module):
    """R50 trunk with ``layers`` blocks per stage; returns the three stage
    outputs. For a 256x256 input: (64x64, 256ch), (32x32, 512ch),
    (16x16, 1024ch)."""

    def __init__(self, layers: tuple[int, int, int] = (3, 4, 9),
                 width: int = 64, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stem_conv = StdConv(3, width, 7, 2, eps=1e-6, dtype=dtype)
        self.stem_norm = GroupNormRelu(width, dtype=dtype)
        self.layers = tuple(layers)
        d_in = width
        for stage_idx, n_blocks in enumerate(self.layers):
            out_ch = width * 4 * (2 ** stage_idx)
            for block_idx in range(n_blocks):
                stride = 2 if (block_idx == 0 and stage_idx > 0) else 1
                setattr(self, f'stage{stage_idx}_block{block_idx}',
                        Bottleneck(d_in, out_ch // 4, out_ch, stride, dtype))
                d_in = out_ch

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        x = self.stem_norm(self.stem_conv(x))
        x = max_pool_same(x, 3, 2)
        outs = []
        for stage_idx, n_blocks in enumerate(self.layers):
            for block_idx in range(n_blocks):
                x = getattr(self, f'stage{stage_idx}_block{block_idx}')(x)
            outs.append(x)
        return tuple(outs)
