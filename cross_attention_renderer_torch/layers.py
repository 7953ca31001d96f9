"""Leaf layers with Flax's semantics, channel-last, and the seeded initialiser.

Parameters are stored in f32 and cast to the layer's compute ``dtype`` at
use, as a Flax module with ``dtype=bfloat16`` and f32 params does. Weight
layouts are PyTorch's (``Linear``: (out, in); conv: OIHW);
:mod:`cross_attention_renderer_torch.convert` maps Flax parameters onto
them. Each layer records how it is initialised, and
:func:`init_parameters` draws every parameter of a model from one
``torch.Generator``, with the Flax initialisers' distributions.

Tensor parallelism: a layer whose ``tp`` is set (``train/trainer.py:
shard_state``) holds its slice of a Megatron pair. A ``('column', group)``
layer holds a slice of the output features and its bias: its input passes
:func:`copy_to_group` (identity forward, all-reduce backward). A ``('row',
group)`` layer holds the matching slice of the input features: its product
passes :func:`reduce_from_group` (all-reduce forward, identity backward),
then its replicated bias is added once. ``tp`` None (the default) is the
whole layer, computed as without a mesh. A kernel that reads a pair's whole
weights (the fused exchanges, ``models/renderer.py``) takes them through
:func:`gather_from_group` (all-gather forward, this rank's slice of the
gradient backward): every rank of the group runs the same kernel on the
same rows, so each computes the whole weights' gradient and keeps its
slice, as the sliced layers would have computed it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from cross_attention_renderer_torch.parallel.distributed import (
    all_gather_cat, all_reduce_sum)

Tensor = torch.Tensor


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, sum over the group backward: the input of a
    column-parallel layer, whose every rank's slice reads all of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward, identity backward: the output of a
    row-parallel layer, each rank's product one slice of the sum."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromGroup(torch.autograd.Function):
    """The group's slices concatenated along ``dim`` forward, this rank's
    slice of the gradient backward: a whole weight that every rank of the
    group uses in the same computation, so that each rank's gradient is
    already the whole one (a sum over the group would count it ``group
    size`` times)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank(ctx.group)
        return (grad.narrow(ctx.dim, rank * ctx.size, ctx.size).contiguous(),
                None, None)


def gather_from_group(x: Tensor, group, dim: int) -> Tensor:
    return _GatherFromGroup.apply(x, group, dim)


def copy_to_group(x: Tensor, group) -> Tensor:
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: Tensor, group) -> Tensor:
    return _ReduceFromGroup.apply(x, group)


def parallel_product(tp, product, inputs, bias: Optional[Tensor]) -> Tensor:
    """``product(*inputs)`` (the layer's product without its bias) plus
    ``bias`` under the layer's tensor-parallel role ``tp``, (mode,
    group)."""
    mode, group = tp
    if mode == 'column':
        inputs = [copy_to_group(x, group) for x in inputs]
    y = product(*inputs)
    if mode == 'row':
        y = reduce_from_group(y, group)
    return y if bias is None else y + bias

# Flax's variance-scaling truncated normal is cut at two standard deviations
# and rescaled by this factor so that its variance is the requested one.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: Tensor, fan_in: int, g: torch.Generator) -> None:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


def kaiming_normal_(w: Tensor, fan_in: int, g: torch.Generator) -> None:
    with torch.no_grad():
        w.normal_(0.0, math.sqrt(2.0 / fan_in), generator=g)


class Dense(nn.Module):
    """``flax.linen.Dense``: y = x @ W^T + b over the last axis.

    ``init`` is 'lecun' (Flax's default), 'kaiming' (fan-in normal with
    variance 2/fan_in) or 'zeros'."""

    def __init__(self, d_in: int, features: int, use_bias: bool = True,
                 init: str = 'lecun', dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, d_in))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.init, self.dtype = init, dtype
        self.tp = None

    def reset_parameters(self, g: torch.Generator) -> None:
        fan_in = self.weight.shape[1]
        if self.init == 'zeros':
            nn.init.zeros_(self.weight)
        elif self.init == 'kaiming':
            kaiming_normal_(self.weight, fan_in, g)
        else:
            lecun_normal_(self.weight, fan_in, g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.tp is not None:
            w = self.weight.to(dt)
            return parallel_product(self.tp, lambda x: F.linear(x.to(dt), w),
                                    [x], b)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def conv_nhwc(x: Tensor, w: Tensor, b: Optional[Tensor], stride: int,
              padding) -> Tensor:
    """2D convolution of a channel-last (N, H, W, C) tensor with an OIHW
    kernel; ``padding`` is symmetric (int) or (top, bottom, left, right)."""
    x = x.permute(0, 3, 1, 2)
    if isinstance(padding, tuple):
        top, bottom, left, right = padding
        x = F.pad(x, (left, right, top, bottom))
        padding = 0
    return F.conv2d(x, w, b, stride=stride, padding=padding).permute(0, 2, 3,
                                                                    1)


class Conv(nn.Module):
    """``flax.linen.Conv`` on NHWC with symmetric integer padding."""

    def __init__(self, d_in: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(features, d_in, kernel_size, kernel_size))
        self.bias = (nn.Parameter(torch.zeros(features)) if use_bias
                     else None)
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.tp = None

    def reset_parameters(self, g: torch.Generator) -> None:
        lecun_normal_(self.weight, self.weight[0].numel(), g)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.tp is not None:
            w = self.weight.to(dt)
            return parallel_product(
                self.tp, lambda x: conv_nhwc(x.to(dt), w, None, self.stride,
                                             self.padding), [x], b)
        return conv_nhwc(x.to(dt), self.weight.to(dt), b, self.stride,
                         self.padding)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: statistics and scaling in f32, output cast
    to the compute type."""

    def __init__(self, features: int, eps: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps, self.dtype = eps, dtype

    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.weight, self.bias,
                            self.eps).to(self.dtype)


class GroupNorm(nn.Module):
    """``flax.linen.GroupNorm`` on NHWC: statistics over (H, W, C/G) per
    group, in f32 (f64 for an f64 model), output cast to the compute
    type."""

    def __init__(self, features: int, num_groups: int = 32,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype

    def reset_parameters(self, g: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: Tensor) -> Tensor:
        # f32, or f64 for an f64 model (a gradient reference in the tests)
        dt = torch.promote_types(self.dtype, torch.float32)
        y = F.group_norm(x.to(dt).permute(0, 3, 1, 2), self.num_groups,
                         self.weight.to(dt), self.bias.to(dt), self.eps)
        return y.permute(0, 2, 3, 1).to(self.dtype)


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Draws every parameter of ``model`` from one generator seeded with
    ``seed``, layer by layer in registration order. Returns ``model``."""
    g = torch.Generator(device='cpu').manual_seed(seed)
    for m in model.modules():
        if hasattr(m, 'reset_parameters'):
            m.reset_parameters(g)
    return model
