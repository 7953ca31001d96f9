"""Gradient checks of the kernels' autograd Function
(``cross_attention_renderer_torch/ops/_autograd.py``), shared by the CPU
tests, where each kernel's plain version stands in for it, and the card
tests. Imports neither JAX nor the JAX package."""

from __future__ import annotations

import torch


def with_grad(args):
    """``args`` with every floating tensor replaced by a detached copy that
    requires a gradient; returns (args, those copies in order)."""
    leaves = []

    def walk(a):
        if isinstance(a, torch.Tensor):
            if not a.is_floating_point():
                return a
            t = a.detach().clone().requires_grad_(True)
            leaves.append(t)
            return t
        if isinstance(a, (tuple, list)):
            return type(a)(walk(x) for x in a)
        return a

    return walk(args), leaves


def as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def cotangents(outs, seed: int = 0) -> list:
    """One random cotangent an output, drawn on the CPU from ``seed``."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(o.shape, generator=g).to(o.device, o.dtype)
            for o in outs]


def outputs_and_grads(fn, args, seed: int = 0):
    """fn's outputs on fresh leaves of ``args`` and the gradients of
    sum(cotangent * output) over all outputs, for every floating input.
    Also asserts that every output carries a gradient function."""
    args, leaves = with_grad(args)
    outs = as_tuple(fn(*args))
    assert all(o.grad_fn is not None for o in outs), 'an output has no grad'
    grads = torch.autograd.grad(outs, leaves, cotangents(outs, seed),
                                allow_unused=True)
    return outs, grads


def max_rel_err(got, want) -> float:
    """max |got - want| over max(1e-30, max |want|)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()
                 / max(1e-30, float(want.abs().max())))
