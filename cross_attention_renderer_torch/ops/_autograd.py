"""Gradients for the CUDA kernels: one ``torch.autograd.Function`` for all.

The JAX package gives each Pallas kernel a ``custom_vjp`` whose backward is
the VJP of the kernel's plain jnp version, recomputed from the saved inputs
(e.g. ``ops/epipolar_attention.py:146-155``). :func:`kernel_call` does the
same for the port's kernels:

* forward: the kernel runs on the inputs with autograd off, and the inputs
  are saved;
* backward: under ``torch.enable_grad()`` the plain version reruns on
  detached copies of the saved inputs, and ``torch.autograd.grad`` of its
  outputs gives the gradients of exactly the inputs that need one. Integer
  inputs (cell rows, image ids, corner indices) never do.

The kernels take nested arguments (per-level tables and cell rows, the
10- or 20-tensor parameter sets) and plain Python values (sizes, flags).
They are flattened for the Function, tensors in order, and rebuilt for
both calls. A kernel's ``.launches`` counter counts forward launches only:
the backward never launches a kernel.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

Tensor = torch.Tensor


def _flatten(tree: Any, leaves: list) -> Any:
    """Tensors of ``tree`` (nested tuples and lists) appended to ``leaves``;
    returns the tree's spec, each tensor replaced by its leaf index."""
    if isinstance(tree, Tensor):
        leaves.append(tree)
        return _Leaf(len(leaves) - 1)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_flatten(t, leaves) for t in tree)
    return tree


def _unflatten(spec: Any, leaves) -> Any:
    if isinstance(spec, _Leaf):
        return leaves[spec.index]
    if isinstance(spec, (tuple, list)):
        return type(spec)(_unflatten(s, leaves) for s in spec)
    return spec


class _Leaf:
    __slots__ = ('index',)

    def __init__(self, index: int):
        self.index = index


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class _KernelFunction(torch.autograd.Function):
    """forward(launch, plain, spec, *leaves): the kernel; backward: the VJP
    of the plain version, recomputed (see the module docstring)."""

    @staticmethod
    def forward(ctx, launch, plain, spec, *leaves):
        ctx.plain, ctx.spec = plain, spec
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*leaves)
        return launch(*_unflatten(spec, leaves))

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n) for t, n in
                      zip(saved, need)]
            outs = _as_tuple(ctx.plain(*_unflatten(ctx.spec, leaves)))
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
            wanted = [t for t, n in zip(leaves, need) if n]
            found = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [g for _, g in pairs],
                allow_unused=True) if pairs and wanted else ())
        return (None, None, None) + tuple(
            next(found, None) if n else None for n in need)


def kernel_call(launch: Callable, plain: Callable, *args):
    """``launch(*args)``, differentiable through ``plain``'s VJP.

    ``launch`` runs the kernel and ``plain`` computes the same function in
    plain PyTorch; both take ``args`` (tensors, nested tuples or lists of
    them, and plain values) and return a tensor or a tuple of tensors.
    Where no input tensor requires a gradient, or grad mode is off, the
    kernel runs alone and nothing is saved."""
    leaves: list = []
    spec = _flatten(args, leaves)
    if not (torch.is_grad_enabled() and any(t.requires_grad
                                            for t in leaves)):
        return launch(*args)
    return _KernelFunction.apply(launch, plain, spec, *leaves)
