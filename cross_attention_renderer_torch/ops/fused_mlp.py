"""Fused two-layer per-sample MLP: out = relu(x1 @ W1a + x2 @ W1b + b1) @ W2
+ b2, with the hidden layer kept on chip (kernel K9).

PyTorch port of ``fused_mlp2`` of
``cross_attention_renderer_tpu/ops/experimental/fused_mlp.py``. The
renderer's unfused exchange applies it to every epipolar sample of every
stream (the fuse encoder, models.py:335-346): x1 the gathered pyramid
features, x2 = tanh(pt/5).

On a CUDA tensor :func:`fused_mlp2` launches the hand-written kernel
``csrc/fused_mlp.cu`` (the exchange core's MLP-only mode); on a CPU tensor it runs the plain version
:func:`fused_mlp2_reference`, which mirrors the JAX off-TPU path. The
kernel's gradients are the plain version's, every parameter cast to x1's
type (the JAX ``_bwd``), recomputed (:func:`~cross_attention_renderer_torch.
ops._autograd.kernel_call`).
"""

from __future__ import annotations

import ctypes

import torch

from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops._autograd import kernel_call
from cross_attention_renderer_torch.ops import gather_epilogue as GE

Tensor = torch.Tensor


def fused_mlp2_reference(x1: Tensor, x2: Tensor, w1a: Tensor, w1b: Tensor,
                         b1: Tensor, w2: Tensor, b2: Tensor) -> Tensor:
    """Plain version: every operand in x1's type, as the JAX ``_forward``
    computes it off the TPU (``_mlp2_ref``)."""
    dt = x1.dtype
    h = x1 @ w1a.to(dt) + b1.to(dt)
    h = h + x2.to(dt) @ w1b.to(dt)
    return torch.relu(h) @ w2.to(dt) + b2.to(dt)


def fused_mlp2(x1: Tensor, x2: Tensor, w1a: Tensor, w1b: Tensor, b1: Tensor,
               w2: Tensor, b2: Tensor) -> Tensor:
    """relu(x1 @ w1a + x2 @ w1b + b1) @ w2 + b2 -> (M, O) in x1's type.

    Args:
      x1: (M, K1); x2: (M, K2), the input's two segments.
      w1a: (K1, H); w1b: (K2, H); b1: (H,); w2: (H, O); b2: (O,).

    CPU tensors take the plain version. CUDA tensors launch the kernel,
    which takes x1 bf16 or f32 and contiguous, x2 contiguous (M, 3) in x1's
    type (the output too), and any K1, H and O (an x1 row whose K1 is not a
    multiple of 8 is read an element at a time; the weights' tiles are
    zero past H and O; ``gather_epilogue.check_core_widths`` refuses only
    capacities); anything else raises. The kernel rounds its inputs as the
    TPU kernel does: x2 and the weight matrices to bf16, biases kept in f32,
    the hidden layer rounded to bf16 before the second product; f32 x1 is
    rounded to bf16 on its way to the products (``csrc/exchange_core.cuh``,
    "Element types"). The weights
    are laid out once per set of parameter tensors, or views of them
    (``gather_epilogue.prepared_mlp``)."""
    if x1.device.type == 'cpu':
        return fused_mlp2_reference(x1, x2, w1a, w1b, b1, w2, b2)
    return kernel_call(_launch, fused_mlp2_reference, x1, x2, w1a, w1b, b1,
                       w2, b2)


fused_mlp2.launches = 0   # kernel launches, for the chip smoke test
# the last launch's (grid, stage slots, shared bytes, threads a block,
# cluster x, y, z), its plan (gather_epilogue.core_plan) and its widths
fused_mlp2.last_launch = None
fused_mlp2.last_plan = None
fused_mlp2.last_widths = None


def _launch(x1, x2, w1a, w1b, b1, w2, b2):
    dev, dt = x1.device, x1.dtype
    M, K1 = x1.shape
    H, O = w1a.shape[1], w2.shape[1]

    def require(cond, msg):
        if not cond:
            raise ValueError(f'fused_mlp2: {msg}')

    require(dt in GE.CORE_TYPES and x1.is_contiguous()
            and x1.data_ptr() % 16 == 0 and K1 > 0 and M > 0,
            'x1 must be contiguous aligned bf16 or f32')
    require(x2.device == dev and x2.dtype == dt and x2.is_contiguous()
            and tuple(x2.shape) == (M, 3), f'x2 must be contiguous {dt} '
            f'({M}, 3) on {dev}')
    require(tuple(w1a.shape) == (K1, H) and tuple(w1b.shape) == (3, H)
            and tuple(w2.shape) == (H, O), 'weight shapes')
    GE.check_core_widths('fused_mlp2', 'mlp', 1, K1, H, O, 0)
    stages, vecs = GE.prepared_mlp((w1a, w1b, b1, w2, b2), dev)
    scratch = GE.core_scratch('mlp', 1, K1, H, O, 0, -(-M // 64), dev)
    out = torch.empty((M, O), dtype=dt, device=dev)

    fn = GE.core_entry('fused_mlp', 'fused_mlp2', dt, O=O)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2)
    info = (ctypes.c_int * 8)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(x1.data_ptr(), x2.data_ptr(), stages.data_ptr(),
                        stages.numel() * 2, vecs.data_ptr(), out.data_ptr(),
                        M, K1, H, O, *GE._scratch_args(scratch), info,
                        stream), 'fused_mlp2')
    GE.record_launch(fused_mlp2, info, dict(mode='mlp', S=1, F=K1, H1=H,
                                            O=O, K=0))
    return out
