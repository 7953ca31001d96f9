"""Fused two-layer per-sample MLP: out = relu(x1 @ W1a + x2 @ W1b + b1) @ W2
+ b2, with the hidden layer kept on chip (kernel K9).

PyTorch port of ``fused_mlp2`` of
``cross_attention_renderer_tpu/ops/experimental/fused_mlp.py``. The
renderer's unfused exchange applies it to every epipolar sample of every
stream (the fuse encoder, models.py:335-346): x1 the gathered pyramid
features, x2 = tanh(pt/5).

On a CUDA tensor :func:`fused_mlp2` launches the hand-written kernel
``csrc/fused_mlp.cu``; on a CPU tensor it runs the plain version
:func:`fused_mlp2_reference`, which mirrors the JAX off-TPU path.
"""

from __future__ import annotations

import ctypes

import torch

from cross_attention_renderer_torch.ops import _build

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
    which takes x1 bf16 and contiguous with K1 % 16 == 0, x2 contiguous
    (M, 3) in bf16, H % 16 == 0 and O % 8 == 0; anything else raises. The
    kernel rounds its inputs as the TPU kernel does: x2 and the weight
    matrices to bf16, biases kept in f32, the hidden layer rounded to bf16
    before the second product."""
    if x1.device.type == 'cpu':
        return fused_mlp2_reference(x1, x2, w1a, w1b, b1, w2, b2)
    return _launch(x1, x2, w1a, w1b, b1, w2, b2)


fused_mlp2.launches = 0   # kernel launches, for the chip smoke test


def _launch(x1, x2, w1a, w1b, b1, w2, b2):
    dev, dt = x1.device, torch.bfloat16
    M, K1 = x1.shape
    H, O = w1a.shape[1], w2.shape[1]

    def require(cond, msg):
        if not cond:
            raise ValueError(f'fused_mlp2: {msg}')

    require(x1.dtype == dt and x1.is_contiguous() and x1.data_ptr() % 16 == 0
            and K1 % 16 == 0, 'x1 must be contiguous aligned bf16, '
            'K1 % 16 == 0')
    require(x2.device == dev and x2.dtype == dt and x2.is_contiguous()
            and tuple(x2.shape) == (M, 3), f'x2 must be contiguous bf16 '
            f'({M}, 3) on {dev}')
    require(tuple(w1a.shape) == (K1, H) and tuple(w1b.shape) == (3, H)
            and tuple(w2.shape) == (H, O) and H % 16 == 0 and O % 8 == 0,
            'weight shapes')
    w1t = w1a.to(dev, dt).t().contiguous()           # (H, K1)
    w2t = w2.to(dev, dt).t().contiguous()            # (O, H)
    w1x = w1b.to(dev, dt).float().contiguous()       # bf16 values as f32
    b1f = b1.to(dev, torch.float32).contiguous()
    b2f = b2.to(dev, torch.float32).contiguous()
    out = torch.empty((M, O), dtype=dt, device=dev)

    fn = _build.load('fused_mlp').fused_mlp2_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(x1.data_ptr(), x2.data_ptr(), w1t.data_ptr(),
                        w1x.data_ptr(), b1f.data_ptr(), w2t.data_ptr(),
                        b2f.data_ptr(), out.data_ptr(), M, K1, H, O, stream),
                     'fused_mlp2')
    fused_mlp2.launches += 1
    return out
