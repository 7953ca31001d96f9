"""Joint (view, sample) softmax epipolar attention.

PyTorch port of ``cross_attention_renderer_tpu/ops/epipolar_attention.py``.
A per-sample query embedding is contracted against a per-sample key
embedding, softmaxed jointly over the (view, sample) axis of each ray, and
the weights sum the per-sample latents (reference models.py:532-541,555-565).

  out, at_wt = epipolar_attention(query, key, value)
    query/key: (B, V, R, P, D) -- D = 128 attention width
    value:     (B, V, R, P, C) -- C = latent width
    out:       (B, R, C)       -- summed over views
    at_wt:     (B, V, R, P)    -- joint softmax weights

On a CUDA tensor :func:`epipolar_attention` launches the hand-written kernel
``csrc/epipolar_attention.cu``; on a CPU tensor it runs the plain version
:func:`epipolar_attention_reference`, which the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from cross_attention_renderer_torch.ops import _build

ATTN_SCALE = 1.0 / 16.0   # models.py:532,555


def epipolar_attention_reference(query: torch.Tensor, key: torch.Tensor,
                                 value: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: logits and softmax in f32, weights cast to the value
    type, value sum accumulated in f32 (the JAX reference's policy)."""
    B, V, R, P, _ = query.shape
    dots = torch.einsum('bvrpd,bvrpd->bvrp', query.float(),
                        key.float()) * ATTN_SCALE
    flat = dots.permute(0, 2, 1, 3).reshape(B, R, V * P)
    wt = torch.softmax(flat, dim=-1)
    at_wt = wt.reshape(B, R, V, P).permute(0, 2, 1, 3).to(value.dtype)
    z = torch.einsum('bvrp,bvrpc->brc', at_wt.float(), value.float())
    return z.to(value.dtype), at_wt.contiguous()


def epipolar_attention(query: torch.Tensor, key: torch.Tensor,
                       value: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint-softmax attention; see the module docstring.

    CPU tensors take the plain version. CUDA tensors must be bf16 and
    contiguous; they launch the kernel, and anything else raises."""
    if query.device.type == 'cpu':
        return epipolar_attention_reference(query, key, value)
    return _launch(query, key, value)


epipolar_attention.launches = 0   # kernel launches, for the chip smoke test


def _launch(query, key, value):
    B, V, R, P, D = query.shape
    C = value.shape[-1]
    for name, t, shape in (('query', query, (B, V, R, P, D)),
                           ('key', key, (B, V, R, P, D)),
                           ('value', value, (B, V, R, P, C))):
        if t.device != query.device or t.dtype != torch.bfloat16:
            raise ValueError(f'epipolar_attention: {name} must be bf16 on '
                             f'{query.device}, got {t.dtype} on {t.device}')
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'epipolar_attention: {name} must be a '
                             f'contiguous {shape}, got {tuple(t.shape)}')
        if t.data_ptr() % 16:
            raise ValueError(f'epipolar_attention: {name} is not aligned')
    if D % 4 or C % 4:
        raise ValueError(f'epipolar_attention: D={D} and C={C} must be '
                         'multiples of 4')
    out = torch.empty((B, R, C), dtype=value.dtype, device=value.device)
    at_wt = torch.empty((B, V, R, P), dtype=value.dtype, device=value.device)
    lib = _build.load('epipolar_attention')
    fn = lib.epipolar_attention_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(query.data_ptr(), key.data_ptr(), value.data_ptr(),
                        out.data_ptr(), at_wt.data_ptr(), B, V, R, P, D, C,
                        ATTN_SCALE, stream), 'epipolar_attention')
    epipolar_attention.launches += 1
    return out, at_wt
