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
:func:`epipolar_attention_reference`, which the kernel is held against. The
kernel's gradients, of both outputs, are those of the plain version,
recomputed (:func:`~cross_attention_renderer_torch.ops._autograd.
kernel_call`), as the JAX ``custom_vjp`` computes them.
"""

from __future__ import annotations

import ctypes

import torch

from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops._autograd import kernel_call

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

    CPU tensors take the plain version. CUDA tensors must be contiguous and
    all bf16 or all f32, of any C and D; they launch the kernel's
    instantiation of that type (outputs in it too), and anything else
    raises."""
    if query.device.type == 'cpu':
        return epipolar_attention_reference(query, key, value)
    return kernel_call(_launch, epipolar_attention_reference, query, key,
                       value)


epipolar_attention.launches = 0   # kernel launches, for the chip smoke test

SMEM_LIMIT = 48 * 1024    # static shared memory a block of the kernel uses


def attention_plan(V: int, P: int, C: int) -> tuple[int, int, int]:
    """The kernel's launch for V*P joint rows and value width C, as its
    launcher computes it: (threads a block, slices of the value sum,
    bytes of shared memory). Thread (s, g) of the value sum takes channels
    4g .. 4g+3 of rows s, s + slices, ... (the last group of a C that is
    not a multiple of 4 the rest; such a C, or such a D, takes an
    instantiation that reads v, or q and k, a value at a time); the block
    keeps the V*P logits and the slices' (slices, C) partial sums in
    shared memory. Raises ValueError, with the shape, where the kernel
    cannot take it: capacities only."""
    groups = -(-C // 4)
    if not 0 < groups <= 1024 or V * P <= 0:
        raise ValueError(f'epipolar_attention: C={C} must be 1 to 4096 and '
                         f'V*P={V * P} positive')
    slices = 1 if groups >= 288 else 288 // groups
    smem = 4 * (V * P + slices * C)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f'epipolar_attention: V*P={V * P} logits and {slices} partial '
            f'sums of C={C} need {smem} bytes of shared memory a block, '
            f'more than {SMEM_LIMIT}')
    return -(-groups * slices // 32) * 32, slices, smem


ENTRY = {torch.bfloat16: 'epipolar_attention_bf16',
         torch.float32: 'epipolar_attention_f32'}


def _launch(query, key, value):
    B, V, R, P, D = query.shape
    C = value.shape[-1]
    dt = value.dtype
    if dt not in ENTRY:
        raise ValueError(f'epipolar_attention: bf16 or f32 inputs, got {dt}')
    for name, t, shape in (('query', query, (B, V, R, P, D)),
                           ('key', key, (B, V, R, P, D)),
                           ('value', value, (B, V, R, P, C))):
        if t.device != query.device or t.dtype != dt:
            raise ValueError(f'epipolar_attention: {name} must be {dt} on '
                             f'{query.device}, got {t.dtype} on {t.device}')
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f'epipolar_attention: {name} must be a '
                             f'contiguous {shape}, got {tuple(t.shape)}')
        if t.data_ptr() % 16:
            raise ValueError(f'epipolar_attention: {name} is not aligned')
    if D <= 0:
        raise ValueError(f'epipolar_attention: D={D} must be positive')
    attention_plan(V, P, C)
    out = torch.empty((B, R, C), dtype=value.dtype, device=value.device)
    at_wt = torch.empty((B, V, R, P), dtype=value.dtype, device=value.device)
    lib = _build.load('epipolar_attention')
    fn = getattr(lib, ENTRY[dt])
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
