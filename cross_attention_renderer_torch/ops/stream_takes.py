"""The exchange streams' address math: the cell rows and aux rows that the
fused exchange epilogues (K2, K3) and the fused render core (K4) read.

  cells, aux = stream_takes(level_hw, pixel_val, pt_views, ctx_c2w,
                            ctx_intr, H, W, dtype, exchange_points)
    level_hw:  the pyramid levels' (H_l, W_l)
    pixel_val: (B*V, R*P, 2) ndc coords of each view's epipolar samples
    pt_views:  (B, V, R, P, 3) the samples' 3D points, in frame v
    ctx_c2w, ctx_intr: (B, V, 4, 4) context poses and pixel intrinsics
    cells:     per level (V*M,) int32, stream-major (M = B*V*R*P)
    aux:       V arrays (M, aux_w) in ``dtype`` (``gather_epilogue.
               aux_layout``): each level's slot weights, tanh(pt/5), zeros

Stream 0 is the self stream (each view's own maps on its segment, border
padding); stream j >= 1 holds, for the rays of every view v, its j-th other
view k in ascending frame order: the sample's 3D point in frame k,
projected with k's intrinsics, on k's maps, zeros padding (JAX
renderer.py:591-655 at V=2, :710-754 at V>=3).

On CUDA tensors :func:`stream_takes` launches the hand-written kernel
``csrc/stream_takes.cu``, one launch a ray block, whose cells equal and
whose aux rows are bit-equal to the plain version's on the card; on CPU
tensors it runs the plain version :func:`stream_takes_reference`. Nothing
differentiates through the address math (its inputs are camera data), so
the kernel refuses inputs that require a gradient under grad mode.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Sequence

import torch

from cross_attention_renderer_torch.geometry import rays as G
from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops.gather_epilogue import aux_layout
from cross_attention_renderer_torch.ops.grid_sample import (
    cell_rows_and_slot_weights)

Tensor = torch.Tensor
ENTRY = {torch.bfloat16: 'stream_takes_bf16',
         torch.float32: 'stream_takes_f32'}
LEVELS = (3, 4)     # the kernel's instantiations: the DPT and 4-level pyramids


def exchange_points(pt_views: Tensor, ctx_c2w: Tensor) -> Tensor:
    """pt_in[:, k, v]: view-v samples expressed in frame k, non-finite
    coordinates zeroed (JAX renderer.py:885-892)."""
    rel = torch.linalg.inv(ctx_c2w)[:, :, None] @ ctx_c2w[:, None]
    pt_in = G.transform_points(pt_views[:, None], rel[:, :, :, None, None])
    return torch.where(torch.isfinite(pt_in), pt_in, torch.zeros_like(pt_in))


def stream_takes_reference(level_hw: Sequence[tuple[int, int]],
                           pixel_val: Tensor, pt_in: Tensor, ctx_intr: Tensor,
                           H: int, W: int, dtype: torch.dtype
                           ) -> tuple[tuple[Tensor, ...], list[Tensor]]:
    """Plain version, on :func:`exchange_points`' ``pt_in``
    (B, K, V, R, P, 3); returns what :func:`stream_takes` does."""
    B, V, _, R, P, _ = pt_in.shape
    M = B * V * R * P
    dev = pt_in.device
    others = [[k for k in range(V) if k != v] for v in range(V)]
    pt_self = torch.stack([pt_in[:, v, v] for v in range(V)], dim=1)
    streams = [(pixel_val.reshape(B * V, R * P, 2), None, 'border', pt_self)]
    row = torch.arange(B * V, dtype=torch.int32, device=dev)[:, None]
    for j in range(V - 1):
        k_of = torch.tensor([others[v][j] for v in range(V)],
                            dtype=torch.int32, device=dev)
        pt_j = torch.stack([pt_in[:, others[v][j], v] for v in range(V)],
                           dim=1)
        intr_j = torch.stack([ctx_intr[:, others[v][j]] for v in range(V)],
                             dim=1)
        proj = G.project_pinhole(pt_j.reshape(B, V, R * P, 3), intr_j)
        pix = G.pixel_to_ndc(proj[..., :2], H, W)
        # image row (b, v) of the coords samples image (b, k_of[v])
        xid = (row // V) * V + k_of[(row % V).long()]
        streams.append((pix.reshape(B * V, R * P, 2), xid, 'zeros', pt_j))

    t_col, aux_w = aux_layout(len(level_hw))  # t_col = 4 * levels (3 or 4)
    pad = torch.zeros((M, aux_w - t_col - 3), dtype=dtype, device=dev)
    cells = [[] for _ in level_hw]
    aux = []
    for coords, xid, mode, pt in streams:
        weights = []
        for l, hw in enumerate(level_hw):
            c, w = cell_rows_and_slot_weights(tuple(hw), coords, mode,
                                              image_id=xid)
            cells[l].append(c.reshape(-1))
            weights.append(w.reshape(M, 4).to(dtype))
        t = torch.tanh(pt.reshape(M, 3) / 5.0).to(dtype)
        aux.append(torch.cat(weights + [t, pad], dim=-1))
    return tuple(torch.cat(c) for c in cells), aux


def stream_takes(level_hw: Sequence[tuple[int, int]], pixel_val: Tensor,
                 pt_views: Tensor, ctx_c2w: Tensor, ctx_intr: Tensor, H: int,
                 W: int, dtype: torch.dtype,
                 points: Callable[[Tensor, Tensor], Tensor] = exchange_points
                 ) -> tuple[tuple[Tensor, ...], list[Tensor]]:
    """Every stream's cell rows and aux rows; see the module docstring.

    CPU tensors take the plain version on ``points(pt_views, ctx_c2w)``
    (:func:`exchange_points`, or the caller's own). CUDA tensors launch
    the kernel: f32 geometry, ``dtype`` bf16 or f32, 3 or 4 levels; the
    relative transforms come from ``torch.linalg.inv_ex``, which gives
    ``inv``'s values without its check on the host. Anything else raises,
    as do inputs that require a gradient under grad mode."""
    if pt_views.device.type == 'cpu':
        return stream_takes_reference(level_hw, pixel_val,
                                      points(pt_views, ctx_c2w), ctx_intr, H,
                                      W, dtype)
    return _launch(level_hw, pixel_val, pt_views, ctx_c2w, ctx_intr, H, W,
                   dtype)


stream_takes.launches = 0   # kernel launches, one a ray block


def _entry(dtype: torch.dtype):
    """The launcher of ``dtype``'s instantiation, its argument types set
    once."""
    fn = getattr(_build.load('stream_takes'), ENTRY[dtype])
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    return fn


def _launch(level_hw, pixel_val, pt_views, ctx_c2w, ctx_intr, H, W, dtype):
    def require(cond, msg):
        if not cond:
            raise ValueError(f'stream_takes: {msg}')

    B, V, R, P, _ = pt_views.shape
    M, L = B * V * R * P, len(level_hw)
    dev = pt_views.device
    inputs = (pixel_val, pt_views, ctx_c2w, ctx_intr)
    require(not (torch.is_grad_enabled()
                 and any(t.requires_grad for t in inputs)),
            'the address math takes no gradient; its inputs require one')
    require(dtype in ENTRY, f'bf16 or f32 aux, got {dtype}')
    require(L in LEVELS, f'{LEVELS} pyramid levels, got {L}')
    require(V >= 2 and M > 0, f'two or more views and samples, got V={V}, '
            f'M={M}')
    for name, t, numel in (('pixel_val', pixel_val, M * 2),
                           ('pt_views', pt_views, M * 3),
                           ('ctx_c2w', ctx_c2w, B * V * 16),
                           ('ctx_intr', ctx_intr, B * V * 16)):
        require(t.device == dev and t.dtype == torch.float32
                and t.numel() == numel,
                f'{name} must be {numel} f32 values on {dev}, got '
                f'{tuple(t.shape)} {t.dtype} on {t.device}')
    intr = ctx_intr.reshape(B, V, 4, 4).contiguous()
    c2w = ctx_c2w.reshape(B, V, 4, 4)
    rel = torch.linalg.inv_ex(c2w).inverse[:, :, None] @ c2w[:, None]
    cells = tuple(torch.empty(V * M, dtype=torch.int32, device=dev)
                  for _ in level_hw)
    aux = torch.empty((V, M, aux_layout(L)[1]), dtype=dtype, device=dev)
    launch_kernel(level_hw, pixel_val.contiguous(), pt_views.contiguous(),
                  rel.contiguous(), intr, cells, aux, H, W)
    stream_takes.launches += 1
    return cells, list(aux)


def launch_kernel(level_hw, pixel_val: Tensor, pt_views: Tensor, rel: Tensor,
                  intr: Tensor, cells: Sequence[Tensor], aux: Tensor, H: int,
                  W: int) -> None:
    """The kernel's launch alone, into ``cells`` and ``aux`` (V, M,
    aux_w), on the checked, contiguous inputs of :func:`stream_takes` and
    the relative transforms ``rel`` (B, V, V, 4, 4): what
    ``chip_smoke.py`` times."""
    B, V = rel.shape[:2]
    M, L = aux.shape[1], len(level_hw)
    hw = (ctypes.c_int * (2 * L))(*[int(n) for h_w in level_hw for n in h_w])
    cell_ptrs = (ctypes.c_void_p * L)(*[c.data_ptr() for c in cells])
    with torch.cuda.device(aux.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(_entry(aux.dtype)(
            pixel_val.data_ptr(), pt_views.data_ptr(), rel.data_ptr(),
            intr.data_ptr(), cell_ptrs, aux.data_ptr(), hw, L, M, B, V,
            M // (B * V), H, W, stream), 'stream_takes')
