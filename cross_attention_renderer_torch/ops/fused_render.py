"""The fully fused V=2 render core (kernel K4): from the cell rows of both
exchange streams to the attention output.

PyTorch port of ``fused_render_core`` of
``cross_attention_renderer_tpu/ops/fused_render.py``. One function runs
everything between the epipolar row takes and the light-field decode of the
V=2 renderer (reference models.py:278-565): the V=2 exchange epilogue of
:func:`~cross_attention_renderer_torch.ops.gather_epilogue.
fused_exchange_epilogue` (combine, both fuse-MLP streams, the per-view
order, the latent and key projections), the query-embedding MLP
(16 -> 128 -> 128), round-1 joint (view, sample) softmax attention and,
with ``repeat``, ``encode_latent``, the repeat-query MLP and round-2
attention. It returns ``z2 + 2 z1`` (or ``z1``) per ray and the round-1
weights; no per-sample intermediate leaves the kernel.

On a CUDA tensor :func:`fused_render_core` launches ``csrc/fused_render.cu``,
which takes the packed tables and the cell rows and fetches the rows itself;
on a CPU tensor it runs the plain version :func:`fused_render_core_reference`
(``index_select`` row take, then :func:`_reference`, which mirrors the JAX
``_reference``). The kernel's gradients are the plain version's,
recomputed (:func:`~cross_attention_renderer_torch.ops._autograd.
kernel_call`), both outputs cast to the rows' type as the JAX ``_bwd``
casts them.

Layout contract: as the V=2 epilogue's (the renderer's (B, V, R, P)
flattening, M = B * 2 * R * P samples): per level (2M,) int32 cell rows,
the self stream's M over the cross stream's; an aux array for each stream
(``gather_epilogue.aux_layout``: (M, 16) for up to three levels, (M, 24)
for four); (M, 16) local coordinates.

Tables are in the model's float type (that of aux) or int8, whose rows are
cast to aux's type and combined in it; every later product then runs in
aux's type (the JAX ``_combine`` and ``_float_dtype``, fused_render.py:
55-72).

params is a 20-tuple of (in, out) kernels and biases: the 10 epilogue
weights of ``gather_epilogue._reference`` (w1, b1, w2, b2, lv, lvb, km,
kmb, k2, k2b), then qe1 (16, K), qe1b, qe2 (K, K), qe2b (``query_embed``
and ``query_embed_2``), el (O, K), elb (``encode_latent``), qr1 (K + 16,
K), qr1b, qr2 (K, K), qr2b (``query_repeat_embed`` and ``_2``). Without
``repeat`` the last six are ignored and may be left out (a 14-tuple).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops._autograd import kernel_call
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.ops.gather_epilogue import (
    _combine, _compute_dtype)

Tensor = torch.Tensor

ATTN_SCALE = 1.0 / 16.0     # models.py:532,555


def _fuse_stream(vals: Sequence[Tensor], aux: Tensor, w1: Tensor, b1: Tensor,
                 w2: Tensor, b2: Tensor) -> Tensor:
    """One stream's fuse MLP, f32 out (JAX ``_fuse_stream``): the combine
    in the compute type, both products with f32 sums."""
    dt = _compute_dtype(vals, aux)
    comb = _combine(vals, aux)
    F = comb.shape[-1]
    t = GE.aux_layout(len(vals))[0]
    h = comb.float() @ w1[:F].to(dt).float()
    for j in range(3):
        h = h + aux[:, t + j:t + j + 1].float() * w1[F + j].float()
    h = torch.relu(h + b1.float())
    return h.to(dt).float() @ w2.to(dt).float() + b2.float()


def _attend(q: Tensor, k: Tensor, v: Tensor, B: int, R: int, P: int
            ) -> tuple[Tensor, Tensor]:
    """Joint (view, sample) softmax over (M, ·) rows: logits in f32, weights
    cast to the value type, f32 sum. Returns (z (B, R, C) in v's type,
    weights (B, 2, R, P) f32)."""
    dots = torch.einsum('md,md->m', q.float(), k.float()) * ATTN_SCALE
    flat = dots.reshape(B, 2, R, P).permute(0, 2, 1, 3).reshape(B, R, 2 * P)
    wt = torch.softmax(flat, dim=-1).reshape(B, R, 2, P).permute(0, 2, 1, 3)
    z = torch.einsum('bvrp,bvrpc->brc', wt.to(v.dtype).float(),
                     v.reshape(B, 2, R, P, -1).float())
    return z.to(v.dtype), wt


def _reference(vals_both: Sequence[Tensor], aux_self: Tensor,
               aux_cross: Tensor, local_coords: Tensor,
               params: Sequence[Tensor], B: int, R: int, P: int,
               repeat: bool) -> tuple[Tensor, Tensor]:
    """The render core's math on taken rows (JAX ``_reference``).

    vals_both: per-level (2M, 4C) rows, self over cross. Fuse outputs stay
    f32 and then take the model type; the other products run in the model
    type. Returns (z (B, R, O) in the compute type, at_wt (B, 2, R, P)
    f32).
    """
    (w1, b1, w2, b2, lv, lvb, km, kmb, k2, k2b,
     qe1, qe1b, qe2, qe2b) = params[:14]
    dt = _compute_dtype(vals_both, aux_self)
    M = B * 2 * R * P
    O = w2.shape[1]
    fs = _fuse_stream([v[:M] for v in vals_both], aux_self, w1, b1, w2, b2)
    fc = _fuse_stream([v[M:] for v in vals_both], aux_cross, w1, b1, w2,
                      b2)
    vid = (torch.arange(M, device=fs.device) // (R * P) % 2)[:, None]
    a = torch.where(vid == 0, fs, fc).to(dt)       # own-view stream first
    b = torch.where(vid == 0, fc, fs).to(dt)
    jl = a @ lv[:O].to(dt) + b @ lv[O:].to(dt) + lvb.to(dt)
    kh = torch.relu(a @ km[:O].to(dt) + b @ km[O:].to(dt) + kmb.to(dt))
    kv = kh @ k2.to(dt) + k2b.to(dt)
    del fs, fc, a, b, kh

    lc = local_coords.to(dt)
    ce = torch.relu(lc @ qe1.to(dt) + qe1b.to(dt)) @ qe2.to(dt) + qe2b.to(dt)
    z1, at_wt = _attend(ce, kv, jl, B, R, P)
    if not repeat:
        return z1, at_wt
    el, elb, qr1, qr1b, qr2, qr2b = params[14:20]
    E = el.shape[1]
    ze = z1 @ el.to(dt) + elb.to(dt)                       # (B, R, E)
    # ze is the same for every sample of a ray, so its product with the
    # z_embed rows of qr1 is taken per ray and broadcast (JAX broadcasts ze
    # first; the rows' products are the same).
    zq = (ze @ qr1[:E].to(dt))[:, None, :, None, :].expand(
        B, 2, R, P, qr1.shape[1]).reshape(M, -1)
    q2 = torch.relu(zq + lc @ qr1[E:].to(dt) + qr1b.to(dt))
    q2 = q2 @ qr2.to(dt) + qr2b.to(dt)
    z2, _ = _attend(q2, ce, jl, B, R, P)
    return z2 + 2.0 * z1, at_wt


def fused_render_core_reference(tables, cells, aux_self, aux_cross,
                                local_coords, params, B, R, P, repeat):
    """Plain version: ``index_select`` row take, then :func:`_reference`;
    both outputs in the compute type (the float tables' type, as the JAX
    wrapper returns them; aux's type for int8 tables, as the TPU kernel
    writes them)."""
    vals_both = [t.reshape(-1, t.shape[-1]).index_select(0, c.long())
                 for t, c in zip(tables, cells)]
    z, at_wt = _reference(vals_both, aux_self, aux_cross, local_coords,
                          params, B, R, P, repeat)
    dt = _compute_dtype(vals_both, aux_self)
    return z.to(dt), at_wt.to(dt)


def fused_render_core(tables: Sequence[Tensor], cells: Sequence[Tensor],
                      aux_self: Tensor, aux_cross: Tensor,
                      local_coords: Tensor, params: Sequence[Tensor], B: int,
                      R: int, P: int, repeat: bool
                      ) -> tuple[Tensor, Tensor]:
    """(z (B, R, O), at_wt (B, 2, R, P)) from packed tables and cell rows.

    Args:
      tables: per-level packed cell tables (N, H_l, W_l, 4 C_l) from
        :func:`~cross_attention_renderer_torch.ops.grid_sample.pack_pyramid`.
      cells: per-level (2M,) int32 rows of the flattened table, the self
        stream's M samples, then the cross stream's.
      aux_self / aux_cross: (M, 16), or (M, 24) with four levels: the slot
        weights, tanh(pt/5) and a pad (``gather_epilogue.aux_layout``).
      local_coords: (M, 16), the per-sample query features.
      params: the 20-tuple of the module docstring.
      B, R, P: batch, rays, samples per view; M = B * 2 * R * P.
      repeat: run round 2 and return ``z2 + 2 z1``; else ``z1``.

    CPU tensors take the plain version. CUDA tensors must be contiguous,
    aux and local_coords bf16 or f32, the tables in their type or int8
    (cells int32; outputs in aux's type), any B, R and P (up to what a
    block's shared memory holds of the ray's 2P logits) and any width (the
    core's padding: ``gather_epilogue`` module docstring; the refusals of
    ``gather_epilogue.check_core_widths`` are capacities); they launch the
    kernel, and anything else raises. The weights are laid out once per
    set of parameter tensors (``gather_epilogue.prepared_render``)."""
    if aux_self.device.type == 'cpu':
        return fused_render_core_reference(tables, cells, aux_self,
                                           aux_cross, local_coords, params,
                                           B, R, P, repeat)
    return kernel_call(_launch, fused_render_core_reference, tables, cells,
                       aux_self, aux_cross, local_coords, params, B, R, P,
                       repeat)


fused_render_core.launches = 0  # kernel launches, for the smoke test
# the last launch's (grid, stage slots, shared bytes, threads a block,
# cluster x, y, z), its plan (gather_epilogue.core_plan) and its widths
fused_render_core.last_launch = None
fused_render_core.last_plan = None
fused_render_core.last_widths = None


def _launch(tables, cells, aux_self, aux_cross, local_coords, params, B, R,
            P, repeat):
    what = 'fused_render_core'
    levels, (M, F, H1, O, K), channels = GE._checked_args(
        what, tables, cells, (aux_self, aux_cross), params[:10])
    (qe1, qe1b, qe2, qe2b) = params[10:14]
    dev, dt = aux_self.device, aux_self.dtype
    shapes = [tuple(qe1.shape) == (16, K), tuple(qe2.shape) == (K, K)]
    if repeat:
        el, elb, qr1, qr1b, qr2, qr2b = params[14:20]
        shapes += [tuple(el.shape) == (O, K),
                   tuple(qr1.shape) == (K + 16, K),
                   tuple(qr2.shape) == (K, K)]
    lc = local_coords
    if (M != B * 2 * R * P or not all(shapes) or lc.device != dev
            or lc.dtype != dt or tuple(lc.shape) != (M, 16)
            or not lc.is_contiguous() or lc.data_ptr() % 16):
        raise ValueError(f'{what}: M = {M} samples must be B*2*R*P with '
                         f'(B, R, P) = {(B, R, P)}, local_coords a '
                         f'contiguous {dt} ({M}, 16) on {dev}, and the '
                         'query weights (16, K), (K, K) and with repeat '
                         '(O, K), (K+16, K), (K, K)')
    GE.check_core_widths(what, 'render', 2, F, H1, O, K, P,
                         levels=len(tables))
    stages, vecs, mats = GE.prepared_render(params, bool(repeat), dev,
                                            channels)
    # The ray's jl and ce rows (and the 'resident' or 'global' plan's
    # tiles), per block of the persistent grid.
    scratch = GE.core_scratch('render', 2, F, H1, O, K, B * R, dev, P,
                              levels=len(tables))
    z = torch.empty((B, R, O), dtype=dt, device=dev)
    at_wt = torch.empty((B, 2, R, P), dtype=dt, device=dev)
    fn = GE.core_entry('fused_render', 'fused_render_core', dt,
                       tables[0].dtype)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2)
    info = (ctypes.c_int * 8)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(len(tables), *levels, aux_self.data_ptr(),
                        aux_cross.data_ptr(), lc.data_ptr(),
                        stages.data_ptr(), stages.numel() * 2,
                        vecs.data_ptr(), mats.data_ptr(),
                        *GE._scratch_args(scratch), z.data_ptr(),
                        at_wt.data_ptr(),
                        B, R, P, F, H1, O, K, int(repeat), info, stream),
                     what)
    GE.record_launch(fused_render_core, info, dict(
        mode='render', S=2, F=F, H1=H1, O=O, K=K, P=P, levels=len(tables)))
    return z, at_wt
