"""Fused V=2 exchange epilogue: everything between the epipolar gather and
the attention stage of the flagship V=2 renderer.

PyTorch port of the V=2 ``fused_exchange_epilogue`` of
``cross_attention_renderer_tpu/ops/gather_epilogue.py``. Per sample and per
stream (self, cross): the bilinear combine of the packed cell rows of three
pyramid levels, the fuse MLP ``relu([feat | tanh(pt/5)] @ W1 + b1) @ W2 +
b2``, then the per-view channel order (view 0: [self, cross], view 1:
[cross, self]) and the ``latent_value`` / ``key_map`` / ``key_map_2``
projections (reference models.py:278-346,491,529).

Unlike the TPU kernel, whose row take ran outside the kernel, the CUDA
kernel (``csrc/gather_epilogue.cu``) takes the packed tables and the cell
rows and fetches the rows itself. The plain version
:func:`fused_exchange_epilogue_reference` does the row take with
``index_select`` and then :func:`_reference`, which mirrors the JAX
``_reference``.

Layout contract (the renderer's (B, V, R, P) flattening): sample m belongs
to view (m // rp) % 2; aux rows pack [12 slot weights (4 per level),
tanh(pt/5) (3), pad], one (M, 16) array per stream.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from cross_attention_renderer_torch.ops import _build

Tensor = torch.Tensor


def _combine(vals: Sequence[Tensor], aux: Tensor) -> Tensor:
    """Bilinear combine of per-level packed rows, in the rows' type."""
    parts = []
    for l, v in enumerate(vals):
        C = v.shape[-1] // 4
        acc = None
        for k in range(4):
            term = (v[:, k * C:(k + 1) * C]
                    * aux[:, l * 4 + k:l * 4 + k + 1].to(v.dtype))
            acc = term if acc is None else acc + term
        parts.append(acc)
    return torch.cat(parts, dim=-1)


def _reference(vals_both: Sequence[Tensor], aux_self: Tensor,
               aux_cross: Tensor, params: Sequence[Tensor], rp: int
               ) -> tuple[Tensor, Tensor]:
    """The epilogue's math on taken rows (JAX ``_reference``).

    vals_both: per-level (2M, 4C) rows, the self stream's M over the cross
    stream's M. params: (w1 (F+3, H1), b1, w2 (H1, O), b2, lv (2O, O), lvb,
    km (2O, K), kmb, k2 (K, K), k2b), kernels in (in, out) layout."""
    (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias) = params
    dt = vals_both[0].dtype
    M = vals_both[0].shape[0] // 2
    O = w2.shape[1]

    def fuse(vals, aux):
        feat = _combine(vals, aux)
        x = torch.cat([feat, aux[:, 12:15].to(dt)], dim=-1)
        h = torch.relu(x @ w1.to(dt) + b1.to(dt))
        return h @ w2.to(dt) + b2.to(dt)

    fs = fuse([v[:M] for v in vals_both], aux_self)
    fc = fuse([v[M:] for v in vals_both], aux_cross)
    vid = (torch.arange(M, device=fs.device) // rp % 2)[:, None]
    a = torch.where(vid == 0, fs, fc)
    b = torch.where(vid == 0, fc, fs)
    jl = a @ lv[:O].to(dt) + b @ lv[O:].to(dt) + lv_bias.to(dt)
    kh = torch.relu(a @ km[:O].to(dt) + b @ km[O:].to(dt) + km_bias.to(dt))
    kv = kh @ k2.to(dt) + k2_bias.to(dt)
    return jl, kv


def fused_exchange_epilogue_reference(tables, cells, aux_self, aux_cross,
                                      params, rp):
    """Plain version: ``index_select`` row take, then :func:`_reference`."""
    vals_both = [t.reshape(-1, t.shape[-1]).index_select(0, c.long())
                 for t, c in zip(tables, cells)]
    return _reference(vals_both, aux_self, aux_cross, params, rp)


def fused_exchange_epilogue(tables: Sequence[Tensor],
                            cells: Sequence[Tensor], aux_self: Tensor,
                            aux_cross: Tensor, params: Sequence[Tensor],
                            rp: int) -> tuple[Tensor, Tensor]:
    """(joint_latent (M, O), key_val (M, K)) from packed tables and cell rows.

    Args:
      tables: per-level packed cell tables (N, H_l, W_l, 4 C_l) from
        :func:`~cross_attention_renderer_torch.ops.grid_sample.pack_pyramid`.
      cells: per-level (2M,) int32 rows of the flattened table: the self
        stream's M samples, then the cross stream's.
      aux_self / aux_cross: (M, 16): 12 slot weights (4 per level), then
        tanh(pt/5) (3), then pad.
      params: as :func:`_reference`.
      rp: R * P, the per-(batch, view) sample count.

    CPU tensors take the plain version. CUDA tensors must be bf16 (cells
    int32) and contiguous; they launch the kernel, and anything else
    raises."""
    if aux_self.device.type == 'cpu':
        return fused_exchange_epilogue_reference(tables, cells, aux_self,
                                                 aux_cross, params, rp)
    return _launch(tables, cells, aux_self, aux_cross, params, rp)


fused_exchange_epilogue.launches = 0  # kernel launches, for the smoke test


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError('fused_exchange_epilogue: ' + msg)


def _launch(tables, cells, aux_self, aux_cross, params, rp):
    (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias) = params
    dev, dt = aux_self.device, torch.bfloat16
    M = aux_self.shape[0]
    channels = [t.shape[-1] // 4 for t in tables]
    F, H1 = sum(channels), w1.shape[1]
    O, K = w2.shape[1], k2.shape[1]
    _require(1 <= len(tables) <= 3 and len(cells) == len(tables),
             'one to three pyramid levels')
    _require(tuple(w1.shape) == (F + 3, H1) and tuple(lv.shape) == (2 * O, O)
             and tuple(km.shape) == (2 * O, K), 'weight shapes')
    for t, c in zip(tables, cells):
        _require(t.device == dev and t.dtype == dt and t.is_contiguous()
                 and t.shape[-1] % 32 == 0 and t.data_ptr() % 16 == 0,
                 f'tables must be contiguous bf16 on {dev}, 4C % 32 == 0')
        _require(c.device == dev and c.dtype == torch.int32
                 and c.is_contiguous() and tuple(c.shape) == (2 * M,),
                 f'cells must be contiguous int32 ({2 * M},) on {dev}')
    for a in (aux_self, aux_cross):
        _require(a.device == dev and a.dtype == dt and a.is_contiguous()
                 and tuple(a.shape) == (M, 16) and a.data_ptr() % 16 == 0,
                 f'aux must be contiguous bf16 ({M}, 16) on {dev}')

    def mat(w):                         # (in, out) -> (out, in) bf16
        return w.to(dev, dt).t().contiguous()

    def vec(b):                         # bf16-rounded values as f32
        return b.to(dev, dt).float().contiguous()

    weights = [mat(w1[:F]), vec(w1[F:F + 3]), vec(b1), mat(w2), vec(b2),
               mat(lv), vec(lv_bias), mat(km), vec(km_bias), mat(k2),
               vec(k2_bias)]
    jl = torch.empty((M, O), dtype=dt, device=dev)
    kv = torch.empty((M, K), dtype=dt, device=dev)

    lib = _build.load('gather_epilogue')
    fn = lib.fused_exchange_epilogue_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_void_p] * 15
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    n = len(tables)
    table_ptrs = (ctypes.c_void_p * n)(*[t.data_ptr() for t in tables])
    cell_ptrs = (ctypes.c_void_p * n)(*[c.data_ptr() for c in cells])
    chans = (ctypes.c_int * n)(*channels)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(n, table_ptrs, cell_ptrs, chans, aux_self.data_ptr(),
                        aux_cross.data_ptr(),
                        *[w.data_ptr() for w in weights], jl.data_ptr(),
                        kv.data_ptr(), M, F, H1, O, K, rp, stream),
                     'fused_exchange_epilogue')
    fused_exchange_epilogue.launches += 1
    return jl, kv
