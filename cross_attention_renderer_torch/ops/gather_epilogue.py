"""Fused exchange epilogues: everything between the epipolar gather and the
attention stage of the flagship renderer, at V=2 (kernel K2) and at V>=3
(kernel K3).

PyTorch port of ``fused_exchange_epilogue`` and
``fused_exchange_epilogue_multi`` of
``cross_attention_renderer_tpu/ops/gather_epilogue.py``. Per sample and per
stream: the bilinear combine of the packed cell rows of three pyramid
levels and the fuse MLP ``relu([feat | tanh(pt/5)] @ W1 + b1) @ W2 + b2``;
then the per-view channel order and the ``latent_value`` / ``key_map`` /
``key_map_2`` projections (reference models.py:278-475,491,529).

* V=2, two streams (self, cross): view 0 orders [self, cross], view 1
  [cross, self].
* V>=3, S = V streams [self, cross_0, cross_1, ...] in that fixed order:
  the renderer builds cross stream j from each view's j-th other view in
  ascending frame order, which is the reference's [self] + ascending-k
  concat.

Unlike the TPU kernels, whose row take ran outside the kernel, the CUDA
kernels (``csrc/gather_epilogue.cu``, ``csrc/gather_epilogue_multi.cu``)
take the packed tables and the cell rows and fetch the rows themselves. The
plain versions do the row take with ``index_select`` and then mirror the
JAX ``_reference`` / ``_reference_multi``.

Layout contract (the renderer's (B, V, R, P) flattening): per level, the
cell rows of all streams stacked stream-major, (S*M,) int32; one (M, 16)
aux array per stream packing [12 slot weights (4 per level), tanh(pt/5)
(3), pad]; at V=2 sample m belongs to view (m // rp) % 2.
"""

from __future__ import annotations

import ctypes
import weakref
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


def _fuse(vals: Sequence[Tensor], aux: Tensor, w1: Tensor, b1: Tensor,
          w2: Tensor, b2: Tensor) -> Tensor:
    """One stream's fuse MLP on its combined rows, in the rows' type."""
    dt = vals[0].dtype
    x = torch.cat([_combine(vals, aux), aux[:, 12:15].to(dt)], dim=-1)
    h = torch.relu(x @ w1.to(dt) + b1.to(dt))
    return h @ w2.to(dt) + b2.to(dt)


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
    fs = _fuse([v[:M] for v in vals_both], aux_self, w1, b1, w2, b2)
    fc = _fuse([v[M:] for v in vals_both], aux_cross, w1, b1, w2, b2)
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
# the last launch's (grid, stage slots, shared bytes, threads a block,
# cluster x, y, z)
fused_exchange_epilogue.last_launch = None


# The kernels' weight stream (csrc/exchange_core.cuh): tiles of 64-deep
# k-blocks, one 128-byte row per output unit.
_KB = 64           # k-values per tile row
_NC = 64           # hidden units per chunk (W1 tiles)
_NO = 96           # output columns per O tile (W2, lv)
_NK = 64           # output columns per K tile (km, k2)
MAX_O, MAX_K = 3 * _NO, 4 * _NK


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _swizzle_index(n_rows: int, shape, device) -> Tensor:
    """Gather index over the 16-byte chunks of (..., n_rows, 8, 8) tiles:
    position p of row r holds chunk p ^ (r % 8) (and, the XOR being its own
    inverse, the same index undoes it)."""
    r = torch.arange(n_rows, device=device) % 8
    src = torch.arange(8, device=device)[None, :] ^ r[:, None]
    return src[:, :, None].expand(*shape)


def _tiles(wt: Tensor, n_rows: int) -> Tensor:
    """(N, D) weight in (out, in) layout -> (ceil(N / n_rows), ceil(D / 64),
    n_rows, 64) tiles, zero-padded, each row's eight 16-byte chunks in the
    128-byte swizzle the kernel's wgmma reads."""
    N, D = wt.shape
    nt, nkb = _cdiv(N, n_rows), _cdiv(D, _KB)
    pad = wt.new_zeros((nt * n_rows, nkb * _KB))
    pad[:N, :D] = wt
    t = pad.reshape(nt, n_rows, nkb, 8, 8).permute(0, 2, 1, 3, 4)
    t = torch.gather(t, 3, _swizzle_index(n_rows, t.shape, wt.device))
    return t.reshape(nt, nkb, n_rows, _KB)


def layout_stages(params: Sequence[Tensor], S: int
                  ) -> tuple[Tensor, Tensor]:
    """The weights as K2 and K3 read them, on the parameters' device.

    Returns (stages, vecs). stages (bf16) is the weight stream of one
    64-sample tile, stage by stage in the kernel's order: one stream's fuse
    MLP (for each 64-unit hidden chunk c, W1[:F, c] by 64-deep k-blocks,
    then W2[c, :] by 96-column tiles), which the kernel replays for each of
    the S streams; then lv (k-blocks of the [f_0 | ...] row, each by
    96-column tiles), km (the same by 64-column tiles) and k2 (64-column
    tiles, each by k-blocks). vecs (f32) is [W1[F:F+3] (3, H1p) | b1 (H1p) |
    b2 | lvb (both O rounded up to 96) | kmb | k2b (both K rounded up to
    64)], zero-padded, H1p being H1 rounded up to 64. Every value is rounded
    to bf16 first, as the kernels read bf16 weights."""
    (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias) = params
    F, H1 = w1.shape[0] - 3, w1.shape[1]
    O, K = w2.shape[1], k2.shape[1]
    bf = torch.bfloat16
    t1 = _tiles(w1[:F].to(bf).t(), _NC)     # (chunks, k-blocks of F, 64, 64)
    t2 = _tiles(w2.to(bf).t(), _NO)         # (O tiles, chunks, 96, 64)
    mlp = [part for c in range(t1.shape[0])
           for part in (t1[c].reshape(-1), t2[:, c].reshape(-1))]
    tail = (_tiles(lv.to(bf).t(), _NO).transpose(0, 1).reshape(-1),
            _tiles(km.to(bf).t(), _NK).transpose(0, 1).reshape(-1),
            _tiles(k2.to(bf).t(), _NK).reshape(-1))
    stages = torch.cat(mlp + list(tail))

    def vec(v, n):
        out = torch.zeros(v.shape[:-1] + (n,), dtype=torch.float32,
                          device=v.device)
        out[..., :v.shape[-1]] = v.to(bf).float()
        return out.reshape(-1)

    H1p, Op, Kp = _cdiv(H1, _NC) * _NC, _cdiv(O, _NO) * _NO, _cdiv(K, _NK) * _NK
    vecs = torch.cat([vec(w1[F:F + 3], H1p), vec(b1, H1p), vec(b2, Op),
                      vec(lv_bias, Op), vec(km_bias, Kp), vec(k2_bias, Kp)])
    return stages, vecs


# Prepared weights by the parameters' identity: {key: (weak references,
# version counters, (stages, vecs))}.
_PREPARED: dict = {}


def prepared_weights(params: Sequence[Tensor], S: int, device
                     ) -> tuple[Tensor, Tensor]:
    """:func:`layout_stages` of ``params`` on ``device``, built once per set
    of parameter tensors: later calls with the same tensors, none of them
    changed in place since (their version counters), reuse it. Inference
    tensors keep no version counter and are laid out on every call."""
    params = tuple(params)
    if any(p.is_inference() for p in params):
        return layout_stages([p.to(device) for p in params], S)
    key = (tuple(id(p) for p in params), S, str(device))
    versions = tuple(p._version for p in params)
    hit = _PREPARED.get(key)
    if (hit is not None and hit[1] == versions
            and all(r() is p for r, p in zip(hit[0], params))):
        return hit[2]
    with torch.no_grad():
        prep = layout_stages([p.detach().to(device) for p in params], S)
    for k in [k for k, v in _PREPARED.items()
              if any(r() is None for r in v[0])]:
        del _PREPARED[k]
    _PREPARED[key] = (tuple(weakref.ref(p) for p in params), versions, prep)
    return prep


def _mat(w, dev):
    """(in, out) weight -> (out, in) bf16 on ``dev``, as K4 reads it."""
    return w.to(dev, torch.bfloat16).t().contiguous()


def _vec(b, dev):
    """bf16-rounded values as f32 on ``dev`` (biases, tanh rows)."""
    return b.to(dev, torch.bfloat16).float().contiguous()


def _checked_args(what, tables, cells, aux, params):
    """Checks the kernels' inputs and packs the launch arguments shared by
    K2, K3 and K4: (level arrays, (M, F, H1, O, K)). Raises ValueError on
    what the kernels do not take."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f'{what}: {msg}')

    (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias) = params
    dev, dt = aux[0].device, torch.bfloat16
    S, M = len(aux), aux[0].shape[0]
    channels = [t.shape[-1] // 4 for t in tables]
    F, H1 = sum(channels), w1.shape[1]
    O, K = w2.shape[1], k2.shape[1]
    require(1 <= len(tables) <= 3 and len(cells) == len(tables),
            'one to three pyramid levels')
    require(tuple(w1.shape) == (F + 3, H1) and tuple(lv.shape) == (S * O, O)
            and tuple(km.shape) == (S * O, K), 'weight shapes')
    for t, c in zip(tables, cells):
        require(t.device == dev and t.dtype == dt and t.is_contiguous()
                and t.shape[-1] % 32 == 0 and t.data_ptr() % 16 == 0,
                f'tables must be contiguous bf16 on {dev}, 4C % 32 == 0')
        require(c.device == dev and c.dtype == torch.int32
                and c.is_contiguous() and tuple(c.shape) == (S * M,),
                f'cells must be contiguous int32 ({S * M},) on {dev}')
    for a in aux:
        require(a.device == dev and a.dtype == dt and a.is_contiguous()
                and tuple(a.shape) == (M, 16) and a.data_ptr() % 16 == 0,
                f'aux must be contiguous bf16 ({M}, 16) on {dev}')
    n = len(tables)
    levels = ((ctypes.c_void_p * n)(*[t.data_ptr() for t in tables]),
              (ctypes.c_void_p * n)(*[c.data_ptr() for c in cells]),
              (ctypes.c_int * n)(*channels))
    return levels, (M, F, H1, O, K)


def _core_args(what, tables, cells, aux, params):
    """:func:`_checked_args` for K2 and K3, whose core also needs O <= 288
    and K <= 256 (its accumulators live in registers), and their prepared
    weights: (levels, sizes, stages, vecs)."""
    levels, sizes = _checked_args(what, tables, cells, aux, params)
    O, K = sizes[3], sizes[4]
    if O > MAX_O or K > MAX_K:
        raise ValueError(f'{what}: O <= {MAX_O} and K <= {MAX_K}, got O={O}, '
                         f'K={K}')
    stages, vecs = prepared_weights(params, len(aux), aux[0].device)
    return levels, sizes, stages, vecs


def _outputs(aux, sizes):
    """Empty (jl (M, O), kv (M, K)) bf16 for K2 and K3."""
    M, _, _, O, K = sizes
    return (torch.empty((M, O), dtype=torch.bfloat16, device=aux.device),
            torch.empty((M, K), dtype=torch.bfloat16, device=aux.device))


def _launch(tables, cells, aux_self, aux_cross, params, rp):
    levels, sizes, stages, vecs = _core_args(
        'fused_exchange_epilogue', tables, cells, (aux_self, aux_cross),
        params)
    jl, kv = _outputs(aux_self, sizes)
    fn = _build.load('gather_epilogue').fused_exchange_epilogue_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    info = (ctypes.c_int * 7)()
    with torch.cuda.device(jl.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(len(tables), *levels, aux_self.data_ptr(),
                        aux_cross.data_ptr(), stages.data_ptr(),
                        stages.numel() * 2, vecs.data_ptr(), jl.data_ptr(),
                        kv.data_ptr(), *sizes, rp, info, stream),
                     'fused_exchange_epilogue')
    fused_exchange_epilogue.launches += 1
    fused_exchange_epilogue.last_launch = tuple(info)
    return jl, kv


# ---------------------------------------------------------------------------
# V>=3: S streams in the fixed [self, cross_0, cross_1, ...] order (K3)
# ---------------------------------------------------------------------------

def _reference_multi(vals_stacked: Sequence[Tensor],
                     aux_list: Sequence[Tensor], params: Sequence[Tensor]
                     ) -> tuple[Tensor, Tensor]:
    """The S-stream epilogue's math on taken rows (JAX ``_reference_multi``).

    vals_stacked: per-level (S*M, 4C) rows, stream-major. aux_list: S
    arrays (M, 16). params: as :func:`_reference`, with lv (S*O, O) and
    km (S*O, K). Each stream's products round to the rows' type, as in the
    JAX reference."""
    (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias) = params
    S = len(aux_list)
    dt = vals_stacked[0].dtype
    M = vals_stacked[0].shape[0] // S
    O = w2.shape[1]
    jl = lv_bias.to(dt)
    kh = km_bias.to(dt)
    for s in range(S):
        f = _fuse([v[s * M:(s + 1) * M] for v in vals_stacked], aux_list[s],
                  w1, b1, w2, b2)
        jl = jl + f @ lv[s * O:(s + 1) * O].to(dt)
        kh = kh + f @ km[s * O:(s + 1) * O].to(dt)
    kv = torch.relu(kh) @ k2.to(dt) + k2_bias.to(dt)
    return jl, kv


def fused_exchange_epilogue_multi_reference(tables, cells, aux_list, params):
    """Plain version: ``index_select`` row take, then
    :func:`_reference_multi`."""
    vals = [t.reshape(-1, t.shape[-1]).index_select(0, c.long())
            for t, c in zip(tables, cells)]
    return _reference_multi(vals, aux_list, params)


def fused_exchange_epilogue_multi(tables: Sequence[Tensor],
                                  cells: Sequence[Tensor],
                                  aux_list: Sequence[Tensor],
                                  params: Sequence[Tensor]
                                  ) -> tuple[Tensor, Tensor]:
    """(joint_latent (M, O), key_val (M, K)) of S exchange streams.

    Args:
      tables: per-level packed cell tables, as for
        :func:`fused_exchange_epilogue`.
      cells: per-level (S*M,) int32 rows of the flattened table, stream-major
        ([self | cross_0 | cross_1 | ...]).
      aux_list: S arrays (M, 16), one per stream, laid out as the aux of
        :func:`fused_exchange_epilogue`.
      params: as :func:`_reference_multi`.

    CPU tensors take the plain version. CUDA tensors must be bf16 (cells
    int32) and contiguous, with 2 to 4 streams; they launch the kernel, and
    anything else raises."""
    if aux_list[0].device.type == 'cpu':
        return fused_exchange_epilogue_multi_reference(tables, cells,
                                                       aux_list, params)
    return _launch_multi(tables, cells, aux_list, params)


fused_exchange_epilogue_multi.launches = 0  # kernel launches
fused_exchange_epilogue_multi.last_launch = None


def _launch_multi(tables, cells, aux_list, params):
    S = len(aux_list)
    if not 2 <= S <= 4:
        raise ValueError(f'fused_exchange_epilogue_multi: 2 to 4 streams, '
                         f'got {S}')
    levels, sizes, stages, vecs = _core_args(
        'fused_exchange_epilogue_multi', tables, cells, aux_list, params)
    jl, kv = _outputs(aux_list[0], sizes)
    fn = _build.load(
        'gather_epilogue_multi').fused_exchange_epilogue_multi_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2)
    aux_ptrs = (ctypes.c_void_p * S)(*[a.data_ptr() for a in aux_list])
    info = (ctypes.c_int * 7)()
    with torch.cuda.device(jl.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(len(tables), *levels, S, aux_ptrs, stages.data_ptr(),
                        stages.numel() * 2, vecs.data_ptr(), jl.data_ptr(),
                        kv.data_ptr(), *sizes, info, stream),
                     'fused_exchange_epilogue_multi')
    fused_exchange_epilogue_multi.launches += 1
    fused_exchange_epilogue_multi.last_launch = tuple(info)
    return jl, kv
