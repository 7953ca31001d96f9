"""Fused exchange epilogues: everything between the epipolar gather and the
attention stage of the flagship renderer, at V=2 (kernel K2) and at V>=3
(kernel K3).

PyTorch port of ``fused_exchange_epilogue`` and
``fused_exchange_epilogue_multi`` of
``cross_attention_renderer_tpu/ops/gather_epilogue.py``. Per sample and per
stream: the bilinear combine of the packed cell rows of the pyramid's
levels (three for the DPT encoder, four for the ResNet34 and U-Net ones)
and the fuse MLP ``relu([feat | tanh(pt/5)] @ W1 + b1) @ W2 + b2``;
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
JAX ``_reference`` / ``_reference_multi``. The kernels' gradients are the
plain versions', recomputed (:func:`~cross_attention_renderer_torch.ops.
_autograd.kernel_call`): they reach the packed tables, and through
``pack_pyramid`` the encoder, as the JAX ``custom_vjp``s' reach the taken
rows.

Layout contract (the renderer's (B, V, R, P) flattening): per level, the
cell rows of all streams stacked stream-major, (S*M,) int32; one aux array
per stream (:func:`aux_layout`): 4 slot weights a level, tanh(pt/5) (3)
and a pad, (M, 16) for up to three levels and (M, 24) for four; at V=2
sample m belongs to view (m // rp) % 2. K3 reads its S aux arrays as one
stream-major (S*M, aux_w) tensor, like the cell rows, so that a launch
takes any stream count: its wrapper concatenates them.

With four levels the epilogues compute the JAX package's unfused exchange
(``_latent_exchange_parts`` then ``latent_value``, ``key_map``,
``key_map_2`` at V=2; ``_latent_exchange`` at V>=3), which is the
reference's math (models.py:335-346). The JAX fused epilogues read
tanh(pt/5) at aux columns 12-14 whatever the level count, which with four
levels are level 3's slot weights (ROADMAP.md Queue C, kept divergences).

Widths: any, as the TPU kernels take (ROADMAP.md Queue C 21). The CUDA
core reads a level's table in 16-byte chunks of 8 channels and keeps the
f rows of the S streams side by side in 16-deep product steps; where a
level's C is not a multiple of 8 its table is read from a copy
zero-padded to :func:`table_width` (``grid_sample.pad_cells``, in the
launch), and where O does not tile the f rows they are
:func:`core_out_width` wide. The weights are laid out for those widths,
zeros in the extra rows and columns (:func:`pad_exchange_weights`), once
per parameter set; the kernels write exactly O columns of jl. The plain
versions, and so the recomputed backward, see the original shapes.

Tables are in the model's float type (bf16 or f32, that of aux) or int8
(the quantized pyramid of fast evaluation, ``train/evaluation.py``
``quantize_pyramid``, whose scales the caller folds into W1). int8 rows are
cast to aux's type and combined in it, and every later product runs in it
(the JAX ``_combine`` and ``_compute_dtype``, gather_epilogue.py:54-79).
"""

from __future__ import annotations

import ctypes
import weakref
from typing import NamedTuple, Sequence

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops._autograd import kernel_call
from cross_attention_renderer_torch.ops.grid_sample import pad_cells

Tensor = torch.Tensor


MAX_LEVELS = 4     # the ResNet34 and U-Net pyramids; the DPT one has 3


def aux_layout(n_levels: int) -> tuple[int, int]:
    """(column of tanh(pt/5), width) of an aux row for a pyramid of
    ``n_levels`` levels: the 4 slot weights of level l in columns
    4l .. 4l+3, tanh(pt/5) from column 4 * max(n_levels, 3), zeros to a
    multiple of 8 columns: (12, 16) up to three levels, (16, 24) with
    four."""
    t = 4 * max(n_levels, 3)
    return t, _cdiv(t + 3, 8) * 8


def _compute_dtype(vals: Sequence[Tensor], aux: Tensor) -> torch.dtype:
    """The type the epilogue computes in: the rows' float type, or aux's
    for int8 rows."""
    dt = vals[0].dtype
    return dt if dt.is_floating_point else aux.dtype


def _combine(vals: Sequence[Tensor], aux: Tensor) -> Tensor:
    """Bilinear combine of per-level packed rows, in the rows' float type;
    int8 rows are cast to aux's type and combined in it."""
    parts = []
    for l, v in enumerate(vals):
        cdt = _compute_dtype((v,), aux)
        C = v.shape[-1] // 4
        acc = None
        for k in range(4):
            term = (v[:, k * C:(k + 1) * C].to(cdt)
                    * aux[:, l * 4 + k:l * 4 + k + 1].to(cdt))
            acc = term if acc is None else acc + term
        parts.append(acc)
    return torch.cat(parts, dim=-1)


def _fuse(vals: Sequence[Tensor], aux: Tensor, w1: Tensor, b1: Tensor,
          w2: Tensor, b2: Tensor) -> Tensor:
    """One stream's fuse MLP on its combined rows, in the compute type."""
    dt = _compute_dtype(vals, aux)
    t = aux_layout(len(vals))[0]
    x = torch.cat([_combine(vals, aux), aux[:, t:t + 3].to(dt)], dim=-1)
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
    dt = _compute_dtype(vals_both, aux_self)
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
      aux_self / aux_cross: (M, 16), or (M, 24) with four levels: the slot
        weights, tanh(pt/5) and a pad (:func:`aux_layout`).
      params: as :func:`_reference`.
      rp: R * P, the per-(batch, view) sample count.

    CPU tensors take the plain version. CUDA tensors must be contiguous,
    aux bf16 or f32 and the tables in aux's type or int8 (cells int32);
    they launch the kernel's instantiation of those types
    (``csrc/exchange_core.cuh``, "Element types" and "Table types"), which
    writes its outputs in aux's type, and anything else raises."""
    if aux_self.device.type == 'cpu':
        return fused_exchange_epilogue_reference(tables, cells, aux_self,
                                                 aux_cross, params, rp)
    return kernel_call(_launch, fused_exchange_epilogue_reference, tables,
                       cells, aux_self, aux_cross, params, rp)


fused_exchange_epilogue.launches = 0  # kernel launches, for the smoke test
# the last launch's (grid, stage slots, shared bytes, threads a block,
# cluster x, y, z), its plan ('smem', 'resident' or 'global', see
# core_plan) and its core_plan arguments
fused_exchange_epilogue.last_launch = None
fused_exchange_epilogue.last_plan = None
fused_exchange_epilogue.last_widths = None


def record_launch(wrapper, info, widths: dict) -> None:
    """Counts a launch of an exchange-core kernel and keeps its shape and
    plan from the launcher's 8 ints, and the widths it was launched at
    (``widths``: :func:`core_plan`'s arguments), whose plan and slots
    :func:`core_plan` mirrors."""
    wrapper.launches += 1
    wrapper.last_launch = tuple(info)[:7]
    wrapper.last_plan = PLANS[info[7]]
    wrapper.last_widths = widths


# The kernels' weight stream (csrc/exchange_core.cuh): tiles of 64-deep
# k-blocks, one 128-byte row per output unit.
_KB = 64           # k-values per tile row
_NC = 64           # hidden units per chunk (W1 tiles)
_NO = 96           # output columns per O tile (W2, lv)
_NK = 64           # output columns per K tile (km, k2, query MLPs)
MAX_K = 4 * _NK    # kh stays in registers
SMEM_LIMIT = 232_448   # bytes of shared memory a block may use (H100)
_KB_BYTES = 64 * 128       # a (64, 64) bf16 tile: comb's and the f rows'
_STAGE_BYTES = _NO * 128   # a stage slot (the largest stage)
MAX_STAGES = 8     # stage slots of both rings (kMaxStages)
MIN_STAGES = 6     # the least a plan takes: three a ring (kMinStages)
MIN_STAGES_MLP = 2     # K9's: one a ring, its 'smem' plan's rule
PLANS = ('smem', 'global', 'resident')   # by launch_core's plan number


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def table_width(C: int) -> int:
    """The channels a level of C channels is read at by the core: C
    rounded up to a multiple of 8 (a 16-byte chunk of bf16)."""
    return _cdiv(C, 8) * 8


def core_out_width(mode: str, S: int, O: int) -> int:
    """The width of the core's f rows for output width O with S streams
    (``exchange_core.cuh`` fill_sizes): O itself where S such rows tile the
    16-deep product steps and the 8-column chunks (O % 8 == 0 and S * O %
    16 == 0, every width of the flagship) and in K9 ('mlp', which keeps no
    f rows), else O rounded up to a multiple of 16."""
    if mode == 'mlp' or (O % 8 == 0 and (S * O) % 16 == 0):
        return O
    return _cdiv(O, 16) * 16


def pad_exchange_weights(params: Sequence[Tensor], S: int,
                         channels: Sequence[int] | None, O_core: int
                         ) -> tuple[Tensor, ...]:
    """The ten epilogue weights (as :func:`_reference`) for tables whose
    levels are :func:`table_width` wide and f rows ``O_core`` wide: zero
    rows in w1 after each level's ``channels[l]`` rows, zero columns in w2
    and b2 past O, and per stream zero rows in lv and km (lv's extra
    columns and lvb's zero too). The padded channels and columns are zeros
    on the way in, so the function is the same. Returns ``params`` itself
    where nothing needs padding (``channels`` None: the tables' widths are
    taken as they are)."""
    (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias) = params
    pad_f = channels is not None and any(c % 8 for c in channels)
    O = w2.shape[1]
    if not pad_f and O_core == O:
        return tuple(params)
    if pad_f:
        parts, off = [], 0
        for c in channels:
            parts.append(w1[off:off + c])
            if table_width(c) > c:
                parts.append(w1.new_zeros(table_width(c) - c, w1.shape[1]))
            off += c
        w1 = torch.cat(parts + [w1[off:]])
    if O_core != O:
        d = O_core - O
        pad = torch.nn.functional.pad
        w2, b2 = pad(w2, (0, d)), pad(b2, (0, d))
        lv_bias = pad(lv_bias, (0, d))
        lv = pad(lv.reshape(S, O, O), (0, d, 0, d)).reshape(S * O_core, O_core)
        km = pad(km.reshape(S, O, -1), (0, 0, 0, d)).reshape(S * O_core, -1)
    return (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias)


def _padded_render(params: Sequence[Tensor], channels: Sequence[int] | None
                   ) -> tuple[Tensor, ...]:
    """K4's 14 or 20 parameters padded as :func:`pad_exchange_weights` pads
    the first ten at S = 2, and el's rows to the f width."""
    O = params[2].shape[1]
    O_core = core_out_width('render', 2, O)
    out = pad_exchange_weights(params[:10], 2, channels, O_core)
    rest = tuple(params[10:])
    if len(rest) > 4 and O_core != O:
        rest = rest[:4] + (torch.nn.functional.pad(
            rest[4], (0, 0, 0, O_core - O)),) + rest[5:]
    return tuple(out) + rest


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


def _mlp_stages(w1: Tensor, w2: Tensor) -> list[Tensor]:
    """One stream's fuse MLP, W1 (F, H1) and W2 (H1, O) in (in, out) layout:
    for each 64-unit hidden chunk c, W1[:, c] by 64-deep k-blocks, then
    W2[c, :] by 96-column tiles."""
    bf = torch.bfloat16
    t1 = _tiles(w1.to(bf).t(), _NC)     # (chunks, k-blocks of F, 64, 64)
    t2 = _tiles(w2.to(bf).t(), _NO)     # (O tiles, chunks, 96, 64)
    return [part for c in range(t1.shape[0])
            for part in (t1[c].reshape(-1), t2[:, c].reshape(-1))]


def _query_stages(w1: Tensor, w2: Tensor) -> list[Tensor]:
    """A 16 -> K -> K query MLP in (in, out) layout: the first layer's
    64-column tiles (one k-block, 16 of its 64 k-values live), then the
    second's 64-column tiles, each by k-blocks."""
    bf = torch.bfloat16
    return [_tiles(w1.to(bf).t(), _NK).reshape(-1),
            _tiles(w2.to(bf).t(), _NK).reshape(-1)]


def _vecs(parts, rounded: bool = True) -> Tensor:
    """(vector, padded length) pairs as one zero-padded f32 stream; each
    value rounded to bf16 first where ``rounded``, as the kernels read it."""
    out = []
    for v, n in parts:
        pad = torch.zeros(v.shape[:-1] + (n,), dtype=torch.float32,
                          device=v.device)
        pad[..., :v.shape[-1]] = v.to(torch.bfloat16).float() if rounded \
            else v.float()
        out.append(pad.reshape(-1))
    return torch.cat(out)


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
    tail = (_tiles(lv.to(bf).t(), _NO).transpose(0, 1).reshape(-1),
            _tiles(km.to(bf).t(), _NK).transpose(0, 1).reshape(-1),
            _tiles(k2.to(bf).t(), _NK).reshape(-1))
    stages = torch.cat(_mlp_stages(w1[:F], w2) + list(tail))
    H1p, Op, Kp = _cdiv(H1, _NC) * _NC, _cdiv(O, _NO) * _NO, _cdiv(K, _NK) * _NK
    vecs = _vecs([(w1[F:F + 3], H1p), (b1, H1p), (b2, Op), (lv_bias, Op),
                  (km_bias, Kp), (k2_bias, Kp)])
    return stages, vecs


def layout_mlp(w1a: Tensor, w1b: Tensor, b1: Tensor, w2: Tensor, b2: Tensor
               ) -> tuple[Tensor, Tensor]:
    """The weights as K9 reads them: (stages, vecs). stages is the fuse-MLP
    part of :func:`layout_stages` for W1 = w1a; vecs (f32) is [w1b (3, H1p)
    rounded to bf16 | b1 (H1p) | b2 (O rounded up to 96)], the biases kept
    in f32 as the TPU kernel keeps them."""
    H1, O = w1a.shape[1], w2.shape[1]
    H1p, Op = _cdiv(H1, _NC) * _NC, _cdiv(O, _NO) * _NO
    vecs = torch.cat([_vecs([(w1b, H1p)]),
                      _vecs([(b1, H1p), (b2, Op)], rounded=False)])
    return torch.cat(_mlp_stages(w1a, w2)), vecs


def layout_render(params: Sequence[Tensor], repeat: bool
                  ) -> tuple[Tensor, Tensor, Tensor]:
    """The weights as K4 reads them: (stages, vecs, mats).

    params: K4's (the 10 epilogue weights, qe1, qe1b, qe2, qe2b, and with
    ``repeat`` el, elb, qr1, qr1b, qr2, qr2b). stages: :func:`layout_stages`'
    stream, then the query MLP (qe1, qe2) and with ``repeat`` the repeat
    MLP's local-coordinate half (qr1[K:], qr2), as :func:`_query_stages`.
    vecs: :func:`layout_stages`' vectors, then [qe1b | qe2b | elb | qr1b |
    qr2b], each K rounded up to 64 (zeros without ``repeat``). mats: the
    per-ray products' matrices [el (O, K) | qr1[:K] (K, K)] in bf16, (in,
    out) layout (one zero without ``repeat``). All rounded to bf16."""
    stages, vecs = layout_stages(params[:10], 2)
    qe1, qe1b, qe2, qe2b = params[10:14]
    K = qe2.shape[1]
    Kp = _cdiv(K, _NK) * _NK
    parts = [stages] + _query_stages(qe1, qe2)
    if repeat:
        el, elb, qr1, qr1b, qr2, qr2b = params[14:20]
        parts += _query_stages(qr1[K:], qr2)
        mats = torch.cat([el.to(torch.bfloat16).reshape(-1),
                          qr1[:K].to(torch.bfloat16).reshape(-1)])
        q_vecs = (qe1b, qe2b, elb, qr1b, qr2b)
    else:
        zero = qe1b.new_zeros(K)
        mats = torch.zeros(8, dtype=torch.bfloat16, device=qe1b.device)
        q_vecs = (qe1b, qe2b, zero, zero, zero)
    vecs = torch.cat([vecs, _vecs([(v, Kp) for v in q_vecs])])
    return torch.cat(parts), vecs, mats


# Prepared weights by the parameters' identity: {key: (weak references,
# version counters, prepared tensors)}.
_PREPARED: dict = {}


def _forget_prepared(optimizer, args, kwargs) -> None:
    """Empties the cache after every optimizer step: a fused step
    (``torch.optim.Adam(fused=True)``) rewrites the parameters without
    bumping their version counters."""
    _PREPARED.clear()


register_optimizer_step_post_hook(_forget_prepared)


def _identity(t: Tensor):
    """(the tensor a view was taken of, or t itself; t's place in it)."""
    base = t._base if t._base is not None else t
    return base, (id(base), t.storage_offset(), tuple(t.shape),
                  tuple(t.stride()), t.dtype)


def _prepared(tag, params: Sequence[Tensor], device, build):
    """``build`` of ``params`` on ``device``, once per set of parameter
    tensors (or views of them, such as a slice of one): later calls with
    the same tensors, none of them changed in place since (their version
    counters) and no optimizer step taken since, reuse it. Inference tensors keep no version counter and are
    laid out on every call."""
    params = tuple(params)
    if any(p.is_inference() for p in params):
        return build([p.to(device) for p in params])
    bases, places = zip(*(_identity(p) for p in params))
    key = (tag, places, str(device))
    versions = tuple(p._version for p in params)
    hit = _PREPARED.get(key)
    if (hit is not None and hit[1] == versions
            and all(r() is b for r, b in zip(hit[0], bases))):
        return hit[2]
    with torch.no_grad():
        prep = build([p.detach().to(device) for p in params])
    for k in [k for k, v in _PREPARED.items()
              if any(r() is None for r in v[0])]:
        del _PREPARED[k]
    _PREPARED[key] = (tuple(weakref.ref(b) for b in bases), versions, prep)
    return prep


def _padding_key(channels: Sequence[int] | None) -> tuple | None:
    """The levels' channels where one needs padding, else None (so that
    aligned widths keep their layout cache entries)."""
    if channels is None or not any(c % 8 for c in channels):
        return None
    return tuple(channels)


def prepared_weights(params: Sequence[Tensor], S: int, device,
                     channels: Sequence[int] | None = None
                     ) -> tuple[Tensor, Tensor]:
    """:func:`layout_stages` of ``params`` on ``device``, built once per set
    of parameter tensors (:func:`_prepared`), for tables of ``channels``
    (the levels' C; None: as wide as w1 says) and padded to the widths the
    core reads (:func:`pad_exchange_weights`)."""
    O_core = core_out_width('streams', S, params[2].shape[1])
    key = _padding_key(channels)
    return _prepared(('exchange', S, key), params, device,
                     lambda p: layout_stages(
                         pad_exchange_weights(p, S, key, O_core), S))


def prepared_mlp(params: Sequence[Tensor], device) -> tuple[Tensor, Tensor]:
    """:func:`layout_mlp` of (w1a, w1b, b1, w2, b2), once per set."""
    return _prepared('mlp', params, device, lambda p: layout_mlp(*p))


def prepared_render(params: Sequence[Tensor], repeat: bool, device,
                    channels: Sequence[int] | None = None
                    ) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`layout_render` of K4's parameters (14, or 20 with
    ``repeat``), once per set, padded as :func:`prepared_weights` pads
    them (and el's rows to the f width)."""
    params = tuple(params)[:20 if repeat else 14]
    key = _padding_key(channels)
    return _prepared(('render', repeat, key), params, device,
                     lambda p: layout_render(_padded_render(p, key), repeat))


class CorePlan(NamedTuple):
    """The exchange core's launch for some widths (:func:`core_plan`)."""
    plan: str       # 'smem', 'resident' or 'global'
    smem: int       # bytes of shared memory a block with two stage slots
    scratch: int    # bytes of device-memory scratch a block
    slots: int      # weight stage slots a ring (0: the widths do not fit)


def core_plan(mode: str, S: int, F: int, H1: int, O: int, K: int,
              P: int = 0, force: str | None = None, levels: int = 3
              ) -> CorePlan:
    """The exchange core's plan for these widths, in mode 'pair' (K2),
    'streams' (K3), 'mlp' (K9) or 'render' (K4, P samples a view), with
    ``levels`` pyramid levels (K9: 3, it has none); mirrors
    ``launch_core``: the first plan whose tiles fit beside
    :data:`MIN_STAGES` stage slots (three a ring; K9
    :data:`MIN_STAGES_MLP`), as many slots as then fit, up to
    :data:`MAX_STAGES`. ``force='global'`` gives the 'global'
    plan's layout at any width (for a core built to take that plan
    everywhere, as ``epilogue_ablation.py`` builds one).

    'smem' keeps comb and the f rows in shared memory (the flagship's
    widths, K3 to S = 3); 'resident' keeps comb there and puts the f rows
    in the scratch, in the register A operand's fragment order (K3 from S
    = 4 at the flagship's widths, the U-Net's; not K9, whose tiles are
    comb alone: it keeps 'smem' down to one slot a ring, as before the
    'resident' plan, its 'global' plan being 1.8x slower at
    fusion_features 512); 'global', where even comb does not fit beside
    the slots, puts comb there too and keeps one 8 KB k-block (K4: its
    per-ray sums) in shared memory.

    Widths as the wrappers pass them: F the levels' channel sum, each level
    at :func:`table_width` (K9: its input width, rounded up to 8 here), O
    the output width (the f rows' :func:`core_out_width` here), any H1."""
    F = table_width(F)
    O = core_out_width(mode, S, O)
    nkbF, OT = _cdiv(F, _KB), _cdiv(O, _NO)
    KT = 0 if mode == 'mlp' else _cdiv(K, _NK)
    nkbf = 0 if mode == 'mlp' else _cdiv(S * O, _KB)
    nkb_fbuf = nkbf
    if mode in ('streams', 'render') and OT <= 6:
        nkb_fbuf = _cdiv((S - 1) * O, _KB)
        if nkbf - nkb_fbuf > nkbF:
            nkb_fbuf = nkbf
    ldv = _cdiv(H1, _NC) * _NC
    n_vecs = 4 * ldv + OT * _NO
    if mode != 'mlp':
        n_vecs += OT * _NO + 2 * KT * _NK
    n_rsm, red, scratch = 0, 0, 0
    if mode == 'render':
        n_vecs += 5 * KT * _NK
        n_rsm = (2 * P + 3) // 4 * 4 + 2 * OT * _NO + 2 * KT * _NK + 32
        red = 32 * max(OT * _NO, KT * _NK)
        scratch = 2 * P * (O + K) * 2
    nkb_red = _cdiv(red, _KB_BYTES)
    # the tile's aux rows and cell rows (aux_layout), the vectors, K4's
    # per-ray vectors, the slots' barriers
    common = (1024 + 64 * aux_layout(levels)[1] * 2 + 64 * max(levels, 3) * 4
              + n_vecs * (4 if mode == 'mlp' else 2) + n_rsm * 4
              + 16 * MAX_STAGES)

    def stages(nkb):    # the slots beside nkb k-blocks of tiles
        free = SMEM_LIMIT - common - nkb * _KB_BYTES
        return min(MAX_STAGES, max(free, 0) // _STAGE_BYTES // 2 * 2)

    least = MIN_STAGES_MLP if mode == 'mlp' else MIN_STAGES

    def fits(nkb):
        return nkb >= nkb_red and stages(nkb) >= least

    plan, nkb = 'smem', nkbF + nkb_fbuf
    if force == 'global' or not fits(nkb):
        plan, nkb = 'resident', max(nkbF, nkb_red)
        scratch += nkbf * _KB_BYTES
    if plan == 'resident' and (force == 'global' or mode == 'mlp'
                               or not fits(nkb)):
        plan, nkb = 'global', max(1, nkb_red)
        scratch += nkbF * _KB_BYTES
    n = stages(nkb)
    return CorePlan(plan, common + nkb * _KB_BYTES + 2 * _STAGE_BYTES,
                    scratch, n // 2 if n >= 2 else 0)


def check_core_widths(what: str, mode: str, S: int, F: int, H1: int, O: int,
                      K: int, P: int = 0, levels: int = 3) -> None:
    """Raises ValueError on widths the exchange core does not take, which
    are capacities only (any F, H1 and O are taken, padded as
    :func:`core_plan` says): K above 256 (the attention width, 128 in both
    packages and not configurable), and vectors too long for shared memory
    even in the 'global' plan (H1 in the tens of thousands, or K4's P in
    the thousands)."""
    if mode != 'mlp' and K > MAX_K:
        raise ValueError(f'{what}: K = {K} > {MAX_K}: K is the attention '
                         'width (HIDDEN_DIM, 128 in both packages and not '
                         'configurable), and the core keeps its hidden '
                         'layer kh in registers')
    need = core_plan(mode, S, F, H1, O, K, P, levels=levels)[1]
    if need > SMEM_LIMIT:
        raise ValueError(
            f'{what}: even with its tiles in device memory the core needs '
            f'{need} bytes of shared memory a block at S = {S}, F = {F}, '
            f'H1 = {H1}, O = {O}, K = {K}, P = {P}, {levels} levels, more '
            f'than {SMEM_LIMIT}: its vectors (8-16 bytes a hidden unit) and '
            'K4\'s per-ray logits (8 P bytes) stay there')


def core_scratch(mode: str, S: int, F: int, H1: int, O: int, K: int,
                 n_units: int, device, P: int = 0, levels: int = 3
                 ) -> Tensor | None:
    """The device-memory scratch a launch of the core needs (the
    'resident' and 'global' plans' tiles, K4's ray rows), for the
    persistent grid of min(n_units, SMs) blocks; None where it needs
    none."""
    per_block = core_plan(mode, S, F, H1, O, K, P, levels=levels)[2]
    if per_block == 0:
        return None
    grid = min(n_units,
               torch.cuda.get_device_properties(device).multi_processor_count)
    return torch.empty(grid * per_block, dtype=torch.uint8, device=device)


def _scratch_args(scratch: Tensor | None) -> tuple[int | None, int]:
    """(pointer, bytes) of a scratch for the C interface."""
    if scratch is None:
        return None, 0
    return scratch.data_ptr(), scratch.numel()


# The element types the exchange core is instantiated for, and the suffix
# of their entry points.
CORE_TYPES = {torch.bfloat16: 'bf16', torch.float32: 'f32'}


def core_entry(lib: str, name: str, dtype: torch.dtype,
               table_dtype: torch.dtype | None = None, O: int = 0):
    """Entry point ``name`` of kernel library ``lib`` for inputs of
    ``dtype`` (``<name>_bf16`` or ``<name>_f32``), or for int8 tables
    beside them (``table_dtype`` int8: ``<name>_i8_bf16``,
    ``<name>_i8_f32``); from the library's odd-width build where the output
    width ``O`` is odd (``_build.VARIANTS``; K2, K3, K9)."""
    i8 = 'i8_' if table_dtype == torch.int8 else ''
    lib = f'{lib}_odd' if O % 2 else lib
    return getattr(_build.load(lib), f'{name}_{i8}{CORE_TYPES[dtype]}')


def _checked_args(what, tables, cells, aux, params):
    """Checks the kernels' inputs and packs the launch arguments shared by
    K2, K3 and K4: (level arrays, (M, F, H1, O, K), the levels' channels).
    aux is bf16 or f32 (``CORE_TYPES``), laid out by :func:`aux_layout`,
    the tables all in aux's type or all int8, of any channel counts: a
    level whose C is not a multiple of 8 is read from a zero-padded copy
    (``grid_sample.pad_cells``, which the array of table pointers keeps
    alive), and F is the sum of the levels' :func:`table_width`. Raises
    ValueError on what the kernels do not take."""
    def require(cond, msg):
        if not cond:
            raise ValueError(f'{what}: {msg}')

    (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias) = params
    dev, dt = aux[0].device, aux[0].dtype
    require(dt in CORE_TYPES, f'bf16 or f32 inputs, got {dt}')
    tdt = tables[0].dtype
    require(tdt in (dt, torch.int8),
            f'tables in the inputs\' type {dt} or int8, got {tdt}')
    S, M = len(aux), aux[0].shape[0]
    channels = [t.shape[-1] // 4 for t in tables]
    F, H1 = sum(channels), w1.shape[1]
    O, K = w2.shape[1], k2.shape[1]
    require(1 <= len(tables) <= MAX_LEVELS and len(cells) == len(tables),
            f'one to {MAX_LEVELS} pyramid levels, got {len(tables)}')
    aux_w = aux_layout(len(tables))[1]
    require(tuple(w1.shape) == (F + 3, H1) and tuple(lv.shape) == (S * O, O)
            and tuple(km.shape) == (S * O, K), 'weight shapes')
    for t, c in zip(tables, cells):
        require(t.device == dev and t.dtype == tdt and t.is_contiguous()
                and t.shape[-1] % 4 == 0 and t.data_ptr() % 16 == 0,
                f'tables must be contiguous {tdt} (..., 4C) on {dev}')
        require(c.device == dev and c.dtype == torch.int32
                and c.is_contiguous() and tuple(c.shape) == (S * M,),
                f'cells must be contiguous int32 ({S * M},) on {dev}')
    for a in aux:
        require(a.device == dev and a.dtype == dt and a.is_contiguous()
                and tuple(a.shape) == (M, aux_w) and a.data_ptr() % 16 == 0,
                f'aux must be contiguous {dt} ({M}, {aux_w}) on {dev} for '
                f'{len(tables)} levels')
    read = [pad_cells(t, table_width(c)) for t, c in zip(tables, channels)]
    n = len(tables)
    pointers = (ctypes.c_void_p * n)(*[t.data_ptr() for t in read])
    pointers.tensors = read
    levels = (pointers,
              (ctypes.c_void_p * n)(*[c.data_ptr() for c in cells]),
              (ctypes.c_int * n)(*[table_width(c) for c in channels]))
    F = sum(table_width(c) for c in channels)
    return levels, (M, F, H1, O, K), channels


def _core_args(what, mode, tables, cells, aux, params):
    """:func:`_checked_args` for K2 (mode 'pair') and K3 ('streams'), with
    the widths the core takes (:func:`check_core_widths`), their prepared
    weights and the scratch of their plan: (levels, sizes, stages, vecs,
    scratch)."""
    levels, sizes, channels = _checked_args(what, tables, cells, aux,
                                            params)
    M, F, H1, O, K = sizes
    L = len(tables)
    check_core_widths(what, mode, len(aux), F, H1, O, K, levels=L)
    stages, vecs = prepared_weights(params, len(aux), aux[0].device,
                                    channels)
    scratch = core_scratch(mode, len(aux), F, H1, O, K, _cdiv(M, 64),
                           aux[0].device, levels=L)
    return levels, sizes, stages, vecs, scratch


def _widths(mode, S, sizes, levels):
    """:func:`core_plan`'s arguments for K2 or K3 at ``sizes``."""
    _, F, H1, O, K = sizes
    return dict(mode=mode, S=S, F=F, H1=H1, O=O, K=K, levels=levels)


def _outputs(aux, sizes):
    """Empty (jl (M, O), kv (M, K)) in aux's type for K2 and K3."""
    M, _, _, O, K = sizes
    return (torch.empty((M, O), dtype=aux.dtype, device=aux.device),
            torch.empty((M, K), dtype=aux.dtype, device=aux.device))


def _launch(tables, cells, aux_self, aux_cross, params, rp):
    levels, sizes, stages, vecs, scratch = _core_args(
        'fused_exchange_epilogue', 'pair', tables, cells,
        (aux_self, aux_cross), params)
    jl, kv = _outputs(aux_self, sizes)
    fn = core_entry('gather_epilogue', 'fused_exchange_epilogue',
                    aux_self.dtype, tables[0].dtype, sizes[3])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2)
    info = (ctypes.c_int * 8)()
    with torch.cuda.device(jl.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(len(tables), *levels, aux_self.data_ptr(),
                        aux_cross.data_ptr(), stages.data_ptr(),
                        stages.numel() * 2, vecs.data_ptr(), jl.data_ptr(),
                        kv.data_ptr(), *sizes, rp, *_scratch_args(scratch),
                        info, stream),
                     'fused_exchange_epilogue')
    record_launch(fused_exchange_epilogue, info,
                  _widths('pair', 2, sizes, len(tables)))
    return jl, kv


# ---------------------------------------------------------------------------
# V>=3: S streams in the fixed [self, cross_0, cross_1, ...] order (K3)
# ---------------------------------------------------------------------------

def _reference_multi(vals_stacked: Sequence[Tensor],
                     aux_list: Sequence[Tensor], params: Sequence[Tensor]
                     ) -> tuple[Tensor, Tensor]:
    """The S-stream epilogue's math on taken rows (JAX ``_reference_multi``).

    vals_stacked: per-level (S*M, 4C) rows, stream-major. aux_list: S
    arrays (M, 16) (or (M, 24) with four levels), any S >= 2. params: as
    :func:`_reference`, with lv (S*O, O) and km (S*O, K). Each stream's
    products round to the compute type, as in the JAX reference."""
    M = vals_stacked[0].shape[0] // len(aux_list)
    return _streams_reference(
        lambda s: [v[s * M:(s + 1) * M] for v in vals_stacked],
        vals_stacked[0].dtype, aux_list, params)


def _streams_reference(stream_rows, rows_dtype: torch.dtype,
                       aux_list: Sequence[Tensor],
                       params: Sequence[Tensor]) -> tuple[Tensor, Tensor]:
    """:func:`_reference_multi` with stream s's per-level rows from
    ``stream_rows(s)`` (rows of type ``rows_dtype``), one stream at a time:
    the same products in the same order, holding one stream's rows."""
    (w1, b1, w2, b2, lv, lv_bias, km, km_bias, k2, k2_bias) = params
    dt = rows_dtype if rows_dtype.is_floating_point else aux_list[0].dtype
    O = w2.shape[1]
    jl = lv_bias.to(dt)
    kh = km_bias.to(dt)
    for s, aux in enumerate(aux_list):
        f = _fuse(stream_rows(s), aux, w1, b1, w2, b2)
        jl = jl + f @ lv[s * O:(s + 1) * O].to(dt)
        kh = kh + f @ km[s * O:(s + 1) * O].to(dt)
    kv = torch.relu(kh) @ k2.to(dt) + k2_bias.to(dt)
    return jl, kv


def fused_exchange_epilogue_multi_reference(tables, cells, aux_list, params):
    """Plain version: ``index_select`` row take, then
    :func:`_reference_multi`, one stream's rows at a time (at the V=8
    flagship's first block all streams' rows would be ~115 GB)."""
    flat = [t.reshape(-1, t.shape[-1]) for t in tables]
    M = aux_list[0].shape[0]
    return _streams_reference(
        lambda s: [t.index_select(0, c[s * M:(s + 1) * M].long())
                   for t, c in zip(flat, cells)],
        tables[0].dtype, aux_list, params)


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
      aux_list: S arrays, one per stream, laid out as the aux of
        :func:`fused_exchange_epilogue`.
      params: as :func:`_reference_multi`.

    CPU tensors take the plain version. CUDA tensors must be contiguous,
    aux bf16 or f32 and the tables in aux's type or int8 (cells int32),
    with any S >= 2 streams; they launch the kernel's instantiation of those
    types, and anything else raises. From S = 4 at the flagship's widths
    the f rows of S - 1 streams do not fit beside comb and three stage
    slots a ring, and the core takes its 'resident' plan
    (:func:`core_plan`)."""
    if aux_list[0].device.type == 'cpu':
        return fused_exchange_epilogue_multi_reference(tables, cells,
                                                       aux_list, params)
    return kernel_call(_launch_multi, fused_exchange_epilogue_multi_reference,
                       tables, cells, aux_list, params)


fused_exchange_epilogue_multi.launches = 0  # kernel launches
fused_exchange_epilogue_multi.last_launch = None
fused_exchange_epilogue_multi.last_plan = None
fused_exchange_epilogue_multi.last_widths = None


def _launch_multi(tables, cells, aux_list, params):
    S = len(aux_list)
    if S < 2:
        raise ValueError(f'fused_exchange_epilogue_multi: at least 2 '
                         f'streams, got {S}')
    levels, sizes, stages, vecs, scratch = _core_args(
        'fused_exchange_epilogue_multi', 'streams', tables, cells, aux_list,
        params)
    jl, kv = _outputs(aux_list[0], sizes)
    fn = core_entry('gather_epilogue_multi', 'fused_exchange_epilogue_multi',
                    aux_list[0].dtype, tables[0].dtype, sizes[3])
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2)
    aux = torch.cat(list(aux_list))
    info = (ctypes.c_int * 8)()
    with torch.cuda.device(jl.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(len(tables), *levels, S, aux.data_ptr(),
                        stages.data_ptr(),
                        stages.numel() * 2, vecs.data_ptr(), jl.data_ptr(),
                        kv.data_ptr(), *sizes, *_scratch_args(scratch), info,
                        stream),
                     'fused_exchange_epilogue_multi')
    record_launch(fused_exchange_epilogue_multi, info,
                  _widths('streams', S, sizes, len(tables)))
    return jl, kv
