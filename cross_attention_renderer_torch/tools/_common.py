"""What the row-gather probe scripts share: the probes' sites, timing, the
byte bound and the exactness check; and the bilinear gather's (K5-K8)
bound, which ``chip_smoke.py`` and ``gather_study.py`` share.

Each probe case runs its kernel (``ops/experimental/row_gather.py``) at the
JAX probe's shapes, checks it bit for bit against the plain version
(``table[clip(idx)]``, the probes' ``jnp.take(..., mode='clip')``), and
times it beside the plain version and one PyTorch call computing the same
function (``torch.index_select``; for the block fill a ``copy_`` from an
expanded view, since ``Tensor.fill_`` takes one value, not one a block,
timed before the kernel as well).
All three are timed as device time: back-to-back calls in one CUDA graph
(``utils/profiling.py`` ``graph_ms``), so that a probe of a few
microseconds is not timed as the host's cost of launching it. A gather's
``index_select`` and plain version are timed before its kernel first
touches the table: the kernels load a table ``evict_last``, and the marks,
which outlast the launch, would keep the table in L2 for whatever reads it
next. After the kernel's timing the marks are cleared
(``row_gather.release_l2``), so no later case or caller inherits them.
"""

from __future__ import annotations

import dataclasses

import torch

from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from cross_attention_renderer_torch.utils.profiling import graph_ms

Tensor = torch.Tensor

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
F32_FLOPS = 67e12               # f32 outside the tensor cores, published

# probe -> (the TPU kernel's site, what it computes)
PROBES = {
    'T1': ('tools/micro_kgather.py:65', 'vmem_loop_gather'),
    'T2': ('tools/micro_kgather.py:123', 'hbm_dma_gather'),
    'T3': ('tools/micro_kgather2.py:36', 'gather_prefetch'),
    'T4': ('tools/micro_kgather3.py:46', 'tile_gather'),
    'T5': ('tools/micro_kgather3.py:81', 'dma_gather'),
    'T6': ('tools/micro_kgather_bisect.py:29', 'smem_block_input'),
    'T7': ('tools/micro_kgather_bisect.py:45', 'dyn_row_load_f32'),
    'T8': ('tools/micro_kgather_bisect.py:71', 'dyn_row_load_bf16'),
    'T9': ('tools/micro_kgather_bisect.py:96',
           'dyn_row_static_store_scratch'),
    'T10': ('tools/micro_kgather_bisect.py:124', 'dma_one_row'),
    'T11': ('tools/micro_kgather_bisect2.py:27', 'smem_2d'),
    'T12': ('tools/micro_kgather_bisect2.py:42', 'prefetch_idx'),
    'T13': ('tools/micro_kgather_bisect2.py:72', 'vmem_idx_dma_smem'),
}


def device() -> torch.device:
    """The card; the probes measure nothing on the CPU."""
    if not torch.cuda.is_available():
        raise SystemExit('the row-gather probes need an NVIDIA card')
    return torch.device('cuda')


def calls_for(rows: int) -> int:
    """Calls a timing captures: about 2^20 rows in all, at least 8."""
    return max(8, 2 ** 20 // rows)


def random_table(shape, dtype, seed: int, dev) -> Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def random_idx(hw: int, m: int, seed: int, dev) -> Tensor:
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    return torch.randint(0, hw, (m,), generator=g, device=dev,
                         dtype=torch.int32)


def gather_bound(table, idx) -> tuple[float, str]:
    """(bound_ms, 'bytes') of a row gather: each input byte read once and
    each output byte written once, so the rows written, each distinct row
    gathered read once (at most the whole table, wherever it lies), and the
    indices."""
    M = idx.shape[0]
    row = table[0].numel() * table.element_size()
    read = int(torch.unique(idx.clamp(0, table.shape[0] - 1)).numel())
    return (M * row + read * row + 4 * M) / HBM_BYTES_PER_S * 1e3, 'bytes'


def bilinear_bound(table, idx, w, out_dtype) -> tuple[float, str]:
    """(bound_ms, bound_by) of one bilinear gather (K5-K8): the table rows
    its live corners touch, read once; its corners and weights (32 bytes a
    sample); its (M, C) output written once; 4 multiply-adds a channel a
    sample at the f32 rate."""
    M, C = idx.shape[0], table.shape[1]
    rows = int(torch.unique(idx[w != 0]).numel())
    out_bytes = torch.empty((), dtype=out_dtype).element_size()
    nbytes = rows * C * table.element_size() + M * 32 + M * C * out_bytes
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 8 * M * C / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def fill_bound(idx, bm: int, width: int) -> tuple[float, str]:
    """(bound_ms, 'bytes') of a block fill: the (M, width) int32 output
    written, each block's first index read."""
    M = idx.shape[0]
    return ((M * width + -(-M // bm)) * 4 / HBM_BYTES_PER_S * 1e3, 'bytes')


def check_exact(label: str, got: Tensor, want: Tensor) -> float:
    """The kernel's output against the plain version's: a copy, so equal
    bit for bit. Returns the max abs difference (0.0); raises otherwise."""
    if got.shape != want.shape or got.dtype != want.dtype or not bool(
            torch.equal(got, want)):
        raise RuntimeError(f'{label}: does not match its plain version')
    return 0.0


def line(label: str, ms: float, rows: int) -> None:
    """The probes' own output line: ms a call and ns a row."""
    print(f'{label:56s} {ms:8.3f} ms   {ms * 1e6 / rows:6.2f} ns/row',
          flush=True)


def gather_case(probe: str, label: str, kernel, table, idx) -> dict:
    """One gather case: the kernel (a callable of (table, idx)) checked
    against ``row_gather_reference`` and timed beside it, beside
    ``torch.index_select`` and beside the byte bound. Prints the probe's
    lines; returns the case's numbers and the launch plan its kernel
    took."""
    M = idx.shape[0]
    n = calls_for(M)
    # index_select and the plain version first, on a table no kernel has
    # marked evict_last
    lib_ms = graph_ms(lambda: torch.index_select(table, 0, idx), n)
    plain_ms = graph_ms(lambda: RG.row_gather_reference(table, idx), n)
    want = RG.row_gather_reference(table, idx)
    launched = (RG.copy_gather.launches, RG.bulk_gather.launches)
    err = check_exact(label, kernel(table, idx), want)
    plan = None                 # the plan of the launch just made
    for entry, before in zip((RG.copy_gather, RG.bulk_gather), launched):
        if entry.launches > before:
            plan = dataclasses.asdict(entry.last_plan)
    del want
    ms = graph_ms(lambda: kernel(table, idx), n)
    RG.release_l2(table)
    bound_ms, bound_by = gather_bound(table, idx)
    line(f'{probe} {label}', ms, M)
    line(f'{probe} index_select (beside it)', lib_ms, M)
    return {'probe': probe, 'case': label, 'ms': ms, 'plain_ms': plain_ms,
            'library': 'index_select', 'library_ms': lib_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by, 'max_abs_err': err,
            'ns_per_row': ms * 1e6 / M, 'plan': plan,
            'table': f'{tuple(table.shape)} {table.dtype}', 'rows': M}


def fill_case(probe: str, label: str, idx, bm: int, width: int = 128
              ) -> dict:
    """One block-fill case, as :func:`gather_case`: ``copy_`` from an
    expanded view and the plain version timed first, then the kernel
    checked bit for bit and timed; returns its launch plan too."""
    M = idx.shape[0]
    want = RG.block_fill_reference(idx, bm, width)
    out = torch.empty_like(want)
    nb = -(-M // bm)

    def library():
        # one call: the blocks' first indices broadcast over their rows
        out.view(nb, bm, width).copy_(
            idx.view(nb, bm)[:, :1, None].expand(nb, bm, width))

    n = calls_for(M)
    lib_ms = graph_ms(library, n) if M % bm == 0 else None
    plain_ms = graph_ms(lambda: RG.block_fill_reference(idx, bm, width), n)
    err = check_exact(label, RG.block_fill(idx, bm, width), want)
    plan = dataclasses.asdict(RG.block_fill.last_plan)
    ms = graph_ms(lambda: RG.block_fill(idx, bm, width), n)
    bound_ms, bound_by = fill_bound(idx, bm, width)
    line(f'{probe} {label}', ms, M)
    if lib_ms:
        line(f'{probe} copy_ (beside it)', lib_ms, M)
    return {'probe': probe, 'case': label, 'ms': ms, 'plain_ms': plain_ms,
            'library': 'copy_', 'library_ms': lib_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by, 'max_abs_err': err,
            'ns_per_row': ms * 1e6 / M, 'plan': plan}


def ok(name: str) -> None:
    """The bisect probes' verdict on Hopper: launched and matched."""
    print(f'{name}: OK (launches and matches the plain version)', flush=True)
