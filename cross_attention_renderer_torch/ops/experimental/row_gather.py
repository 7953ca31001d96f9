"""Row gathers by a dynamic index: the tools' 13 Pallas probes on Hopper.

The JAX repository's ``tools/micro_kgather*.py`` hold 13 ``pl.pallas_call``
sites that ask one question of Mosaic: can a kernel gather
``out[j] = table[idx[j]]`` by an index read at run time, and how fast,
against XLA's ``jnp.take(table, idx, axis=0, mode='clip')``? On Hopper any
thread reads any row, so the port asks what each way of moving a row costs
against ``torch.index_select`` and the card's byte bound. One CUDA source,
``csrc/row_gather.cu``, holds three kernels, each instantiated per probe:

* :func:`copy_gather`: 16-byte loads and stores, several rows in flight a
  warp (``unroll`` chunks of each row a lane, 8 chunks a lane in all), the
  indices read from device memory (``index='global'``), staged in shared
  memory by the threads (``'shared'``) or by one bulk copy on an mbarrier
  (``'bulk'``); ``stage=True`` passes the rows through shared memory;
* :func:`bulk_gather`: several issuing warps a block, each moving its rows
  with one ``cp.async.bulk`` a row into shared memory, ``window`` rows (16
  or 1) in flight, and one bulk copy out, loads and stores overlapping;
* :func:`block_fill`: each block of ``bm`` rows of an (M, width) int32
  output filled with the block's first index, a tile of rows a block at a
  time, the first index of each row block it spans read once.

The launch geometry comes from :func:`launch_plan`, from the card's SM
count and the shapes, never from the probes' ``bm``: it stays in the
gathers' signatures because the probe scripts pass it, but a gather's
function never depended on it; the fill reads it as data only.

CPU tensors take the plain versions, :func:`row_gather_reference` (the
probes' own oracle, ``jnp.take(..., mode='clip')``) and
:func:`block_fill_reference`; CUDA tensors launch the kernel or raise. No
renderer path runs these kernels.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops.sorted_gather import sm_count

Tensor = torch.Tensor

INDEX = {'global': 0, 'shared': 1, 'bulk': 2}
UNROLLS = (1, 4, 8)
WINDOWS = (1, 16)
# element types each entry point takes: the probes' own
COPY_DTYPES = (torch.bfloat16, torch.float32)
FILL_DTYPE = torch.int32

SMEM_MAX = 232448       # shared memory a block can take, bytes
SM_SMEM = 233472        # shared memory an SM gives its blocks, bytes
COPY_DEPTH = 8          # 16-byte chunks a lane of the copy gather has in flight
FILL_DEPTH = 1          # 16-byte chunks a thread of the fill writes a tile
FILL_TILES = 4          # tiles an SM the fill's rows are cut into
FILL_WARPS = 8          # warps an SM a short copy gather is spread over
MAX_WARPS = 8           # warps a block (the bulk gather's issuing warps)
RESIDENT_WARPS = 32     # warps an SM is taken to hold (its registers)
TILE_BYTES = 1 << 18    # row bytes a copy-gather block takes at a time
MAX_TILE = 4096         # rows a copy-gather block takes at a time, at most


@dataclass(frozen=True)
class Plan:
    """A gather's launch: ``grid`` blocks of ``warps`` warps. The copy
    gather's blocks take tiles of ``tile`` rows (block b the tiles b, b +
    grid, ...), each warp ``in_flight`` rows at a time, ``unroll`` chunks of
    each a lane (``in_flight * unroll <= COPY_DEPTH``), a row in ``steps``
    units; the bulk gather's warps take
    ``tile`` consecutive rows each, ``in_flight`` (the window) at a time;
    the fill's blocks take tiles of ``tile`` rows as the copy gather's, a
    thread writing at most ``in_flight`` 16-byte chunks of a tile.
    ``smem``: dynamic shared memory a block, bytes."""
    kind: str
    grid: int
    warps: int
    tile: int
    in_flight: int
    unroll: int
    steps: int
    smem: int


def launch_plan(kind: str, M: int, row_bytes: int, sm_count: int, *,
                unroll: int = 1, index: str = 'global', stage: bool = False,
                window: int = 16, fill_warps: int = FILL_WARPS,
                warps: int = MAX_WARPS, fill_depth: int = FILL_DEPTH,
                fill_tiles: int = FILL_TILES) -> Plan:
    """The launch of a gather of M rows of ``row_bytes`` on a card of
    ``sm_count`` SMs (``kind`` 'copy' or 'bulk'), or of a block fill of M
    rows of ``row_bytes`` ('fill'): at least two blocks an SM
    where M allows, a grid-stride loop over the tiles of a large M (copy),
    fewer rows in flight a warp where M is too short to give ``fill_warps``
    warps an SM a unit (copy); as many issuing warps as M, shared memory and
    ``warps`` allow (bulk); rows a tile for ``fill_tiles`` tiles an SM, as
    many warps as give each thread ``fill_depth`` chunks of a tile, and a
    grid-stride loop past ``RESIDENT_WARPS`` an SM (fill). ``unroll`` sets
    the chunks of one row a lane takes at a step; the rows in flight fill
    the lane to ``COPY_DEPTH`` chunks whatever ``unroll`` is, so probe
    cases that differ only in ``unroll`` may run one plan. ``warps``: warps a block, at most (a study
    of the rule's choices passes fewer). Raises ValueError where the rows
    do not fit shared memory."""
    if kind == 'copy':
        chunks = row_bytes // 16
        per_lane = -(-chunks // 32)       # a row's chunks a lane holds
        eff = min(unroll, 1 << (per_lane - 1).bit_length())
        rows = COPY_DEPTH // eff
        steps = -(-chunks // (32 * eff))
        while rows > 1 and -(-M // rows) * steps < fill_warps * sm_count:
            rows //= 2
        quantum = rows * 4 // math.gcd(rows, 4) if index == 'bulk' else rows
        cap = max(quantum, min(TILE_BYTES // row_bytes, MAX_TILE)
                  // quantum * quantum)
        tile = min(-(-M // (2 * sm_count * quantum)) * quantum, cap)
        warps = min(warps, -(-tile // rows) * steps)
        grid = min(-(-M // tile), sm_count * max(1, RESIDENT_WARPS // warps))
        smem = (-(-tile * 4 // 16) * 16 + 16
                + (warps * rows * eff * 32 * 16 if stage else 0))
        return Plan(kind, grid, warps, tile, rows, eff, steps, smem)
    if kind == 'fill':
        chunks = row_bytes // 16
        tile = max(1, min(-(-M // (fill_tiles * sm_count)),
                          warps * 32 * fill_depth // chunks))
        warps = max(1, min(warps, -(-tile * chunks // (32 * fill_depth))))
        grid = min(-(-M // tile), sm_count * max(1, RESIDENT_WARPS // warps))
        return Plan(kind, grid, warps, tile, fill_depth, 1, 1,
                    -(-tile * 4 // 16) * 16)
    warps = min(warps, (SMEM_MAX - 128) // (window * (row_bytes + 8)))
    if warps < 1:
        raise ValueError(f'bulk_gather: {window} rows of {row_bytes} bytes '
                         'exceed shared memory')
    smem = -(-warps * window * 8 // 128) * 128 + warps * window * row_bytes
    per_sm = max(1, min(32, 64 // warps, SM_SMEM // (smem + 1024)))
    rows = -(-M // min(M, sm_count * per_sm * warps))   # a warp's rows
    grid = -(-M // (rows * warps))
    return Plan(kind, grid, warps, rows, window, 1, 1, smem)


def block_rows(plan: Plan, M: int, block: int) -> list[range]:
    """The rows block ``block`` of ``plan`` gathers, as the kernel assigns
    them: its tiles (copy, fill) or its warps' runs (bulk)."""
    if plan.kind in ('copy', 'fill'):
        return [range(t * plan.tile, min(M, (t + 1) * plan.tile))
                for t in range(block, -(-M // plan.tile), plan.grid)]
    first = block * plan.warps * plan.tile
    return [range(w, min(M, w + plan.tile))
            for w in range(first, first + plan.warps * plan.tile, plan.tile)
            if w < M]


def row_gather_reference(table: Tensor, idx: Tensor) -> Tensor:
    """``table[clip(idx, 0, HW - 1)]``: ``jnp.take(table, idx, axis=0,
    mode='clip')``, the probes' baseline and oracle."""
    return table[idx.clamp(0, table.shape[0] - 1).long()]


def block_fill_reference(idx: Tensor, bm: int, width: int = 128) -> Tensor:
    """(M, width) int32: row j holds idx[(j // bm) * bm], the first index of
    its block (the bisect probes' SMEM block read)."""
    M = idx.shape[0]
    first = idx[::bm].to(torch.int32)
    n = first.shape[0]
    return first[:, None, None].expand(n, bm, width).reshape(
        n * bm, width)[:M].contiguous()


def _require(what: str, cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f'{what}: {msg}')


def _check_rows(what: str, table: Tensor, idx: Tensor, bm: int) -> int:
    """Checks a gather's operands; returns the bytes of a row."""
    _require(what, table.dtype in COPY_DTYPES,
             f'table must be bf16 or f32, got {table.dtype}')
    _require(what, table.is_cuda and table.is_contiguous()
             and table.dim() >= 2 and table.data_ptr() % 16 == 0,
             'table must be a contiguous 16-byte-aligned CUDA tensor of '
             'rows')
    _require(what, idx.device == table.device and idx.dtype == torch.int32
             and idx.dim() == 1 and idx.is_contiguous()
             and idx.data_ptr() % 16 == 0 and idx.numel() > 0,
             f'idx must be contiguous 1-D int32 on {table.device}')
    row_bytes = table[0].numel() * table.element_size()
    _require(what, row_bytes % 16 == 0, f'a row is {row_bytes} bytes, not a '
             'multiple of 16')
    _require(what, bm > 0 and table.shape[0] > 0, 'bm and HW must be > 0')
    return row_bytes


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# each launcher of csrc/row_gather.cu: its arguments' C types
_SIGNATURES = {
    'row_gather_copy': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 10
    + [ctypes.c_void_p],
    'row_gather_bulk': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    'row_gather_release_l2': [ctypes.c_void_p, ctypes.c_size_t,
                              ctypes.c_void_p],
    'row_block_fill': [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
}
_launchers = {}      # (library, name) -> its ctypes function


def _launcher(name: str):
    """The launcher ``name`` of ``csrc/row_gather.cu`` (of the library
    ``_build.load`` gives), built and loaded at its first call, its C
    signature set once."""
    lib = _build.load('row_gather')
    fn = _launchers.get((lib, name))
    if fn is None:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _launchers[lib, name] = fn
    return fn


def run_plan(plan: Plan, table: Tensor, idx: Tensor, *,
             index: str = 'global', stage: bool = False) -> Tensor:
    """Launches the gather ``plan`` (any grid and warps, as
    :func:`launch_plan` or a study of it gives) of ``table[clip(idx)]`` on
    checked CUDA operands -> the rows; counts no launch. Raises on a refused
    launch."""
    M = idx.shape[0]
    out = torch.empty((M,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    common = (table.data_ptr(), idx.data_ptr(), out.data_ptr(),
              table.shape[0], M, table[0].numel() * table.element_size())
    with torch.cuda.device(table.device):
        stream = _stream(table.device)
        if plan.kind == 'copy':
            code = _launcher('row_gather_copy')(
                *common, INDEX[index], plan.unroll, plan.in_flight,
                int(stage), plan.tile, plan.warps, plan.grid, stream)
        else:
            code = _launcher('row_gather_bulk')(
                *common, plan.in_flight, plan.warps, plan.tile, plan.grid,
                stream)
    _build.check(code, f'{plan.kind}_gather')
    return out


def release_l2(table: Tensor) -> None:
    """Returns ``table``'s lines in L2 to the normal eviction priority: the
    gathers load a table ``evict_last``, and the marks outlast the launch,
    so whatever runs next would find the table kept in L2."""
    if table.device.type == 'cpu':
        return
    with torch.cuda.device(table.device):
        _build.check(_launcher('row_gather_release_l2')(
            table.data_ptr(), table.numel() * table.element_size(),
            _stream(table.device)), 'release_l2')


def copy_gather(table: Tensor, idx: Tensor, *, bm: int = 512,
                unroll: int = 1, index: str = 'global',
                stage: bool = False) -> Tensor:
    """``table[clip(idx)]`` -> (M, *table.shape[1:]), 16-byte loads and
    stores, several rows in flight a warp (:func:`launch_plan`).

    bm: the probes' block size (> 0; it sets no part of the launch); unroll:
    16-byte chunks of one row a lane takes at a step (1, 4, 8; fewer where
    a row has fewer), the lane's other chunks in flight (8 in all) being of
    further rows; index: where a
    block reads its rows' indices ('global', 'shared', 'bulk'; 'bulk' takes
    M a multiple of 4); stage: the rows through shared memory (index
    'shared', unroll 1)."""
    if table.device.type == 'cpu':
        return row_gather_reference(table, idx)
    what = 'copy_gather'
    row_bytes = _check_rows(what, table, idx, bm)
    M = idx.shape[0]
    _require(what, index in INDEX and unroll in UNROLLS,
             f'index in {tuple(INDEX)}, unroll in {UNROLLS}')
    _require(what, index != 'bulk' or M % 4 == 0,
             "index='bulk' takes M a multiple of 4")
    _require(what, not stage or (index == 'shared' and unroll == 1),
             "stage takes index='shared' and unroll=1")
    plan = launch_plan('copy', M, row_bytes, sm_count(table.device),
                       unroll=unroll, index=index, stage=stage)
    out = run_plan(plan, table, idx, index=index, stage=stage)
    copy_gather.launches += 1
    copy_gather.last_plan = plan
    return out


copy_gather.launches = 0    # kernel launches
copy_gather.last_plan = None


def bulk_gather(table: Tensor, idx: Tensor, *, bm: int = 512,
                window: int = 16) -> Tensor:
    """``table[clip(idx)]`` -> (M, *table.shape[1:]): several issuing warps
    a block, each moving its rows with one bulk copy a row into shared
    memory, ``window`` (16 or 1) rows in flight, and one out
    (:func:`launch_plan`). bm: as :func:`copy_gather`'s."""
    if table.device.type == 'cpu':
        return row_gather_reference(table, idx)
    what = 'bulk_gather'
    row_bytes = _check_rows(what, table, idx, bm)
    _require(what, window in WINDOWS, f'window in {WINDOWS}')
    M = idx.shape[0]
    plan = launch_plan('bulk', M, row_bytes, sm_count(table.device),
                       window=window)
    out = run_plan(plan, table, idx)
    bulk_gather.launches += 1
    bulk_gather.last_plan = plan
    return out


bulk_gather.launches = 0    # kernel launches
bulk_gather.last_plan = None


def fill_heads(plan: Plan, M: int, bm: int, tile: int) -> tuple[int, int]:
    """(first row block, row blocks) of tile ``tile`` of a fill ``plan``:
    the indices the kernel reads into shared memory for it, one a row
    block."""
    m0 = tile * plan.tile
    n = min(plan.tile, M - m0)
    return m0 // bm, (m0 + n - 1) // bm - m0 // bm + 1


def run_fill(plan: Plan, idx: Tensor, bm: int, width: int) -> Tensor:
    """Launches the fill ``plan`` on checked CUDA operands -> (M, width)
    int32; counts no launch. Raises on a refused launch."""
    M = idx.shape[0]
    out = torch.empty((M, width), dtype=FILL_DTYPE, device=idx.device)
    with torch.cuda.device(idx.device):
        _build.check(_launcher('row_block_fill')(
            idx.data_ptr(), out.data_ptr(), M, bm, width, plan.tile,
            plan.warps, plan.grid, _stream(idx.device)), 'block_fill')
    return out


def block_fill(idx: Tensor, bm: int, width: int = 128) -> Tensor:
    """(M, width) int32, each block of ``bm`` rows filled with its first
    index (:func:`block_fill_reference`), launched as :func:`launch_plan`
    ('fill') gives."""
    if idx.device.type == 'cpu':
        return block_fill_reference(idx, bm, width)
    what = 'block_fill'
    _require(what, idx.dtype == FILL_DTYPE and idx.dim() == 1
             and idx.is_contiguous() and idx.numel() > 0,
             'idx must be contiguous 1-D int32')
    _require(what, bm > 0 and width > 0 and width % 4 == 0,
             'bm > 0 and width a multiple of 4')
    plan = launch_plan('fill', idx.shape[0], width * 4, sm_count(idx.device))
    out = run_fill(plan, idx, bm, width)
    block_fill.launches += 1
    block_fill.last_plan = plan
    return out


block_fill.launches = 0     # kernel launches
block_fill.last_plan = None
