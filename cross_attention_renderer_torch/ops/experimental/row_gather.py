"""Row gathers by a dynamic index: the tools' 13 Pallas probes on Hopper.

The JAX repository's ``tools/micro_kgather*.py`` hold 13 ``pl.pallas_call``
sites that ask one question of Mosaic: can a kernel gather
``out[j] = table[idx[j]]`` by an index read at run time, and how fast,
against XLA's ``jnp.take(table, idx, axis=0, mode='clip')``? On Hopper any
thread reads any row, so the port asks what each way of moving a row costs
against ``torch.index_select`` and the card's byte bound. One CUDA source,
``csrc/row_gather.cu``, holds three kernels, each instantiated per probe:

* :func:`copy_gather`: one warp a row, 16-byte loads and stores, the lane
  loop unrolled 1, 4 or 8, the indices read from device memory
  (``index='global'``), staged in shared memory by the threads
  (``'shared'``) or by one bulk copy on an mbarrier (``'bulk'``);
  ``stage=True`` passes each row through a one-row shared buffer;
* :func:`bulk_gather`: one ``cp.async.bulk`` a row into shared memory,
  ``window`` rows (16 or 1) in flight, then a bulk copy out;
* :func:`block_fill`: each block of ``bm`` rows of an (M, width) int32
  output filled with the block's first index.

CPU tensors take the plain versions, :func:`row_gather_reference` (the
probes' own oracle, ``jnp.take(..., mode='clip')``) and
:func:`block_fill_reference`; CUDA tensors launch the kernel or raise. No
renderer path runs these kernels.
"""

from __future__ import annotations

import ctypes

import torch

from cross_attention_renderer_torch.ops import _build

Tensor = torch.Tensor

INDEX = {'global': 0, 'shared': 1, 'bulk': 2}
UNROLLS = (1, 4, 8)
WINDOWS = (1, 16)
# element types each entry point takes: the probes' own
COPY_DTYPES = (torch.bfloat16, torch.float32)
FILL_DTYPE = torch.int32


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
    'row_gather_copy': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
    + [ctypes.c_void_p],
    'row_gather_bulk': [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + [ctypes.c_void_p],
    'row_block_fill': [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    + [ctypes.c_void_p],
}
_launchers = {}      # name -> its ctypes function


def _launcher(name: str):
    """The launcher ``name`` of ``csrc/row_gather.cu``, built and loaded at
    its first call, its C signature set once."""
    fn = _launchers.get(name)
    if fn is None:
        fn = getattr(_build.load('row_gather'), name)
        fn.restype = ctypes.c_int
        fn.argtypes = _SIGNATURES[name]
        _launchers[name] = fn
    return fn


def copy_gather(table: Tensor, idx: Tensor, *, bm: int = 512,
                unroll: int = 1, index: str = 'global',
                stage: bool = False) -> Tensor:
    """``table[clip(idx)]`` -> (M, *table.shape[1:]), one warp a row.

    bm: rows a block; unroll: 16-byte chunks a lane has in flight (1, 4,
    8); index: where a block reads its indices ('global', 'shared', 'bulk';
    'bulk' takes M and bm multiples of 4); stage: each row through shared
    memory (index 'shared', unroll 1)."""
    if table.device.type == 'cpu':
        return row_gather_reference(table, idx)
    what = 'copy_gather'
    row_bytes = _check_rows(what, table, idx, bm)
    M = idx.shape[0]
    _require(what, index in INDEX and unroll in UNROLLS,
             f'index in {tuple(INDEX)}, unroll in {UNROLLS}')
    _require(what, index != 'bulk' or (M % 4 == 0 and bm % 4 == 0),
             "index='bulk' takes M and bm multiples of 4")
    _require(what, not stage or (index == 'shared' and unroll == 1),
             "stage takes index='shared' and unroll=1")
    out = torch.empty((M,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    fn = _launcher('row_gather_copy')
    with torch.cuda.device(table.device):
        _build.check(fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        table.shape[0], M, row_bytes, bm, INDEX[index],
                        unroll, int(stage), _stream(table.device)), what)
    copy_gather.launches += 1
    return out


copy_gather.launches = 0    # kernel launches


def bulk_gather(table: Tensor, idx: Tensor, *, bm: int = 512,
                window: int = 16) -> Tensor:
    """``table[clip(idx)]`` -> (M, *table.shape[1:]), one bulk copy a row
    into shared memory with ``window`` (16 or 1) rows in flight, and one
    out, one warp a block of ``bm`` rows."""
    if table.device.type == 'cpu':
        return row_gather_reference(table, idx)
    what = 'bulk_gather'
    row_bytes = _check_rows(what, table, idx, bm)
    _require(what, window in WINDOWS, f'window in {WINDOWS}')
    _require(what, 128 + window * row_bytes <= 227 * 1024,
             f'{window} rows of {row_bytes} bytes exceed shared memory')
    M = idx.shape[0]
    out = torch.empty((M,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    fn = _launcher('row_gather_bulk')
    with torch.cuda.device(table.device):
        _build.check(fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                        table.shape[0], M, row_bytes, bm, window,
                        _stream(table.device)), what)
    bulk_gather.launches += 1
    return out


bulk_gather.launches = 0    # kernel launches


def block_fill(idx: Tensor, bm: int, width: int = 128) -> Tensor:
    """(M, width) int32, each block of ``bm`` rows filled with its first
    index (:func:`block_fill_reference`)."""
    if idx.device.type == 'cpu':
        return block_fill_reference(idx, bm, width)
    what = 'block_fill'
    _require(what, idx.dtype == FILL_DTYPE and idx.dim() == 1
             and idx.is_contiguous() and idx.numel() > 0,
             'idx must be contiguous 1-D int32')
    _require(what, bm > 0 and width > 0 and width % 4 == 0,
             'bm > 0 and width a multiple of 4')
    M = idx.shape[0]
    out = torch.empty((M, width), dtype=FILL_DTYPE, device=idx.device)
    fn = _launcher('row_block_fill')
    with torch.cuda.device(idx.device):
        _build.check(fn(idx.data_ptr(), out.data_ptr(), M, bm, width,
                        _stream(idx.device)), what)
    block_fill.launches += 1
    return out


block_fill.launches = 0     # kernel launches
