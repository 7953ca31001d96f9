"""Sorted-stream bilinear gather: the sample stream sorted by image row, and
the gathers K5 (``resident_gather``) and K6 (``windowed_gather``).

PyTorch port of ``cross_attention_renderer_tpu/ops/sorted_gather.py``
(``SortedStream``, ``sort_stream``, ``unsort``, ``_corners_flat``,
``_take_gather``, ``resident_gather``, ``windowed_gather``,
``grid_sample_sorted`` forward, ``grid_sample_pyramid_sorted``).

All four gathers of the port (K5, K6 here, K7 in ``pallas_gather``, K8 in
``experimental/banded_gather``) compute ``out[m] = sum_c w[m, c] *
T[idx[m, c]]`` from a flat (rows, C) table and corners built outside them,
and launch one CUDA routine, ``csrc/bilinear_gather.cu``, through
:func:`launch_gather`, with the launch :func:`gather_plan` takes from the
card's SM count and the shapes. On a CPU tensor each takes its plain
version, :func:`take_gather`, cast to its output type; on a CUDA tensor it
launches the kernel or raises. A launch's gradients, for the table and
the corner weights, are the plain version's, recomputed
(:func:`~cross_attention_renderer_torch.ops._autograd.kernel_call`), as
the JAX ``custom_vjp``s take the VJP of the take path.

The TPU kernels see a window of table rows per sample block, which the sort
keeps small, and add the corners outside it in a residual take pass; the
CUDA kernel reads any row, so the window arguments are checked but shape
nothing.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops._autograd import kernel_call
from cross_attention_renderer_torch.ops.grid_sample import bilinear_corners

Tensor = torch.Tensor

SAMPLE_BLOCK = 2048
BAND = 256
MAX_BANDS = 8

# The kernel's launch (csrc/bilinear_gather.cu)
GATHER_WARPS = 8        # warps a block (the kernel's kWarps)
GATHER_BATCH = 32       # samples a warp takes at a time, one a lane
GATHER_DEPTH = 4        # samples a lane has in flight: 16 row chunks
GATHER_DEPTHS = (1, 2, 4)   # the kernel's instantiations
GATHER_WAVES = 2        # waves of the blocks an SM holds in the grid


class SortedStream(NamedTuple):
    """A flattened (image-major) sample stream sorted by image row."""
    coords: Tensor       # (M, 2) ndc, sorted
    image_id: Tensor     # (M,) int32, sorted alongside
    perm: Tensor         # (M,) int32, original -> sorted gather indices
    inv_perm: Tensor     # (M,) int32, sorted -> original gather indices


def sort_stream(coords_ndc: Tensor, key_hw: tuple[int, int]) -> SortedStream:
    """Sorts a (B, N, 2) coordinate stream by image row.

    The key is the flattened (image, y, x) pixel index at ``key_hw``, the
    finest pyramid level's (H, W), so every coarser level is row-coherent
    under the same order. The sort is stable, as ``jnp.argsort``: samples
    on one pixel keep their stream order, which makes ``perm`` JAX's."""
    B, N, _ = coords_ndc.shape
    H, W = key_hw
    dev = coords_ndc.device
    x = ((coords_ndc[..., 0] + 1.0) * W * 0.5 - 0.5).clamp(0, W - 1)
    y = ((coords_ndc[..., 1] + 1.0) * H * 0.5 - 0.5).clamp(0, H - 1)
    image = torch.arange(B, dtype=torch.int32, device=dev)[:, None].expand(
        B, N)
    key = image * (H * W) + y.to(torch.int32) * W + x.to(torch.int32)
    perm = torch.argsort(key.reshape(-1), stable=True)
    inv_perm = torch.empty_like(perm)
    inv_perm[perm] = torch.arange(perm.numel(), device=dev)
    return SortedStream(
        coords=coords_ndc.reshape(B * N, 2).index_select(0, perm),
        image_id=image.reshape(-1).index_select(0, perm),
        perm=perm.to(torch.int32), inv_perm=inv_perm.to(torch.int32))


def unsort(x: Tensor, stream: SortedStream) -> Tensor:
    """(M, ...) sorted-order array -> original order."""
    return x.index_select(0, stream.inv_perm.long())


def _corners_flat(h: int, w: int, coords: Tensor, image_id: Tensor,
                  padding_mode: str) -> tuple[Tensor, Tensor]:
    """(M, 2) ndc + (M,) image id -> (M, 4) int32 corner rows of the
    (images * h * w, C) table and their (M, 4) weights, in the coords' type
    (:func:`~cross_attention_renderer_torch.ops.grid_sample.
    bilinear_corners`). Zero-weight corners are remapped to the sample's
    first corner, as JAX does so that they never widen a block's row
    window."""
    idx, wt = bilinear_corners((h, w), coords, padding_mode)
    idx = idx + (image_id * (h * w))[:, None]
    return torch.where(wt != 0, idx, idx[:, :1]), wt


def take_gather(fm_flat: Tensor, idx: Tensor, w: Tensor) -> Tensor:
    """The plain version of all four gathers (JAX ``_take_gather``): four
    row takes, each weighted in the table's type and summed in it, then
    f32. (rows, C) table, (M, 4) corners and weights -> (M, C) f32."""
    out = None
    for c in range(4):
        g = (fm_flat.index_select(0, idx[:, c].long())
             * w[:, c:c + 1].to(fm_flat.dtype))
        out = g if out is None else out + g
    return out.float()


@dataclass(frozen=True)
class GatherPlan:
    """The bilinear gather's launch: ``grid`` blocks of ``warps`` warps; a
    warp takes ``batch`` samples at a time (block b's warp w the batches b
    * warps + w + k * grid * warps), a sample ``group`` lanes (16 bytes of
    each corner row a lane, ``per_lane`` chunks of it where C / 8 exceeds
    32), a lane ``depth`` samples in flight."""
    grid: int
    warps: int
    batch: int
    group: int
    depth: int
    per_lane: int


def chunks_of(C: int) -> int:
    """The 8-channel chunks of a row of C channels (the last C % 8 wide
    where C is not a multiple of 8)."""
    return -(-C // 8)


def sample_lanes(C: int) -> int:
    """Lanes a sample of C channels takes: its chunks rounded up to a power
    of two, at most a warp."""
    return min(32, 1 << (chunks_of(C) - 1).bit_length())


def gather_plan(M: int, C: int, sm_count: int, blocks_per_sm: int, *,
                depth: int = GATHER_DEPTH) -> GatherPlan:
    """The launch of a bilinear gather of M samples of C channels on a card
    of ``sm_count`` SMs that holds ``blocks_per_sm`` blocks of the kernel an
    SM (a multiple of :func:`resident_blocks`): :func:`sample_lanes` lanes
    a sample, ``depth`` samples in flight a lane (at most the lanes of a
    group, so that the steps tile a batch), and ``blocks_per_sm`` blocks an
    SM where M has that many batches, the warps walking the rest
    grid-stride. ``depth`` and ``blocks_per_sm`` are also the knobs
    ``tools/gather_study.py`` varies."""
    if depth not in GATHER_DEPTHS:
        raise ValueError(f'gather_plan: depth in {GATHER_DEPTHS}, got {depth}')
    group = sample_lanes(C)
    batches = -(-M // GATHER_BATCH)
    grid = max(1, min(-(-batches // GATHER_WARPS),
                      sm_count * max(1, blocks_per_sm)))
    return GatherPlan(grid, GATHER_WARPS, GATHER_BATCH, group,
                      min(depth, group), -(-chunks_of(C) // group))


def plan_cells(plan: GatherPlan, M: int, C: int, block: int) -> np.ndarray:
    """The flat (sample * chunks + chunk) output chunks (8 channels, the
    last of a C that is not a multiple of 8 the rest) block ``block`` of
    ``plan`` writes, as the kernel assigns them (one entry a write)."""
    chunks = chunks_of(C)
    batches = -(-M // plan.batch)
    stride = plan.grid * plan.warps
    first = block * plan.warps
    b = np.concatenate([np.arange(w, batches, stride)
                        for w in range(first, first + plan.warps)])
    lane = np.arange(32)
    shift = plan.group.bit_length() - 1
    g, sub = lane >> shift, lane & (plan.group - 1)
    per_row = plan.batch >> shift
    # (step, d, lane): the sample of the batch; (k, lane): the chunk
    j = (np.arange(0, plan.batch, per_row * plan.depth)[:, None, None]
         + np.arange(plan.depth)[None, :, None] * per_row + g)
    c = sub + plan.group * np.arange(plan.per_lane)[:, None]
    m = b[:, None, None, None, None] * plan.batch + j[None, :, :, None, :]
    c = np.broadcast_to(c[None, None, None], m.shape[:3] + c.shape)
    m = np.broadcast_to(m, c.shape)
    keep = (m < M) & (c < chunks)
    return (m[keep].astype(np.int64) * chunks + c[keep])


_sm_counts = {}     # device index -> its SM count
_resident = {}      # (library, device index, depth, f32 out) -> blocks an SM


def _index(dev) -> int:
    index = torch.device(dev).index
    return torch.cuda.current_device() if index is None else index


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev``, read once."""
    index = _index(dev)
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sm_counts[index]


def resident_blocks(dev, depth: int, out_f32: bool) -> int:
    """Blocks of the kernel's ``depth`` / output-type instantiation an SM of
    ``dev`` holds at once (its registers and shared memory, as the CUDA
    occupancy calculator gives them), read once."""
    lib = _build.load('bilinear_gather')
    key = (lib, _index(dev), depth, bool(out_f32))
    if key not in _resident:
        fn = lib.bilinear_gather_blocks_per_sm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        blocks = ctypes.c_int(0)
        with torch.cuda.device(key[1]):
            _build.check(fn(depth, int(out_f32), ctypes.byref(blocks)),
                         'bilinear_gather_blocks_per_sm')
        _resident[key] = blocks.value
    return _resident[key]


def card_plan(dev, M: int, C: int, out_dtype: torch.dtype) -> GatherPlan:
    """The launch the wrappers take on ``dev``: :func:`gather_plan` at
    ``GATHER_DEPTH`` with the SM count and ``GATHER_WAVES`` waves of the
    blocks an SM holds of the instantiation it runs (two waves ran up to
    7% faster than one on the main paths' 256-wide inputs and at most
    1.5% slower on the 64-wide ones, ``tools/gather_study.py``
    bilinear, on an H100 80GB HBM3 at 700 W)."""
    depth = min(GATHER_DEPTH, sample_lanes(C))
    return gather_plan(M, C, sm_count(dev), GATHER_WAVES * resident_blocks(
        dev, depth, out_dtype == torch.float32), depth=depth)


def plain_gather(fm_flat: Tensor, idx: Tensor, w: Tensor,
                 out_dtype: torch.dtype) -> Tensor:
    """:func:`take_gather` in ``out_dtype``: the plain version of a launch
    of :func:`launch_gather`."""
    return take_gather(fm_flat, idx, w).to(out_dtype)


def launch_gather(kernel, entry: str, fm_flat: Tensor, idx: Tensor,
                  w: Tensor, out_dtype: torch.dtype) -> Tensor:
    """Launches ``entry`` of ``csrc/bilinear_gather.cu`` for the wrapper
    ``kernel`` (whose ``launches`` it counts) and returns (M, C) in
    ``out_dtype``, differentiable through :func:`plain_gather`.

    Takes a (rows, C) bf16 or f32 table of any C (16-byte loads where C %
    8 == 0, else the kernel's instantiation that reads a value at a time;
    an f32 table is cast to bf16 first, as the TPU wrappers cast theirs),
    (M, 4) int32 corners, (M, 4) f32 weights, all contiguous on one card,
    and a bf16 or f32 output; raises ValueError on anything else. The launch is
    :func:`gather_plan`'s, kept as ``kernel.last_plan``."""
    return kernel_call(lambda *args: _launch_gather(kernel, entry, *args),
                       plain_gather, fm_flat, idx, w, out_dtype)


def _launch_gather(kernel, entry, fm_flat, idx, w, out_dtype):
    what = kernel.__name__
    dev = fm_flat.device

    def require(cond, msg):
        if not cond:
            raise ValueError(f'{what}: {msg}')

    require(fm_flat.dim() == 2 and fm_flat.dtype in (torch.bfloat16,
                                                     torch.float32)
            and fm_flat.is_contiguous(),
            'the table must be a contiguous (rows, C) bf16 or f32 tensor')
    rows, C = fm_flat.shape
    M = idx.shape[0]
    require(C > 0 and rows > 0, f'C > 0 and rows > 0, got '
            f'{tuple(fm_flat.shape)}')
    require(idx.device == dev and idx.dtype == torch.int32
            and idx.is_contiguous() and idx.dim() == 2
            and idx.shape[1] == 4 and 0 < M < 2 ** 31 - GATHER_BATCH,
            f'idx must be contiguous (M > 0, 4) int32 on {dev}, M < 2^31')
    require(w.device == dev and w.dtype == torch.float32
            and w.is_contiguous() and tuple(w.shape) == (M, 4),
            f'w must be contiguous ({M}, 4) f32 on {dev}')
    require(out_dtype in (torch.bfloat16, torch.float32),
            f'output type bf16 or f32, got {out_dtype}')
    table = fm_flat.to(torch.bfloat16)
    out = torch.empty((M, C), dtype=out_dtype, device=dev)
    require(all(t.data_ptr() % 16 == 0 for t in (table, idx, w)),
            'tensors must be 16-byte aligned')

    plan = card_plan(dev, M, C, out_dtype)
    run_gather(entry, plan, table, idx, w, out, what)
    kernel.launches += 1
    kernel.last_plan = plan
    return out


def run_gather(entry: str, plan: GatherPlan, table: Tensor, idx: Tensor,
               w: Tensor, out: Tensor, what: str = 'bilinear gather') -> None:
    """Launches ``entry`` of ``csrc/bilinear_gather.cu`` with ``plan`` on
    checked operands (a bf16 table), writing ``out``; counts no launch.
    Raises on a refused launch."""
    fn = getattr(_build.load('bilinear_gather'), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(fn(table.data_ptr(), idx.data_ptr(), w.data_ptr(),
                        out.data_ptr(), int(out.dtype == torch.float32),
                        idx.shape[0], table.shape[1], table.shape[0],
                        plan.group.bit_length() - 1, plan.depth, plan.grid,
                        stream), what)


def _check_positive(what: str, **sizes: int) -> None:
    for name, v in sizes.items():
        if not (isinstance(v, int) and v > 0):
            raise ValueError(f'{what}: {name} must be a positive int, got '
                             f'{v!r}')


def resident_gather(fm_flat: Tensor, idx: Tensor, w: Tensor,
                    sample_block: int = SAMPLE_BLOCK, window: int = 0,
                    out_dtype: Optional[torch.dtype] = None) -> Tensor:
    """(rows, C) table + (M, 4) corners and weights -> (M, C) in
    ``out_dtype`` (default the table's type): kernel K5.

    ``sample_block`` and ``window`` (0 picks the TPU's width) shaped the TPU
    kernel's blocks; they are checked and shape nothing here. CPU tensors
    take :func:`take_gather`; CUDA tensors launch the kernel or raise."""
    _check_positive('resident_gather', sample_block=sample_block)
    if not (isinstance(window, int) and window >= 0):
        raise ValueError(f'resident_gather: window must be an int >= 0, got '
                         f'{window!r}')
    out_dtype = out_dtype or fm_flat.dtype
    if fm_flat.device.type == 'cpu':
        return plain_gather(fm_flat, idx, w, out_dtype)
    return launch_gather(resident_gather, 'resident_gather_bf16', fm_flat,
                         idx, w, out_dtype)


resident_gather.launches = 0   # kernel launches, for the chip smoke test
resident_gather.last_plan = None


def windowed_gather(fm_flat: Tensor, idx: Tensor, w: Tensor,
                    sample_block: int = SAMPLE_BLOCK, band: int = BAND,
                    max_bands: int = MAX_BANDS) -> Tensor:
    """(rows, C) table + (M, 4) corners and weights -> (M, C) f32: kernel
    K6. No path of the renderer calls it (in the JAX package only tools
    and tests do).

    ``sample_block``, ``band`` and ``max_bands`` shaped the TPU kernel's
    grid; they are checked and shape nothing here. CPU tensors take
    :func:`take_gather`; CUDA tensors launch the kernel or raise."""
    _check_positive('windowed_gather', sample_block=sample_block, band=band,
                    max_bands=max_bands)
    if fm_flat.device.type == 'cpu':
        return take_gather(fm_flat, idx, w)
    return launch_gather(windowed_gather, 'windowed_gather_bf16', fm_flat,
                         idx, w, torch.float32)


windowed_gather.launches = 0   # kernel launches
windowed_gather.last_plan = None


def grid_sample_sorted(fm: Tensor, coords: Tensor, image_id: Tensor,
                       padding_mode: str = 'border') -> Tensor:
    """Bilinear sample of (B, H, W, C) maps at a flat stream (forward of
    JAX ``grid_sample_sorted``; its custom VJP comes with training).

    Args:
      fm: (B, H, W, C) feature maps.
      coords: (M, 2) ndc coords (torch grid_sample convention,
        align_corners=False), ideally row-sorted (:func:`sort_stream`).
      image_id: (M,) int32 image of each sample.
      padding_mode: 'border' or 'zeros'.

    Returns:
      (M, C) samples in ``fm``'s type, through K5."""
    B, H, W, C = fm.shape
    idx, w = _corners_flat(H, W, coords.float(), image_id, padding_mode)
    return resident_gather(fm.reshape(B * H * W, C), idx, w,
                           out_dtype=fm.dtype)


def grid_sample_pyramid_sorted(pyramid: Sequence[Tensor],
                               stream: SortedStream,
                               padding_mode: str = 'border') -> Tensor:
    """Every pyramid level sampled at a sorted stream, channels
    concatenated; (M, sum C_l) in SORTED order (:func:`unsort` restores)."""
    return torch.cat([grid_sample_sorted(fm, stream.coords, stream.image_id,
                                         padding_mode) for fm in pyramid],
                     dim=-1)
