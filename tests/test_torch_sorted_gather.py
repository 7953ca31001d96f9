"""The port's gathers K5-K8 (their plain versions), the sorted stream and
the corner builders, against JAX.

Same numpy inputs from a seed through both, on the CPU. The JAX side runs
its Pallas kernels in interpret mode, as the JAX package's own tests do
(``pl.pallas_call`` patched to ``interpret=True``, ``SG._on_tpu`` patched to
True, small sample blocks and bands), so its residual take passes and band
windows run too. The port's wrappers take their plain version,
``take_gather``, on CPU tensors. Tolerances: exact for the sort and the
corner rows; 1e-6 for the corner weights (the same f32 arithmetic);
atol 2e-2 + rtol 2e-2 of max(1, |want|) for the gathers, the JAX tests'
bf16 grade, since the JAX kernels round the table and their selector
weights to bf16 and the port's plain version on an f32 table does not.
"""

import sys

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.ops.grid_sample  # noqa: F401
from cross_attention_renderer_tpu.ops import pallas_gather as JPG
from cross_attention_renderer_tpu.ops import sorted_gather as JSG
from cross_attention_renderer_tpu.ops.experimental import (
    banded_gather as JBG)
from cross_attention_renderer_torch.ops import pallas_gather as PG
from cross_attention_renderer_torch.ops import sorted_gather as SG
from cross_attention_renderer_torch.ops.experimental import (
    banded_gather as BG)
from torch_parity import assert_close

# The JAX ops package re-exports a function under the module's name.
JGS = sys.modules['cross_attention_renderer_tpu.ops.grid_sample']

GATHER_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture
def interpret(monkeypatch):
    """JAX's Pallas kernels in interpret mode, the sorted gather's kernel
    path taken off the TPU, and small blocks and bands."""
    orig = pl.pallas_call
    monkeypatch.setattr(pl, 'pallas_call',
                        lambda *a, **kw: orig(*a, interpret=True, **kw))
    monkeypatch.setattr(JSG, '_on_tpu', lambda: True)
    monkeypatch.setattr(JBG, 'SAMPLE_BLOCK', 64)
    monkeypatch.setattr(JBG, 'BAND_POSITIONS', 128)


def _coords(rng, B, N, lo=-1.2, hi=1.2, far=False):
    """(B, N, 2) ndc coords; with ``far``, some of them projections far
    outside the image (up to 3e9 and the 1e10 sentinel)."""
    c = rng.uniform(lo, hi, (B, N, 2)).astype(np.float32)
    if far:
        c[0, :6] = [[1e10, 0.0], [-1e10, 0.3], [0.1, 3e9], [-3e9, -3e9],
                    [2e8, -0.5], [0.99, -1e9]]
    return c


def _tied_stream(rng, B, N, H, W):
    """Coords on few pixel centres, several samples a pixel, and far
    projections: a stream full of sort-key ties."""
    px = rng.integers(0, W, (B, N // 4))
    py = rng.integers(0, H, (B, N // 4))
    pick = rng.integers(0, N // 4, (B, N))
    x = (2 * np.take_along_axis(px, pick, 1) + 1) / W - 1
    y = (2 * np.take_along_axis(py, pick, 1) + 1) / H - 1
    c = np.stack([x, y], -1).astype(np.float32)
    c[:, ::9] += rng.uniform(-0.02, 0.02, c[:, ::9].shape).astype(np.float32)
    c[1, :4] = [[1e10, 1e10], [-1e10, 0.0], [0.0, 3e9], [1e10, 1e10]]
    return c


def test_sort_stream_matches_jax_exactly():
    """perm, inv_perm, coords and image_id equal JAX's: the sort must be
    stable, as ``jnp.argsort`` is, or ties would order differently."""
    rng = np.random.default_rng(0)
    c = _tied_stream(rng, 3, 240, 16, 16)
    got = SG.sort_stream(torch.from_numpy(c), (16, 16))
    want = JSG.sort_stream(jnp.asarray(c), (16, 16))
    for name in ('perm', 'inv_perm', 'image_id', 'coords'):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got.perm.dtype == got.inv_perm.dtype == torch.int32
    np.testing.assert_array_equal(
        SG.unsort(got.coords, got).numpy(), c.reshape(-1, 2))


@pytest.mark.parametrize('mode', ['border', 'zeros'])
def test_corner_builders_match_jax(mode):
    """``_corners_flat`` (K5, K6) and ``_corner_indices`` (K7, K8) at coords
    up to 3e9 and the 1e10 sentinel, which overflow a float-to-int32
    conversion unless clamped first. ``_corners_flat`` remaps zero-weight
    corners, so its rows equal JAX's everywhere; ``_corner_indices`` does
    not, so its rows are compared where the weight is not 0."""
    rng = np.random.default_rng(1)
    c = _coords(rng, 2, 100, far=True)
    image_id = rng.integers(0, 4, 200).astype(np.int32)
    idx, w = SG._corners_flat(6, 10, torch.from_numpy(c.reshape(-1, 2)),
                              torch.from_numpy(image_id), mode)
    idx_j, w_j = JSG._corners_flat(6, 10, jnp.float32,
                                   jnp.asarray(c.reshape(-1, 2)),
                                   jnp.asarray(image_id), mode)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-6)

    idx, w = PG._corner_indices((2, 6, 10, 8), torch.from_numpy(c), mode)
    idx_j, w_j = JPG._corner_indices((2, 6, 10, 8), jnp.asarray(c), mode)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-6)
    live = np.asarray(w_j) != 0
    np.testing.assert_array_equal(idx.numpy()[live], np.asarray(idx_j)[live])


@pytest.mark.parametrize('mode', ['border', 'zeros'])
def test_grid_sample_sorted_matches_jax_kernel(interpret, mode):
    """K5 through ``grid_sample_sorted`` on a sorted stream with ties and far
    projections; the unsorted result also equals JAX's plain gather."""
    rng = np.random.default_rng(2)
    B, H, W, C = 2, 16, 16, 32
    fm = rng.standard_normal((B, H, W, C)).astype(np.float32)
    c = _tied_stream(rng, B, 120, H, W)
    s = SG.sort_stream(torch.from_numpy(c), (H, W))
    got = SG.grid_sample_sorted(torch.from_numpy(fm), s.coords, s.image_id,
                                mode)
    sj = JSG.sort_stream(jnp.asarray(c), (H, W))
    want = JSG.grid_sample_sorted(jnp.asarray(fm), sj.coords, sj.image_id,
                                  mode)
    assert got.shape == (B * 120, C) and got.dtype == torch.float32
    assert_close('K5', got.numpy(), want, **GATHER_TOL)
    assert_close('K5 unsorted', SG.unsort(got, s).reshape(B, 120, C).numpy(),
                 JGS.grid_sample(jnp.asarray(fm), jnp.asarray(c), mode),
                 atol=1e-5, rtol=1e-5)


def _adversarial(rng, rows=4096, C=16, M=512):
    """An unsorted stream whose sample blocks span the whole table, so the
    JAX kernels' residual take passes run."""
    fm = rng.standard_normal((rows, C)).astype(np.float32)
    idx = rng.integers(0, rows - 1, (M, 4)).astype(np.int32)
    w = rng.uniform(0, 1, (M, 4)).astype(np.float32)
    w[::5, 2:] = 0.0
    return fm, idx, w


@pytest.mark.parametrize('sort', [True, False], ids=['sorted', 'adversarial'])
def test_resident_and_windowed_gather_match_jax_kernels(interpret, sort):
    rng = np.random.default_rng(3)
    fm, idx, w = _adversarial(rng)
    if sort:
        idx = np.sort(idx, axis=0)
    args = [torch.from_numpy(a) for a in (fm, idx, w)]
    jargs = [jnp.asarray(a) for a in (fm, idx, w)]
    got = SG.resident_gather(*args, sample_block=128, window=256)
    want = JSG.resident_gather(*jargs, sample_block=128, window=256)
    assert got.dtype == torch.float32
    assert_close('K5', got.numpy(), want, **GATHER_TOL)
    got = SG.windowed_gather(*args, sample_block=128, band=128, max_bands=4)
    want = JSG.windowed_gather(*jargs, sample_block=128, band=128,
                               max_bands=4)
    assert got.dtype == torch.float32
    assert_close('K6', got.numpy(), want, **GATHER_TOL)


@pytest.mark.parametrize('mode', ['border', 'zeros'])
def test_onehot_and_banded_match_jax_kernels(interpret, mode):
    """K7 (``grid_sample_pallas``) and K8 (``grid_sample_banded``) on an
    epipolar-like stream with far projections."""
    rng = np.random.default_rng(4)
    B, H, W, C = 2, 16, 16, 32
    fm = rng.standard_normal((B, H, W, C)).astype(np.float32)
    start = rng.uniform(-1, 1, (B, 12, 1, 2))
    end = rng.uniform(-1.3, 1.3, (B, 12, 1, 2))
    t = np.linspace(0, 1, 10)[None, None, :, None]
    c = (start + (end - start) * t).reshape(B, 120, 2).astype(np.float32)
    c[0, :6] = _coords(rng, 1, 6, far=True)[0, :6]
    for name, port, jax_fn in (
            ('K7', PG.grid_sample_pallas, JPG.grid_sample_pallas),
            ('K8', BG.grid_sample_banded, JBG.grid_sample_banded)):
        got = port(torch.from_numpy(fm), torch.from_numpy(c), mode)
        want = jax_fn(jnp.asarray(fm), jnp.asarray(c), mode)
        assert got.shape == (B, 120, C) and got.dtype == torch.float32
        assert_close(name, got.numpy(), want, **GATHER_TOL)


def test_plain_gathers_keep_their_output_types():
    """On a bf16 table: K5 the type asked for (default the table's), K6
    f32, K7 and K8 the table's. All four equal ``take_gather`` cast."""
    rng = np.random.default_rng(5)
    fm, idx, w = (torch.from_numpy(a) for a in _adversarial(rng, 64, 8, 40))
    fm = fm.bfloat16()
    want = SG.take_gather(fm, idx, w)
    assert want.dtype == torch.float32
    for got, dtype in ((SG.resident_gather(fm, idx, w), torch.bfloat16),
                       (SG.resident_gather(fm, idx, w,
                                           out_dtype=torch.float32),
                        torch.float32),
                       (SG.windowed_gather(fm, idx, w), torch.float32),
                       (PG.onehot_gather(fm, idx, w), torch.bfloat16),
                       (BG.banded_gather(fm, idx, w), torch.bfloat16)):
        assert got.dtype == dtype
        assert torch.equal(got, want.to(dtype))


def test_wrappers_refuse_what_the_kernel_cannot_take(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version: the
    wrappers check it for the kernel and raise (meta tensors stand in for a
    card's). A width that is not a multiple of 8 is taken (the kernel reads
    such rows a value at a time): it reaches the launch plan."""
    meta = dict(device='meta')
    idx = torch.zeros(5, 4, dtype=torch.int32, **meta)
    w = torch.zeros(5, 4, **meta)
    for fm in (torch.zeros(10, 16, dtype=torch.float16, **meta),
               torch.zeros(0, 16, dtype=torch.bfloat16, **meta),
               torch.zeros(16, 10, dtype=torch.bfloat16, **meta).t()):
        for fn in (SG.resident_gather, SG.windowed_gather, PG.onehot_gather,
                   BG.banded_gather):
            with pytest.raises(ValueError):
                fn(fm, idx, w)

    class Planned(Exception):
        pass

    def card_plan(dev, M, C, out_dtype):
        raise Planned(C)

    monkeypatch.setattr(SG, 'card_plan', card_plan)
    for fn in (SG.resident_gather, SG.windowed_gather, PG.onehot_gather,
               BG.banded_gather):
        with pytest.raises(Planned, match='12'):
            fn(torch.zeros(10, 12, dtype=torch.bfloat16, **meta), idx, w)
    fm = torch.zeros(10, 16, dtype=torch.bfloat16, **meta)
    with pytest.raises(ValueError):
        SG.resident_gather(fm, idx.long(), w)
    with pytest.raises(ValueError):
        SG.resident_gather(fm, idx, w, window=-1)
    with pytest.raises(ValueError):
        SG.windowed_gather(fm, idx, w, band=0)


@pytest.mark.parametrize('gather,shape,route', [
    ('take', (2, 8, 8, 16), 'take'),
    ('onehot', (2, 8, 8, 16), 'onehot'),
    ('onehot', (2, 64, 64, 520), 'onehot'),
    ('banded', (2, 64, 64, 256), 'banded'),      # exactly 4 MiB in bf16
    ('banded', (2, 64, 64, 264), 'take'),
])
def test_grid_sample_auto_routes_as_jax(monkeypatch, gather, shape, route):
    """JAX ``grid_sample_auto``'s precedence, the argument standing in for
    its environment switches: K8 only for tables of at most 4 MiB."""
    seen = []

    def stand_in(name):
        return lambda f, c, m: seen.append(name) or name

    monkeypatch.setattr(PG, 'grid_sample', stand_in('take'))
    monkeypatch.setattr(PG, 'grid_sample_pallas', stand_in('onehot'))
    monkeypatch.setattr(BG, 'grid_sample_banded', stand_in('banded'))
    features = torch.empty(shape, dtype=torch.bfloat16)
    assert PG.grid_sample_auto(features, None, 'zeros', gather) == route
    assert seen == [route]
    with pytest.raises(ValueError):
        PG.grid_sample_auto(features, None, 'zeros', 'windowed')


@pytest.mark.parametrize('sm_count', [114, 132])
@pytest.mark.parametrize('M', [1, 1003, 4097, 1 << 20])
@pytest.mark.parametrize('C', [32, 64, 256])
def test_gather_plan_covers_every_chunk_once(C, M, sm_count):
    """The bilinear gather's launch (``sorted_gather.gather_plan``) at the
    paths' widths and sizes (1,048,576 samples is K8's case), ragged M and
    two SM counts, at every depth the kernel is built for and 1 to 8
    resident blocks an SM: the (sample, 16-byte chunk) pairs of the
    output, as the kernel assigns them to its blocks' warps and lanes
    (``plan_cells``), are each written exactly once; a group of lanes is
    C / 8 rounded up to a power of two; the steps of ``depth`` samples
    tile a warp's batch; the grid is one wave of the resident blocks where
    M has that many batches."""
    chunks = C // 8
    for depth, blocks in zip(SG.GATHER_DEPTHS, (8, 3, 1)):
        plan = SG.gather_plan(M, C, sm_count, blocks, depth=depth)
        assert plan.group == SG.sample_lanes(C) == min(32, chunks)
        assert plan.per_lane == 1 and plan.depth == min(depth, plan.group)
        assert plan.batch % ((plan.batch // plan.group) * plan.depth) == 0
        batches = -(-M // plan.batch)
        assert plan.grid == min(sm_count * blocks,
                                -(-batches // plan.warps))
        counts = np.zeros(M * chunks, np.uint8)
        written = 0
        for block in range(plan.grid):
            cells = SG.plan_cells(plan, M, C, block)
            written += cells.size
            counts[cells] += 1
        # as many writes as chunks, and each chunk written: once each
        assert written == M * chunks and bool((counts == 1).all())


def test_gather_plan_takes_any_width():
    """Widths past a warp's 32 chunks give a lane several chunks of a row;
    widths that are no power of two leave the group's last lanes idle.
    Either way every chunk is written once."""
    for C, group, per_lane in ((8, 1, 1), (40, 8, 1), (520, 32, 3),
                               (1024, 32, 4)):
        M = 77
        plan = SG.gather_plan(M, C, 132, 3)
        assert (plan.group, plan.per_lane) == (group, per_lane)
        cells = np.concatenate([SG.plan_cells(plan, M, C, b)
                                for b in range(plan.grid)])
        assert np.array_equal(np.sort(cells), np.arange(M * (C // 8)))
    with pytest.raises(ValueError):
        SG.gather_plan(100, 64, 132, 3, depth=3)


def test_bilinear_bound_counts_what_the_data_needs():
    """K5-K8's bound: the distinct rows of live corners read once, 32 bytes
    of corners and weights a sample, the output written once; bytes, not
    the f32 multiply-adds, at every width."""
    from cross_attention_renderer_torch.tools import _common as C
    table = torch.zeros((1000, 64), dtype=torch.bfloat16)
    idx = torch.tensor([[0, 1, 2, 3], [3, 3, 3, 999]], dtype=torch.int32)
    w = torch.tensor([[1, 1, 1, 0], [1, 0, 0, 0]], dtype=torch.float32)
    for out, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        ms, by = C.bilinear_bound(table, idx, w, out)
        assert by == 'bytes'
        # rows 0, 1, 2 and 3 live; 999 and the other 3s carry weight 0
        assert ms == pytest.approx(
            (4 * 64 * 2 + 2 * 32 + 2 * 64 * size) / 3.35e12 * 1e3)
