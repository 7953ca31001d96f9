"""The row-gather probes' plain versions (``ops/experimental/row_gather.py``)
against the JAX probes' own oracle, on the CPU.

The 13 Pallas probes of ``tools/micro_kgather*.py`` check their kernels
against ``jnp.take(table, idx, axis=0, mode='clip')`` (T1-T5, T7-T10,
T12, T13) or fill each block of rows with its first index (T6, T11). The
port's entry points take their plain versions on CPU tensors; the kernels
themselves run on the card (``tests/test_torch_cuda.py``). A gather is a
copy, so the comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from cross_attention_renderer_torch.tools import _common as C

# probe -> (entry point, its options, table shape, dtype), at a small size
GATHERS = {
    'T1': ('copy', dict(bm=8, unroll=8, index='shared'), (64, 32),
           'bfloat16'),
    'T2': ('bulk', dict(bm=8, window=16), (64, 32), 'bfloat16'),
    'T3': ('copy', dict(bm=16, unroll=4), (64, 16), 'bfloat16'),
    'T4': ('copy', dict(bm=8, unroll=4), (40, 4, 8), 'bfloat16'),
    'T5': ('bulk', dict(bm=8, window=16), (40, 32), 'bfloat16'),
    'T7': ('copy', dict(bm=8, index='shared'), (50, 8), 'float32'),
    'T8': ('copy', dict(bm=8, index='shared'), (50, 32), 'bfloat16'),
    'T9': ('copy', dict(bm=8, index='shared', stage=True), (50, 8),
           'float32'),
    'T10': ('bulk', dict(bm=8, window=1), (50, 8), 'float32'),
    'T12': ('copy', dict(bm=8), (50, 8), 'float32'),
    'T13': ('copy', dict(bm=8, index='bulk'), (50, 8), 'float32'),
}
FILLS = {'T6': 8, 'T11': 16}


def test_every_probe_has_a_case():
    assert set(GATHERS) | set(FILLS) == set(C.PROBES)


@pytest.mark.parametrize('probe', sorted(C.PROBES, key=lambda p: int(p[1:])))
def test_probe_plain_version_matches_the_probes_oracle(probe):
    rng = np.random.default_rng(int(probe[1:]))
    if probe in FILLS:
        bm, M = FILLS[probe], 4 * FILLS[probe] + 3
        idx = rng.integers(-5, 100, M).astype(np.int32)
        got = RG.block_fill(torch.from_numpy(idx), bm)
        want = np.repeat(idx[::bm], bm)[:M, None] * np.ones((1, 128),
                                                            np.int32)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        return
    entry, kw, shape, dtype = GATHERS[probe]
    table = rng.standard_normal(shape).astype(np.float32)
    # indices past both ends: mode='clip' clamps them
    idx = rng.integers(-3, shape[0] + 3, 37).astype(np.int32)
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    fn = RG.copy_gather if entry == 'copy' else RG.bulk_gather
    got = fn(t, torch.from_numpy(idx), **kw)
    want = jnp.take(jnp.asarray(t.float().numpy()).astype(dtype),
                    jnp.asarray(idx), axis=0, mode='clip')
    assert got.dtype == t.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_probe_bounds_count_what_the_data_needs():
    """Each input byte is read once and each output byte written once: the
    rows written, each distinct row gathered read once (in L2 or not), the
    indices; the fill reads one index a block."""
    small = torch.zeros((8, 256), dtype=torch.float32)      # 8 KB
    big = torch.zeros((2 ** 17, 256), dtype=torch.bfloat16)  # 67 MB
    idx = torch.tensor([0, 1, 1, 1], dtype=torch.int32)
    ms, by = C.gather_bound(small, idx)
    assert by == 'bytes'
    assert ms == pytest.approx((4 * 1024 + 2 * 1024 + 16) / 3.35e12 * 1e3)
    ms, _ = C.gather_bound(big, idx)
    assert ms == pytest.approx((4 * 512 + 2 * 512 + 16) / 3.35e12 * 1e3)
    # indices past the ends read the first and last rows, once each
    ms, _ = C.gather_bound(big, torch.tensor([-4, -1, 2 ** 17, 2 ** 20],
                                             dtype=torch.int32))
    assert ms == pytest.approx((4 * 512 + 2 * 512 + 16) / 3.35e12 * 1e3)
    ms, _ = C.fill_bound(torch.zeros(2048, dtype=torch.int32), 512, 128)
    assert ms == pytest.approx((2048 * 128 + 4) * 4 / 3.35e12 * 1e3)


def _probe_launches():
    """Every gather the probe scripts run, as (kind, M, row bytes, options),
    read from the scripts' own constants."""
    from cross_attention_renderer_torch.tools import (
        micro_kgather as K1, micro_kgather2 as K2, micro_kgather3 as K3,
        micro_kgather_bisect as B1, micro_kgather_bisect2 as B2)
    out = []
    for _, c4 in K1.SHAPES:                              # T1, T2
        out += [('copy', K1.M, 2 * c4, dict(unroll=u, index='shared'))
                for u in (1, 8)]
        out.append(('bulk', K1.M, 2 * c4, dict(window=16)))
    for _, c4 in K2.SHAPES:                              # T3
        out += [('copy', K2.M, 2 * c4, dict(unroll=u)) for u in (1, 4, 8)]
    out += [('copy', 1 << logm, 512, dict()) for logm in (14, 16, 18, 20)]
    out += [('copy', K3.M, 4096, dict(unroll=u)) for u in (1, 4, 8)]  # T4
    out.append(('bulk', K3.M, 2048, dict(window=16)))    # T5
    out += [('copy', B1.M, 1024, dict(index='shared')),  # T7
            ('copy', B1.M, 2 * B1.C4, dict(index='shared')),     # T8
            ('copy', B1.M, 1024, dict(index='shared', stage=True)),  # T9
            ('bulk', B1.M, 1024, dict(window=1)),        # T10
            ('copy', B2.M, 1024, dict()),                # T12
            ('copy', B2.M, 1024, dict(index='bulk'))]    # T13
    return out


@pytest.mark.parametrize('sm_count', [1, 8, 132])
def test_launch_plan_covers_every_row_once(sm_count):
    """The gathers' launch plans (``row_gather.launch_plan``) at every shape
    the probe scripts run: at least one block, no block with more rows than
    M, the rows 0..M-1 each gathered exactly once as the kernels assign
    them, and shared memory within a block's 232,448 bytes."""
    for kind, M, row_bytes, kw in _probe_launches():
        plan = RG.launch_plan(kind, M, row_bytes, sm_count, **kw)
        assert plan.grid >= 1 and 1 <= plan.warps <= RG.MAX_WARPS
        assert plan.smem <= RG.SMEM_MAX
        runs = []
        for b in range(plan.grid):
            rows = RG.block_rows(plan, M, b)
            assert 0 < sum(len(r) for r in rows) <= M
            runs += rows
        runs.sort(key=lambda r: r.start)
        assert runs[0].start == 0 and runs[-1].stop == M
        assert all(a.stop == b.start for a, b in zip(runs, runs[1:]))
        if kind == 'copy':
            # the kernel's templates: at most 8 chunks a lane, 1-8 rows
            assert plan.unroll in (1, 2, 4, 8)
            assert plan.in_flight in (1, 2, 4, 8)
            assert plan.unroll * plan.in_flight <= RG.COPY_DEPTH
            assert plan.unroll <= kw.get('unroll', 1)
            assert kw.get('index') != 'bulk' or plan.tile % 4 == 0
        else:
            assert plan.grid * plan.warps * plan.tile >= M
            assert plan.in_flight == kw['window']
        if M >= 2 * sm_count * RG.MAX_TILE:
            assert plan.grid >= sm_count        # the card is filled


def test_launch_plan_ignores_the_probes_block_size():
    """``bm`` sets no part of a launch: the plan has no such input, and on
    the bisect probes' 2,048 rows it gives every SM of an H100 work."""
    assert 'bm' not in RG.launch_plan.__code__.co_varnames
    for kind, kw in (('copy', dict(index='shared')), ('bulk',
                                                      dict(window=1))):
        plan = RG.launch_plan(kind, 2048, 1024, 132, **kw)
        assert plan.grid >= 132


def test_launch_plan_takes_the_studys_choices():
    """The rule's knobs that ``tools/gather_study.py`` varies: fewer warps a
    block, and how far a short copy gather is spread (``fill_warps`` 0:
    every lane filled with 8 chunks of rows)."""
    for warps in (1, 4):
        plan = RG.launch_plan('bulk', 1 << 20, 2048, 132, warps=warps)
        assert plan.warps == warps
        assert plan.grid * plan.warps * plan.tile >= 1 << 20
    spread = RG.launch_plan('copy', 2048, 1024, 132, index='shared')
    packed = RG.launch_plan('copy', 2048, 1024, 132, index='shared',
                            fill_warps=0)
    assert packed.in_flight * packed.unroll == RG.COPY_DEPTH
    assert spread.in_flight < packed.in_flight


@pytest.mark.parametrize('width', [4, 128, 512])
@pytest.mark.parametrize('bm', [64, 512, 4096])
@pytest.mark.parametrize('M', [1, 777, 2000, 2048])
def test_fill_plan_covers_every_row_once(M, bm, width):
    """The block fill's launch (``launch_plan('fill')``), taken from the SM
    count (114 and 132) and never from ``bm``: each row is in exactly one
    tile of one block, a tile's row-block heads fit its shared memory, a
    thread writes at most ``FILL_DEPTH`` chunks of a tile, and the kernel's
    head lookup, run here as the kernel runs it tile by tile, gives
    ``block_fill_reference``."""
    rng = np.random.default_rng(M + bm + width)
    idx = rng.integers(-9, 9000, M).astype(np.int32)
    want = RG.block_fill_reference(torch.from_numpy(idx), bm, width).numpy()
    chunks = width // 4
    for sm_count in (114, 132):
        plan = RG.launch_plan('fill', M, width * 4, sm_count)
        assert plan == RG.launch_plan('fill', M, width * 4, sm_count,
                                      unroll=8, index='bulk')
        assert plan.grid >= 1 and 1 <= plan.warps <= RG.MAX_WARPS
        assert plan.tile * chunks <= plan.warps * 32 * RG.FILL_DEPTH
        assert plan.smem <= RG.SMEM_MAX
        got = np.full((M, width), -12345, np.int32)
        runs = []
        for b in range(plan.grid):
            rows = RG.block_rows(plan, M, b)
            assert rows and sum(len(r) for r in rows) <= M
            runs += rows
            for r in rows:
                b0, nb = RG.fill_heads(plan, M, bm, r.start // plan.tile)
                assert nb * 4 <= plan.smem
                heads = idx[(b0 + np.arange(nb)) * bm]
                got[r] = heads[np.arange(r.start, r.stop) // bm - b0, None]
        runs.sort(key=lambda r: r.start)
        assert runs[0].start == 0 and runs[-1].stop == M
        assert all(a.stop == b.start for a, b in zip(runs, runs[1:]))
        np.testing.assert_array_equal(got, want)
        if M >= 2 * sm_count:
            assert plan.grid >= sm_count        # the card is filled
