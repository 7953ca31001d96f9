"""The port at widths the CUDA kernels once refused, on the CPU.

The JAX package takes any ``--fusion_features`` and ``--narrow`` widths;
the port's kernels now do too (the pyramid is 2 ff + 64 wide, the latent
ff + 32, and the CUDA core reads zero-padded copies and weights where a
width does not tile: ``ops/gather_epilogue.py``). Here:

* renders of a small model (ViT 2 blocks, ResNet (1, 1, 1)) at
  fusion_features 100, 102 and 264, V = 2 and V = 3, on the default, fused
  render, reference-compatible (K9) and sorted (K5) routes, and the
  narrow 100,50,30 fast renderer, against the JAX package's on the same
  seeded inputs, weights and pyramid, within 1e-4 + 1e-4 max(1, |JAX|) as
  tests/test_torch_views.py (narrow: its 2.5e-4 relative);
* the padding is exact: each exchange kernel's plain version on the
  padded operands it launches with (the tables through ``pad_cells``,
  the weights through ``GE.pad_exchange_weights``), sliced back, equals
  it on the original ones within 1e-6 (f32);
* every width check and launch mirror (``check_core_widths``,
  ``core_plan``, ``attention_plan``, the gathers' plans and checks) takes
  fusion_features 64 to 272 (step 2) at S = 2 to 8.
"""

import jax
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.train import evaluation as JE
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.ops import epipolar_attention as EA
from cross_attention_renderer_torch.ops import fused_render as FR
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.ops import sorted_gather as SG
from cross_attention_renderer_torch.ops.grid_sample import (pack_cells,
                                                            pad_cells)
from cross_attention_renderer_torch.train import evaluation as E
from test_torch_epilogue_layout import _params, _render_case
from torch_parity import assert_close, random_flax_params

SMALL = dict(npoints=4, vit_width=32, vit_depth=2, vit_heads=2,
             resnet_layers=(1, 1, 1))
SCENE = dict(H=32, W=32, n_rays=8)
OUTPUTS = ('rgb', 'depth_ray', 'valid_mask', 'at_wt', 'pixel_val')
# route: (the port's flags, JAX's flags, the view counts it runs at)
ROUTES = {
    'default': ({}, {}, (2, 3)),
    'fused': (dict(fused_render=True), {}, (2,)),
    'compat': (dict(reference_exchange_compat=True, fused_mlp=True),
               dict(reference_exchange_compat=True), (3,)),
    'sorted': (dict(sorted_stream=True), dict(sorted_stream=True), (2, 3)),
}
WIDTHS = (100, 102, 264)
NARROW = (100, 50, 30)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case:
    """One (fusion_features, V): JAX's weights, scene and pyramid (JAX's
    encode), the port's scene and the same pyramid; JAX's renders cached
    by flags."""

    def __init__(self, ff: int, V: int):
        self.ff, self.V = ff, V
        self.jscene = jax_scene(V, n_view=V, **SCENE)
        self.jmodel = JaxRenderer(n_view=V, fusion_features=ff,
                                  fused_attention=False, **SMALL)
        self.params = random_flax_params(self.jmodel, ff, self.jscene)
        self.jz = jax.jit(lambda p, s: self.jmodel.apply(
            p, s, method='encode'))(self.params, self.jscene)
        self._jax = {}
        self.scene = make_scene(V, n_view=V, device='cpu', **SCENE)
        self.z = tuple(torch.from_numpy(np.array(x)) for x in self.jz)

    def jax_render(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._jax:
            m = JaxRenderer(n_view=self.V, fusion_features=self.ff,
                            fused_attention=False, **SMALL, **kw)
            self._jax[key] = jax.jit(lambda p, s, z: m.apply(p, s, z=z))(
                self.params, self.jscene, self.jz)
        return self._jax[key]

    def model(self, **kw) -> CrossAttentionRenderer:
        m = CrossAttentionRenderer(n_view=self.V, fusion_features=self.ff,
                                   device='cpu', **SMALL, **kw)
        m.load_state_dict(params_from_jax(self.params), strict=True)
        return m.eval()


@pytest.fixture(scope='module')
def cases():
    cache = {}

    def get(ff, V):
        if (ff, V) not in cache:
            cache[ff, V] = Case(ff, V)
        return cache[ff, V]

    return get


@pytest.mark.parametrize('route,V', [(r, V) for r in sorted(ROUTES)
                                     for V in ROUTES[r][2]])
@pytest.mark.parametrize('ff', WIDTHS)
def test_render_at_any_width_matches_jax(cases, ff, route, V):
    """Every route at fusion_features 100 (S * O = 264, 396: f rows that
    do not tile), 102 (levels of 268 channels, 268 % 8 = 4; an O of 134)
    and 264 (S * O = 888 at V = 3) against JAX's render on its route."""
    case = cases(ff, V)
    port_kw, jax_kw, _ = ROUTES[route]
    model = case.model(**port_kw)
    assert model.query_encode_latent.kernel.shape[1] == 2 * ff + 64
    with torch.no_grad():
        got = model(case.scene, z=case.z)
    want = case.jax_render(**jax_kw)
    for k in OUTPUTS:
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=1e-4)
    assert float(got['valid_mask'].mean()) > 0


def test_narrow_fast_renderer_matches_jax(cases):
    """``--narrow 100,50,30`` (levels narrowed to widths that are no
    multiple of 8, F = 180) at fusion_features 100, V = 2, against JAX's
    narrow renderer on the same pyramid (2.5e-4 relative: the PCA bases
    come from two eigh implementations)."""
    case = cases(100, 2)
    rgb, valid = E.make_fast_renderer(case.model(), 2, narrow=NARROW)(
        case.scene, case.z, case.scene['query']['uv'])
    rgb_j, valid_j = JE.make_fast_renderer(
        JaxRenderer(n_view=2, fusion_features=100, fused_attention=False,
                    **SMALL), 2, narrow=NARROW)(
        case.params, case.jscene, case.jz, case.jscene['query']['uv'])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert_close('rgb', rgb.numpy(), rgb_j, atol=1e-4, rtol=2.5e-4)


# ---------------------------------------------------------------------------
# The padding is exact
# ---------------------------------------------------------------------------

def _exchange_case(channels, O, S, M, K=16, H1=None, seed=0):
    """f32 tables (2 images of 4x4 cells a level), cells of S streams, S
    aux arrays and the ten weights."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    tables = [t(rng.standard_normal((2, 4, 4, 4 * c)).astype(np.float32))
              for c in channels]
    cells = [t(rng.integers(0, 32, S * M).astype(np.int32))
             for _ in channels]
    aux = rng.random((S, M, 16)).astype(np.float32)
    aux[:, :, 12:15] = 2 * aux[:, :, 12:15] - 1
    params = _params(sum(channels), H1 or 2 * O, O, K, S, seed=seed)
    return tables, cells, [t(a) for a in aux], params


def _padded_tables(tables, channels):
    """The tables as a launch reads them (``GE._checked_args``)."""
    return [pad_cells(t, GE.table_width(c)) for t, c in zip(tables, channels)]


PAD_CASES = [  # (channels, O, S): fusion_features 100, 102, 264, narrow
    ((264, 264, 264), 132, 2), ((268, 268, 268), 134, 2),
    ((264, 264, 264), 132, 3), ((592, 592, 592), 296, 3),
    ((100, 50, 30), 132, 2), ((100, 50, 30), 40, 5), ((36, 20, 12), 37, 3)]


@pytest.mark.parametrize('channels,O,S', PAD_CASES)
def test_exchange_padding_is_exact(channels, O, S):
    tables, cells, aux, params = _exchange_case(channels, O, S, M=24)
    mode = 'pair' if S == 2 else 'streams'
    O_core = GE.core_out_width(mode, S, O)
    ptables = _padded_tables(tables, channels)
    pparams = GE.pad_exchange_weights(params, S, channels, O_core)
    assert [t.shape[-1] for t in ptables] == [
        4 * GE.table_width(c) for c in channels]
    assert pparams[2].shape == (2 * O, O_core)
    if mode == 'pair':
        want = GE.fused_exchange_epilogue_reference(tables, cells, *aux,
                                                    params, 6)
        got = GE.fused_exchange_epilogue_reference(ptables, cells, *aux,
                                                   pparams, 6)
    else:
        want = GE.fused_exchange_epilogue_multi_reference(tables, cells,
                                                          aux, params)
        got = GE.fused_exchange_epilogue_multi_reference(ptables, cells,
                                                         aux, pparams)
    assert got[0].shape == (24, O_core)
    torch.testing.assert_close(got[0][:, :O], want[0], atol=1e-6, rtol=1e-6)
    assert not got[0][:, O:].any()
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize('repeat', [True, False])
@pytest.mark.parametrize('channels,O', [((268, 268, 268), 134),
                                        ((100, 50, 30), 132),
                                        ((36, 20, 12), 37)])
def test_render_core_padding_is_exact(channels, O, repeat):
    B, R, P = 1, 3, 4
    vals, a_s, a_c, lc, params = _render_case(B, R, P, channels, O, K=16)
    rng = np.random.default_rng(4)
    tables = [torch.from_numpy(rng.standard_normal(
        (2, 4, 4, 4 * c)).astype(np.float32)) for c in channels]
    M = B * 2 * R * P
    cells = [torch.from_numpy(rng.integers(0, 32, 2 * M).astype(np.int32))
             for _ in channels]
    params = params[:20 if repeat else 14]
    args = (torch.from_numpy(a_s), torch.from_numpy(a_c),
            torch.from_numpy(lc))
    ptables = _padded_tables(tables, channels)
    pparams = GE._padded_render(params, channels)
    want = FR.fused_render_core_reference(tables, cells, *args, params, B,
                                          R, P, repeat)
    got = FR.fused_render_core_reference(ptables, cells, *args, pparams, B,
                                         R, P, repeat)
    torch.testing.assert_close(got[0][..., :O], want[0], atol=1e-6,
                               rtol=1e-6)
    torch.testing.assert_close(got[1], want[1], atol=1e-6, rtol=1e-6)


def test_pad_cells_pads_each_corner():
    """``pad_cells`` puts each of the four corners' C channels at the start
    of its padded block, zeros after; int8 tables too; an aligned width is
    the table itself."""
    fm = torch.arange(2 * 3 * 3 * 5, dtype=torch.float32).reshape(2, 3, 3, 5)
    packed = pack_cells(fm)
    padded = pad_cells(packed, 8)
    blocks = padded.reshape(2, 3, 3, 4, 8)
    assert torch.equal(blocks[..., :5], packed.reshape(2, 3, 3, 4, 5))
    assert not blocks[..., 5:].any()
    q = pad_cells(packed.to(torch.int8), 8)
    assert q.dtype == torch.int8 and torch.equal(q.float(), padded)
    aligned = pack_cells(torch.zeros(1, 2, 2, 16))
    assert pad_cells(aligned, 16) is aligned


# ---------------------------------------------------------------------------
# Every width check and launch mirror takes every width
# ---------------------------------------------------------------------------

SWEEP = range(64, 273, 2)


@pytest.mark.parametrize('S', range(2, 9))
def test_core_takes_every_fusion_width_at_any_stream_count(S):
    """K2 (S = 2), K3 (every S), K4 and K9 at fusion_features 64 to 272:
    the levels at ``table_width``, every check passes and the plan fits a
    block's shared memory; aligned widths keep their f rows as they
    are."""
    for ff in SWEEP:
        base = 2 * ff + 64
        F, O = 3 * GE.table_width(base), base // 2
        modes = [('streams', S)] + ([('pair', 2), ('render', 2),
                                     ('mlp', 1)] if S == 2 else [])
        for mode, s in modes:
            f = 3 * base if mode == 'mlp' else F
            GE.check_core_widths('k', mode, s, f, base, O, 128, 64)
            got = GE.core_plan(mode, s, f, base, O, 128, 64)
            assert got.plan in GE.PLANS and got.smem <= GE.SMEM_LIMIT
            assert got.slots >= (1 if mode == 'mlp' else 3)
            Oc = GE.core_out_width(mode, s, O)
            assert Oc >= O and (mode == 'mlp' or (s * Oc) % 16 == 0)
            if O % 8 == 0 and (s * O) % 16 == 0:
                assert Oc == O
    for widths in (NARROW, (7, 3, 1), (33, 65, 129)):
        F = sum(GE.table_width(c) for c in widths)
        GE.check_core_widths('k', 'streams', S, F, 264, 132, 128)


def test_attention_and_gathers_take_every_width():
    """K1's launch mirror at every latent width (V = 2 to 8, their sample
    counts) and K5-K8's plans at every level width: each output chunk is
    written once."""
    for ff in SWEEP:
        C = ff + 32
        for V in range(2, 9):
            P = 64 if V <= 2 else 48
            threads, slices, smem = EA.attention_plan(V, P, C)
            assert threads % 32 == 0 and threads >= -(-C // 4)
            assert smem <= EA.SMEM_LIMIT
    for C in list(range(1, 40)) + [2 * ff + 64 for ff in SWEEP] + list(
            NARROW):
        for M in (1, 33, 1000):
            plan = SG.gather_plan(M, C, 132, 16)
            assert plan.group <= 32 and plan.depth <= plan.group
            cells = np.concatenate([SG.plan_cells(plan, M, C, b)
                                    for b in range(plan.grid)])
            assert np.array_equal(np.sort(cells),
                                  np.arange(M * SG.chunks_of(C)))


def test_odd_output_widths_take_the_odd_build(monkeypatch):
    """K2, K3 and K9 at an odd output width load the core's
    CORE_ODD_OUTPUT build, a library of its own (``_build.VARIANTS``);
    even widths, and K4 at any, the usual one."""
    from cross_attention_renderer_torch.ops import _build
    loaded = []
    monkeypatch.setattr(_build, 'load', lambda name: loaded.append(name)
                        or type('Lib', (), {'f_bf16': None})())
    for O in (132, 133):
        GE.core_entry('gather_epilogue', 'f', torch.bfloat16, O=O)
        GE.core_entry('fused_mlp', 'f', torch.bfloat16, O=O)
    GE.core_entry('fused_render', 'f', torch.bfloat16)
    assert loaded == ['gather_epilogue', 'fused_mlp', 'gather_epilogue_odd',
                      'fused_mlp_odd', 'fused_render']
    assert set(_build.VARIANTS) == {'gather_epilogue_odd',
                                    'gather_epilogue_multi_odd',
                                    'fused_mlp_odd'}
    assert (_build.library_path('gather_epilogue_odd')
            != _build.library_path('gather_epilogue'))


def test_gather_wrappers_take_every_width(monkeypatch):
    """The gathers' checks pass at widths that are no multiple of 8 and the
    launch gets the width as it is (meta tensors stand in for a card's)."""
    seen = []

    class Planned(Exception):
        pass

    def card_plan(dev, M, C, out_dtype):
        seen.append(C)
        raise Planned

    monkeypatch.setattr(SG, 'card_plan', card_plan)
    idx = torch.zeros(5, 4, dtype=torch.int32, device='meta')
    w = torch.zeros(5, 4, device='meta')
    for C in (268, 134, 100, 50, 30, 5):
        with pytest.raises(Planned):
            SG.resident_gather(torch.zeros(10, C, dtype=torch.bfloat16,
                                           device='meta'), idx, w)
    assert seen == [268, 134, 100, 50, 30, 5]
