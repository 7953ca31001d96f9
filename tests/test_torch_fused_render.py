"""The port's fused V=2 render core (K4) and the V=2 render paths around it,
against JAX.

* The core: the port's ``fused_render_core`` on the CPU (packed tables from
  ``pack_cells``, cell rows, ``index_select`` take, then the plain math)
  against JAX ``fused_render._reference`` on rows taken from JAX's
  ``pack_cells``, and against the Pallas kernel in interpret mode, the
  shapes of tests/test_fused_render.py.
* The renderer: the same random weights through ``params_from_jax`` into
  the port's ``fused_render=True`` render, its staged render (K2 and K1)
  and its unfused V=2 render (with and without K9's plain version),
  against the JAX renderer's standard CPU path (the unfused V=2 branch) and
  its fused-render path (``_use_fused_render`` forced, as
  test_fused_render.py does), with and without repeat attention.

All in f32 on the CPU; tolerance 1e-4 relative to max(1, |ref|), as both
sides do the same f32 arithmetic in another order.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.ops.grid_sample  # noqa: F401
from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.ops import fused_render as JFR
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.ops import fused_render as FR
from cross_attention_renderer_torch.ops import grid_sample as GS
from torch_parity import assert_close, random_flax_params

# The JAX ops package re-exports a function under the module's name.
JGS = sys.modules['cross_attention_renderer_tpu.ops.grid_sample']

CHANNELS = (32, 32, 16)
F = sum(CHANNELS)
O = F // 2            # latent width
HQ = 16               # attention width
B, R, P = 2, 8, 4
M = B * 2 * R * P

SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))
OUTPUTS = ('rgb', 'depth_ray', 'valid_mask', 'at_wt', 'pixel_val')
SCENE = dict(H=64, W=64, n_rays=32)


def _core_case(seed):
    """Pyramid levels, cell rows of both streams, aux, local coordinates
    and the 20 weights, as numpy."""
    rng = np.random.default_rng(seed)

    def arr(*s):
        return (rng.standard_normal(s) * 0.3).astype(np.float32)

    hw = (4, 8, 16)
    levels = [arr(3, h, h, c) for c, h in zip(CHANNELS, hw)]
    cells = [rng.integers(0, 3 * h * h, 2 * M).astype(np.int32) for h in hw]
    aux = rng.random((2, M, 16)).astype(np.float32) * 0.5
    aux[:, ::5, :12] = 0.0
    params = (arr(F + 3, F), arr(F), arr(F, O), arr(O),
              arr(2 * O, O), arr(O),
              arr(2 * O, HQ), arr(HQ), arr(HQ, HQ), arr(HQ),
              arr(16, HQ), arr(HQ), arr(HQ, HQ), arr(HQ),
              arr(O, HQ), arr(HQ),
              arr(HQ + 16, HQ), arr(HQ), arr(HQ, HQ), arr(HQ))
    return levels, cells, aux[0], aux[1], arr(M, 16), params


def _port_core(case, repeat):
    levels, cells, a_s, a_c, lc, params = case
    t = torch.from_numpy
    tables = [GS.pack_cells(t(x)) for x in levels]
    return FR.fused_render_core(tables, [t(c) for c in cells], t(a_s),
                                t(a_c), t(lc), [t(p) for p in params], B, R,
                                P, repeat)


def _jax_args(case):
    levels, cells, a_s, a_c, lc, params = case
    vals = tuple(np.asarray(JGS.pack_cells(jnp.asarray(x))).reshape(
        -1, 4 * x.shape[-1])[c] for x, c in zip(levels, cells))
    return (tuple(map(jnp.asarray, vals)), jnp.asarray(a_s),
            jnp.asarray(a_c), jnp.asarray(lc),
            tuple(map(jnp.asarray, params)))


@pytest.mark.parametrize('repeat', [False, True])
def test_core_plain_matches_jax_reference(repeat):
    case = _core_case(1)
    z, wt = _port_core(case, repeat)
    z_j, wt_j = JFR._reference(*_jax_args(case), CHANNELS, B, R, P, repeat)
    assert z.shape == (B, R, O) and wt.shape == (B, 2, R, P)
    assert_close('z', z.numpy(), z_j, atol=1e-4, rtol=1e-4)
    assert_close('at_wt', wt.numpy(), wt_j, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('repeat', [False, True])
def test_core_plain_matches_pallas_interpret(monkeypatch, repeat):
    case = _core_case(2)
    z, wt = _port_core(case, repeat)
    monkeypatch.setattr(JFR, 'RAY_BLOCK', 4)
    z_p, wt_p = JFR._pallas_forward(*_jax_args(case), CHANNELS, B, R, P,
                                    repeat, interpret=True)
    assert_close('z', z.numpy(), z_p, atol=1e-4, rtol=1e-4)
    assert_close('at_wt', wt.numpy(), wt_p, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope='module', params=[True, False],
                ids=['repeat', 'no_repeat'])
def renders(request):
    """(repeat, JAX weights, JAX outputs of the standard CPU path and of
    the fused-render path) for the small V=2 model."""
    repeat = request.param
    scene = jax_scene(3, **SCENE)
    model = JaxRenderer(n_view=2, fused_attention=False,
                        repeat_attention=repeat, **SMALL)
    params = random_flax_params(model, 0, scene)
    # A new function for each jit, so that the second trace sees the patch.
    want = {'standard': jax.jit(lambda p, s: model.apply(p, s))(params,
                                                               scene)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxRenderer, '_use_fused_render', lambda self, R: True)
        want['fused'] = jax.jit(lambda p, s: model.apply(p, s))(params,
                                                                scene)
    return repeat, params, want


def _port_render(repeat, params, **kw):
    model = CrossAttentionRenderer(device='cpu', repeat_attention=repeat,
                                   **SMALL, **kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        return model(make_scene(3, device='cpu', **SCENE))


def _assert_outputs(got, want):
    for k in OUTPUTS:
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=1e-4)
    assert float(got['valid_mask'].mean()) > 0


@pytest.mark.parametrize('path', ['standard', 'fused'])
def test_fused_render_matches_jax(renders, path):
    """The port's K4 path (its plain version on the CPU) against both JAX
    V=2 paths."""
    repeat, params, want = renders
    _assert_outputs(_port_render(repeat, params, fused_render=True),
                    want[path])


def test_staged_render_matches_jax(renders):
    """The port's default V=2 path (K2 and K1, plain) with and without the
    second attention round."""
    repeat, params, want = renders
    _assert_outputs(_port_render(repeat, params), want['standard'])


@pytest.mark.parametrize('fused_mlp', [False, True])
def test_unfused_render_matches_jax(renders, fused_mlp):
    """The port's unfused V=2 exchange, its fuse MLP plain or through K9's
    plain version, against the same branch of the JAX renderer."""
    repeat, params, want = renders
    _assert_outputs(_port_render(repeat, params, fused_epilogue=False,
                                 fused_mlp=fused_mlp), want['standard'])


def test_weight_bridge_without_repeat_attention(renders):
    """A JAX tree has round-2 modules exactly when the model has repeat
    attention, and loads strictly into the port built the same way."""
    repeat, params, _ = renders
    round2 = {'encode_latent', 'query_repeat_embed', 'query_repeat_embed_2'}
    assert (round2 <= set(params['params'])) == repeat
    state = params_from_jax(params)
    model = CrossAttentionRenderer(device='cpu', repeat_attention=repeat,
                                   **SMALL)
    assert set(state) == set(model.state_dict())
    other = CrossAttentionRenderer(device='cpu',
                                   repeat_attention=not repeat, **SMALL)
    with pytest.raises(RuntimeError):
        other.load_state_dict(state, strict=True)
