"""The port's fast-eval renderers against JAX's at V=3, and the int8 plain
versions of K2, K3 and K4, on the CPU.

* ``forward(t_vals=...)`` on the default (K3, K1) and reference-compatible
  paths against the JAX renderer with the same ``t_vals``, within 1e-4 +
  5e-4 max(1, |JAX|): on one ray of this scene the two renders differ by
  2.65e-3 (3.0e-4 of the scale 8.7; every other ray but one within 3e-5),
  where the samples' coordinates differ by 1.9e-6; the dense render of the
  same scene differs by 4.9e-4 on another ray.
* ``make_fast_renderer`` for each lever and their composition on the
  default path against JAX's, with the V=2 tests' tolerances
  (``LEVER_RTOL``, tests/torch_fast_cases.py).
* The plain packed take (``grid_sample_packed``, the take paths' gather)
  on an int8 table packed by ``pack_pyramid``, which keeps it int8: the
  rows combined in f32 (JAX ``grid_sample.py:143-157``), within 1e-6 of
  JAX's in both padding modes.
* The plain versions of K2, K3 and K4 on int8 tables (``_reference``,
  ``_reference_multi``, ``fused_render._reference`` of both packages, the
  rows cast to aux's type and combined in it): in f32 within 1e-4 of
  max(1, |JAX|); K2 and K3 in bf16 within one bf16 step (2^-5) of it, as
  tests/test_torch_ops_v3.py compares K3's bf16 references.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.ops.gather_epilogue as JGE
import cross_attention_renderer_tpu.ops.grid_sample  # noqa: F401
from cross_attention_renderer_tpu.ops import fused_render as JFR
from cross_attention_renderer_torch.ops import fused_render as FR
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.ops import grid_sample as GS
from torch_fast_cases import (  # noqa: F401
    LEVER_RTOL, LEVERS, Case, one_torch_thread)
from torch_parity import assert_close

# The JAX ops package re-exports a function under the module's name.
JGS = sys.modules['cross_attention_renderer_tpu.ops.grid_sample']


@pytest.fixture(scope='module')
def case():
    return Case(3)


@pytest.mark.parametrize('compat', [False, True], ids=['default', 'compat'])
def test_t_vals_match_jax_v3(case, compat):
    rng = np.random.default_rng(8)
    t = np.sort(rng.random((1, 3, 64, 6)), axis=-1).astype(np.float32)
    jmodel = case.jmodel.clone(reference_exchange_compat=compat)
    want = jax.jit(lambda p, s, z, t: jmodel.apply(p, s, z=z, t_vals=t))(
        case.params, case.jscene, case.jz, jnp.asarray(t))
    model = case.model(reference_exchange_compat=compat)
    with torch.no_grad():
        got = model(case.scene, z=case.z, t_vals=torch.from_numpy(t))
    for k in ('rgb', 'depth_ray', 'valid_mask', 'at_wt', 'pixel_val'):
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=5e-4)


@pytest.mark.parametrize('lever', sorted(LEVERS))
def test_fast_renderer_matches_jax_v3(case, lever):
    rgb, valid = case.port_fast(case.model(), **LEVERS[lever])
    rgb_j, valid_j = case.jax_fast(**LEVERS[lever])
    assert rgb.shape == rgb_j.shape == (1, 1, 64, 3)
    np.testing.assert_array_equal(valid, valid_j)
    assert_close('rgb', rgb, rgb_j, atol=1e-4, rtol=LEVER_RTOL[lever])


@pytest.mark.parametrize('mode', ['border', 'zeros'])
def test_int8_packed_take_matches_jax(mode):
    rng = np.random.default_rng(11)
    levels = [rng.integers(-127, 128, (2, h, h, c)).astype(np.int8)
              for h, c in ((8, 32), (16, 16))]
    coords = rng.uniform(-1.2, 1.2, (2, 300, 2)).astype(np.float32)
    packed = GS.pack_pyramid([torch.from_numpy(x) for x in levels])
    for x, table in zip(levels, packed):
        assert table.dtype == torch.int8
        got = GS.grid_sample_packed(table, torch.from_numpy(coords), mode)
        want = JGS.grid_sample_packed(JGS.pack_cells(jnp.asarray(x)),
                                      jnp.asarray(coords), mode)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-6)


# int8 plain versions: packed int8 tables (any integers in [-127, 127] are
# a table), W1's feature rows at the 1/127 scale a quantization folds in.
CHANNELS = (32, 32, 16)
F = sum(CHANNELS)
O, K = 24, 16
B, R, P = 2, 4, 6


def _int8_case(S, M, seed):
    rng = np.random.default_rng(seed)
    hw = (4, 8, 16)
    tables = [rng.integers(-127, 128, (3, h, h, 4 * c)).astype(np.int8)
              for c, h in zip(CHANNELS, hw)]
    cells = [rng.integers(0, 3 * h * h, S * M).astype(np.int32) for h in hw]
    aux = rng.random((S, M, 16)).astype(np.float32)
    aux[:, :, 12:15] = 2 * aux[:, :, 12:15] - 1
    aux[:, ::5, :12] = 0.0

    def arr(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    w1 = arr(F + 3, F)
    w1[:F] /= 127
    params = [w1, arr(F), arr(F, O), arr(O), arr(S * O, O), arr(O),
              arr(S * O, K), arr(K), arr(K, K), arr(K)]
    return tables, cells, list(aux), params


def _vals(tables, cells):
    return [t.reshape(-1, t.shape[-1])[c] for t, c in zip(tables, cells)]


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        assert_close('out', got, want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=2 ** -5 * max(
            1.0, np.abs(want).max()))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('S', [2, 3], ids=['K2', 'K3'])
def test_int8_epilogue_plain_matches_jax(S, dtype):
    """K2's and K3's entry points on the CPU (their plain versions: the
    int8 rows taken from the packed tables, then the math in aux's type)
    against JAX's references on the same rows."""
    M = 60
    tables, cells, aux, params = _int8_case(S, M, seed=S)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    t = lambda arrs, dt=dtype: [torch.from_numpy(a).to(dt) for a in arrs]
    j = lambda arrs, dt=jdt: tuple(jnp.asarray(a, dt) for a in arrs)
    i8 = [torch.from_numpy(x) for x in tables]
    c = [torch.from_numpy(x) for x in cells]
    vals = tuple(jnp.asarray(v) for v in _vals(tables, cells))
    if S == 2:
        got = GE.fused_exchange_epilogue(i8, c, *t(aux), t(params), 12)
        want = JGE._reference(vals, *j(aux), j(params), 12)
    else:
        got = GE.fused_exchange_epilogue_multi(i8, c, t(aux), t(params))
        want = JGE._reference_multi(vals, j(aux), j(params))
    for g, w in zip(got, want):
        assert g.dtype == dtype and np.asarray(w).dtype == jdt
        _close(g, w, dtype)


@pytest.mark.parametrize('repeat', [False, True])
def test_int8_render_core_plain_matches_jax(repeat):
    """K4's entry point on the CPU against JAX's ``fused_render._reference``
    on the same int8 rows, f32 aux and local coordinates: z in aux's type
    (f32), the weights f32."""
    M = B * 2 * R * P
    tables, cells, aux, params = _int8_case(2, M, seed=9)
    rng = np.random.default_rng(10)

    def arr(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    query = [arr(16, K), arr(K), arr(K, K), arr(K), arr(O, K), arr(K),
             arr(K + 16, K), arr(K), arr(K, K), arr(K)]
    lc = rng.uniform(-1, 1, (M, 16)).astype(np.float32)
    t = lambda arrs: [torch.from_numpy(a) for a in arrs]
    z, wt = FR.fused_render_core(t(tables), t(cells), *t(aux),
                                 torch.from_numpy(lc), t(params + query), B,
                                 R, P, repeat)
    vals = tuple(jnp.asarray(v) for v in _vals(tables, cells))
    z_j, wt_j = JFR._reference(vals, *map(jnp.asarray, aux), jnp.asarray(lc),
                               tuple(map(jnp.asarray, params + query)),
                               CHANNELS, B, R, P, repeat)
    assert z.dtype == wt.dtype == torch.float32
    assert z.shape == (B, R, O) and wt.shape == (B, 2, R, P)
    assert_close('z', z.numpy(), z_j, atol=1e-4, rtol=1e-4)
    assert_close('at_wt', wt.numpy(), wt_j, atol=1e-4, rtol=1e-4)
