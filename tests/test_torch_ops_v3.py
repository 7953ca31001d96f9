"""The port's V=3 ops against JAX: the S-stream epilogue (K3), the fused MLP
(K9) and the bilinear gathers of the unfused exchange.

Same numpy inputs from a seed through both, on the CPU, where the port's
kernel wrappers run their plain versions. Tolerances: 1e-4 (relative to
max(1, |ref|)) where both sides do the same f32 arithmetic in another
order; in bf16, 2^-5 of max(1, |ref|), one bf16 step of the output, where
both round at the same places but sum in another order; the JAX package's
own Pallas-vs-reference tolerances (atol 2e-2, rtol 2e-3) where a Pallas
kernel runs in interpret mode.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.ops.gather_epilogue as JGE
import cross_attention_renderer_tpu.ops.grid_sample  # noqa: F401
from cross_attention_renderer_tpu.ops.experimental import fused_mlp as JFM
from cross_attention_renderer_torch.ops import fused_mlp as FM
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.ops import grid_sample as GS
from torch_parity import assert_close

# The JAX ops package re-exports a function under the module's name.
JGS = sys.modules['cross_attention_renderer_tpu.ops.grid_sample']

CHANNELS = (32, 32, 16)     # small stand-ins for (256, 256, 64)
F = sum(CHANNELS)
H1, LD, HID = F, 48, 16
S = 3                       # streams at V=3: self, cross_0, cross_1


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _multi_case(M, seed=0):
    """Packed tables, stream-major cell rows, S aux arrays, weights."""
    rng = np.random.default_rng(seed)
    hw = (4, 8, 16)
    tables = [rng.standard_normal((3, h, h, 4 * c)).astype(np.float32)
              for c, h in zip(CHANNELS, hw)]
    cells = [rng.integers(0, 3 * h * h, S * M).astype(np.int32) for h in hw]
    aux = rng.random((S, M, 16)).astype(np.float32)
    aux[:, :, 12:15] = 2 * aux[:, :, 12:15] - 1
    aux[:, ::7, :12] = 0.0
    shapes = ((F + 3, H1), (H1,), (H1, LD), (LD,), (S * LD, LD), (LD,),
              (S * LD, HID), (HID,), (HID, HID), (HID,))
    params = [(rng.standard_normal(s) / np.sqrt(s[0] if len(s) == 2 else 10)
               ).astype(np.float32) for s in shapes]
    return tables, cells, list(aux), params


def _taken(tables, cells):
    return [t.reshape(-1, t.shape[-1])[c] for t, c in zip(tables, cells)]


def test_epilogue_multi_reference_matches_jax_reference():
    tables, cells, aux, params = _multi_case(M=97)     # ragged M
    vals = _taken(tables, cells)
    t = lambda arrs: [torch.from_numpy(a) for a in arrs]
    jl, kv = GE._reference_multi(t(vals), t(aux), t(params))
    jl_j, kv_j = JGE._reference_multi(
        tuple(map(jnp.asarray, vals)), tuple(map(jnp.asarray, aux)),
        tuple(map(jnp.asarray, params)))
    assert_close('jl', _np(jl), jl_j, atol=1e-4, rtol=1e-4)
    assert_close('kv', _np(kv), kv_j, atol=1e-4, rtol=1e-4)


def test_epilogue_multi_bf16_reference_matches_jax():
    """In bf16 both references round each stream's products at the same
    places."""
    tables, cells, aux, params = _multi_case(M=97, seed=1)
    vals = _taken(tables, cells)
    bf = lambda arrs: [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    jb = lambda arrs: tuple(jnp.asarray(a, jnp.bfloat16) for a in arrs)
    jl, kv = GE._reference_multi(bf(vals), bf(aux), bf(params))
    jl_j, kv_j = JGE._reference_multi(jb(vals), jb(aux), jb(params))
    for got, want in ((jl, jl_j), (kv, kv_j)):
        want = _np(want)
        np.testing.assert_allclose(_np(got), want, atol=2 ** -5 * max(
            1.0, np.abs(want).max()))


def test_epilogue_multi_with_row_take_matches_pallas_interpret(monkeypatch):
    """The port's entry (tables + stream-major cell rows, plain
    index_select take on the CPU) against JAX's take followed by its
    multi-stream Pallas kernel."""
    M = 192
    tables, cells, aux, params = _multi_case(M, seed=2)
    jl, kv = GE.fused_exchange_epilogue_multi(
        [torch.from_numpy(t) for t in tables],
        [torch.from_numpy(c) for c in cells],
        tuple(torch.from_numpy(a) for a in aux),
        [torch.from_numpy(p) for p in params])
    vals_j = tuple(jnp.take(jnp.asarray(t).reshape(-1, t.shape[-1]),
                            jnp.asarray(c), axis=0, mode='clip')
                   for t, c in zip(tables, cells))
    monkeypatch.setattr(JGE, 'BLOCK_M', 64)
    jl_p, kv_p = JGE._pallas_forward_multi(
        vals_j, tuple(map(jnp.asarray, aux)),
        tuple(map(jnp.asarray, params)), interpret=True)
    np.testing.assert_allclose(_np(jl), _np(jl_p), atol=2e-2, rtol=2e-3)
    np.testing.assert_allclose(_np(kv), _np(kv_p), atol=2e-2, rtol=2e-3)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_fused_mlp_plain_matches_jax(dtype):
    """K9's plain version against JAX ``fused_mlp2`` off the TPU."""
    rng = np.random.default_rng(3)
    M, K1, H, O = 133, 96, 80, 40
    x1 = rng.standard_normal((M, K1)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (M, 3)).astype(np.float32)
    w = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for s in ((K1, H), (3, H), (H,), (H, O), (O,))]
    tdt = getattr(torch, dtype)
    out = FM.fused_mlp2(torch.from_numpy(x1).to(tdt),
                        torch.from_numpy(x2).to(tdt),
                        *[torch.from_numpy(a) for a in w])
    want = JFM.fused_mlp2(jnp.asarray(x1, dtype), jnp.asarray(x2, dtype),
                          *map(jnp.asarray, w))
    assert out.dtype == tdt and out.shape == (M, O)
    if dtype == 'float32':
        assert_close('out', _np(out), want, atol=1e-4, rtol=1e-4)
    else:
        want = _np(want)
        np.testing.assert_allclose(_np(out), want, atol=2 ** -5 * max(
            1.0, np.abs(want).max()))


def _gather_coords(seed, B, N):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(-1.3, 1.3, (B, N, 2)).astype(np.float32)
    # far projections (the 1e10 sentinel of project_pinhole) and edges
    coords[0, :5] = [[1e10, 0.0], [-1e10, 0.5], [0.0, 1e10], [1.0, -1.0],
                     [-1.0, 1.0]]
    return coords


@pytest.mark.parametrize('mode', ['border', 'zeros'])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_grid_sample_packed_matches_jax(mode, dtype):
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 6, 9, 8)).astype(np.float32)
    coords = _gather_coords(5, 2, 70)
    packed = GS.pack_cells(torch.from_numpy(feats).to(getattr(torch, dtype)))
    got = GS.grid_sample_packed(packed, torch.from_numpy(coords), mode)
    want = JGS.grid_sample_packed(
        JGS.pack_cells(jnp.asarray(feats, dtype)), jnp.asarray(coords), mode)
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


@pytest.mark.parametrize('mode', ['border', 'zeros'])
def test_grid_sample_pyramid_matches_jax(mode):
    rng = np.random.default_rng(6)
    pyramid = [rng.standard_normal((3, h, h, c)).astype(np.float32)
               for h, c in ((4, 16), (8, 16), (16, 8))]
    coords = _gather_coords(7, 3, 50)
    got = GS.grid_sample_pyramid([torch.from_numpy(p) for p in pyramid],
                                 torch.from_numpy(coords), mode)
    got_packed = GS.grid_sample_pyramid_packed(
        GS.pack_pyramid([torch.from_numpy(p) for p in pyramid]),
        torch.from_numpy(coords), mode)
    want = JGS.grid_sample_pyramid(tuple(map(jnp.asarray, pyramid)),
                                   jnp.asarray(coords), mode)
    assert got.shape == (3, 50, 40)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    np.testing.assert_array_equal(_np(got_packed), _np(got))
