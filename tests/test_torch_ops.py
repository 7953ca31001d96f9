"""The port's gather, epilogue (K2) and attention (K1) ops against JAX.

Same numpy inputs from a seed through both, in f32 on the CPU, where the
port's kernel wrappers run their plain versions. The JAX side runs its jnp
references and its Pallas kernels in interpret mode, as the JAX package's
own tests do. Tolerances: 1e-5 where both sides do the same f32 arithmetic
in another order; the JAX package's own Pallas-vs-reference tolerances
(atol 2e-2, rtol 2e-3 for the epilogue) where a Pallas kernel is involved.
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.ops.epipolar_attention as JEA
import cross_attention_renderer_tpu.ops.gather_epilogue as JGE
import cross_attention_renderer_tpu.ops.grid_sample  # noqa: F401
from cross_attention_renderer_torch.ops import epipolar_attention as EA
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.ops import grid_sample as GS

# The JAX ops package re-exports a function under the module's name.
JGS = sys.modules['cross_attention_renderer_tpu.ops.grid_sample']

CHANNELS = (32, 32, 16)     # small stand-ins for (256, 256, 64)
F = sum(CHANNELS)
H1, LD, HID = F, F // 2, 16
RP = 64                     # R * P per (b, v)
M = 4 * RP                  # B=2 interleaved with V=2


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _attention_inputs(B=2, V=2, R=100, P=16, D=32, C=40, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32)
            for s in ((B, V, R, P, D), (B, V, R, P, D), (B, V, R, P, C))]


def test_attention_plain_matches_jax_reference():
    q, k, v = _attention_inputs()
    out, wt = EA.epipolar_attention(*map(torch.from_numpy, (q, k, v)))
    out_j, wt_j = JEA.epipolar_attention_reference(*map(jnp.asarray,
                                                        (q, k, v)))
    np.testing.assert_allclose(_np(out), _np(out_j), atol=1e-5)
    np.testing.assert_allclose(_np(wt), _np(wt_j), atol=1e-6)
    np.testing.assert_allclose(_np(wt).sum((1, 3)), 1.0, atol=1e-5)


def test_attention_plain_matches_pallas_interpret(monkeypatch):
    import jax.experimental.pallas as pl
    orig = pl.pallas_call
    monkeypatch.setattr(pl, 'pallas_call',
                        lambda *a, **kw: orig(*a, interpret=True, **kw))
    q, k, v = _attention_inputs(B=1, R=70, seed=1)
    out, wt = EA.epipolar_attention(*map(torch.from_numpy, (q, k, v)))
    out_p, wt_p = JEA._forward_pallas(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(_np(out), _np(out_p), atol=1e-5)
    np.testing.assert_allclose(_np(wt), _np(wt_p), atol=1e-6)


def _epilogue_case(seed=0):
    """Packed tables, cell rows of both streams, aux and weights (numpy)."""
    rng = np.random.default_rng(seed)
    hw = (4, 8, 16)
    tables = [rng.standard_normal((2, h, h, 4 * c)).astype(np.float32)
              for c, h in zip(CHANNELS, hw)]
    cells = [rng.integers(0, 2 * h * h, 2 * M).astype(np.int32) for h in hw]
    aux = rng.random((2, M, 16)).astype(np.float32)
    aux[:, ::7, :12] = 0.0
    shapes = ((F + 3, H1), (H1,), (H1, LD), (LD,), (2 * LD, LD), (LD,),
              (2 * LD, HID), (HID,), (HID, HID), (HID,))
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return tables, cells, aux[0], aux[1], params


def _taken(tables, cells):
    return [t.reshape(-1, t.shape[-1])[c] for t, c in zip(tables, cells)]


def test_epilogue_reference_matches_jax_reference():
    tables, cells, a_s, a_c, params = _epilogue_case(0)
    vals = _taken(tables, cells)
    jl, kv = GE._reference([torch.from_numpy(v) for v in vals],
                           torch.from_numpy(a_s), torch.from_numpy(a_c),
                           [torch.from_numpy(p) for p in params], RP)
    jl_j, kv_j = JGE._reference(tuple(map(jnp.asarray, vals)),
                                jnp.asarray(a_s), jnp.asarray(a_c),
                                tuple(map(jnp.asarray, params)), RP)
    np.testing.assert_allclose(_np(jl), _np(jl_j), rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(_np(kv), _np(kv_j), rtol=1e-4, atol=5e-3)


def test_epilogue_with_row_take_matches_pallas_interpret(monkeypatch):
    """The port's entry (tables + cell rows, plain index_select take on the
    CPU) against JAX's take followed by its Pallas kernel."""
    tables, cells, a_s, a_c, params = _epilogue_case(1)
    jl, kv = GE.fused_exchange_epilogue(
        [torch.from_numpy(t) for t in tables],
        [torch.from_numpy(c) for c in cells], torch.from_numpy(a_s),
        torch.from_numpy(a_c), [torch.from_numpy(p) for p in params], RP)
    vals_j = tuple(jnp.take(jnp.asarray(t).reshape(-1, t.shape[-1]),
                            jnp.asarray(c), axis=0, mode='clip')
                   for t, c in zip(tables, cells))
    monkeypatch.setattr(JGE, 'BLOCK_M', RP)
    jl_p, kv_p = JGE._pallas_forward(vals_j, jnp.asarray(a_s),
                                     jnp.asarray(a_c),
                                     tuple(map(jnp.asarray, params)), RP,
                                     interpret=True)
    np.testing.assert_allclose(_np(jl), _np(jl_p), atol=2e-2, rtol=2e-3)
    np.testing.assert_allclose(_np(kv), _np(kv_p), atol=2e-2, rtol=2e-3)


def test_epilogue_bf16_reference_matches_jax():
    """In bf16 both references round at the same places."""
    tables, cells, a_s, a_c, params = _epilogue_case(2)
    params = [0.1 * p for p in params]
    vals = _taken(tables, cells)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    jl, kv = GE._reference([bf(v) for v in vals], bf(a_s), bf(a_c),
                           [bf(p) for p in params], RP)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    jl_j, kv_j = JGE._reference(tuple(map(jb, vals)), jb(a_s), jb(a_c),
                                tuple(map(jb, params)), RP)
    for got, want in ((jl, jl_j), (kv, kv_j)):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, atol=2 ** -5 * max(
            1.0, np.abs(want).max()))


@pytest.mark.parametrize('mode', ['border', 'zeros'])
def test_cell_rows_and_slot_weights_match_jax(mode):
    rng = np.random.default_rng(3)
    coords = rng.uniform(-1.3, 1.3, (4, 200, 2)).astype(np.float32)
    coords[0, :4] = [[1e8, 0.0], [-1e8, 0.5], [0.0, 3e9], [1.0, -1.0]]
    image_id = (np.arange(4, dtype=np.int32)[:, None] ^ 1) * np.ones(
        (1, 200), np.int32) if mode == 'zeros' else None
    cell, w = GS.cell_rows_and_slot_weights(
        (6, 10), torch.from_numpy(coords), mode,
        None if image_id is None else torch.from_numpy(image_id))
    cell_j, w_j = JGS.cell_rows_and_slot_weights(
        (6, 10), jnp.asarray(coords), mode,
        None if image_id is None else jnp.asarray(image_id))
    assert cell.dtype == torch.int32
    np.testing.assert_array_equal(_np(cell), _np(cell_j))
    np.testing.assert_allclose(_np(w), _np(w_j), atol=1e-6)


def test_packed_take_matches_jax_grid_sample():
    """pack_cells + cell rows + slot weights reproduce JAX's grid_sample."""
    rng = np.random.default_rng(4)
    feats = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    coords = rng.uniform(-1.2, 1.2, (2, 50, 2)).astype(np.float32)
    packed = GS.pack_pyramid([torch.from_numpy(feats)])[0]
    np.testing.assert_array_equal(
        _np(packed), _np(JGS.pack_cells(jnp.asarray(feats))))
    for mode in ('border', 'zeros'):
        cell, w = GS.cell_rows_and_slot_weights((5, 7),
                                                torch.from_numpy(coords),
                                                mode)
        rows = packed.reshape(-1, 12)[cell.reshape(-1).long()].reshape(
            2, 50, 4, 3)
        got = (rows * w[..., None]).sum(2)
        want = JGS.grid_sample(jnp.asarray(feats), jnp.asarray(coords), mode)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
