"""The padded weights of the exchange core's kernels as they read them, on
the CPU: at widths that do not tile (levels that are no multiple of 8, f
rows that are not a whole number of 16-deep steps), the layouts that
``ops/gather_epilogue.py`` builds for K2, K3, K4 and K9, walked in the
kernel's order with its arithmetic in f32 (tests/test_torch_epilogue_
layout.py) on the zero-padded rows, give the JAX references' outputs on
the unpadded inputs (rtol 1e-4, as there). tests/test_torch_widths.py
holds the renders at these widths and the exactness of the padding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.ops.gather_epilogue as JGE
from cross_attention_renderer_tpu.ops import fused_render as JFR
from cross_attention_renderer_tpu.ops.experimental import fused_mlp as JFM
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.ops.grid_sample import pad_cells
from test_torch_epilogue_layout import (_mlp_walk, _params, _render_case,
                                        _render_walk, _walk)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _padded_vals(vals, channels):
    """Taken rows (N, 4C) per level, each corner padded as pad_cells pads
    the tables."""
    return [pad_cells(torch.from_numpy(v), GE.table_width(c))
            for v, c in zip(vals, channels)]


@pytest.mark.parametrize('channels,H1,O,S,rp', [
    ((36, 20, 12), 80, 38, 2, 20), ((100, 50, 30), 100, 37, 3, None),
    ((30, 20, 10), 48, 40, 5, None), ((44, 44, 44), 92, 46, 2, 10)])
def test_padded_layout_in_kernel_order_matches_jax(channels, H1, O, S, rp):
    """K2 (rp given) and K3: the weights ``prepared_weights`` lays out for
    these widths (w1 with zero rows after each level, the f rows
    ``core_out_width`` wide), walked in the kernel's order on the padded
    rows, against JAX ``_reference`` / ``_reference_multi`` on the
    unpadded ones; the kernel writes the first O columns of jl."""
    K, M = 16, 40
    F = sum(channels)
    rng = np.random.default_rng(1)
    vals = [rng.standard_normal((S * M, 4 * c)).astype(np.float32)
            for c in channels]
    aux = rng.random((S, M, 16)).astype(np.float32)
    aux[:, :, 12:15] = 2 * aux[:, :, 12:15] - 1
    p = _params(F, H1, O, K, S, seed=2)
    stages, vecs = GE.prepared_weights(p, S, 'cpu', channels)
    Fp = sum(GE.table_width(c) for c in channels)
    Op = GE.core_out_width('pair' if rp else 'streams', S, O)
    assert Fp > F and Op >= O
    jl, kv, _ = _walk(stages, vecs, _padded_vals(vals, channels),
                      [torch.from_numpy(a) for a in aux], Fp, H1, Op, K, rp)
    pj = tuple(jnp.asarray(t.numpy()) for t in p)
    if rp is not None:
        jl_j, kv_j = JGE._reference(tuple(map(jnp.asarray, vals)),
                                    jnp.asarray(aux[0]), jnp.asarray(aux[1]),
                                    pj, rp)
    else:
        jl_j, kv_j = JGE._reference_multi(tuple(map(jnp.asarray, vals)),
                                          tuple(map(jnp.asarray, aux)), pj)
    np.testing.assert_allclose(jl[:, :O].numpy(), np.asarray(jl_j),
                               rtol=1e-4, atol=1e-4)
    assert not jl[:, O:].any()
    np.testing.assert_allclose(kv.numpy(), np.asarray(kv_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('repeat', [False, True])
def test_padded_render_layout_matches_jax(repeat):
    """K4's padded layout (``prepared_render``: el's rows too) walked in
    the kernel's order against JAX ``fused_render._reference``."""
    B, R, P, channels, O, K = 1, 2, 4, (36, 20, 12), 38, 16
    vals, a_s, a_c, lc, params = _render_case(B, R, P, channels, O, K)
    stages, vecs, mats = GE.prepared_render(params[:20 if repeat else 14],
                                            repeat, 'cpu', channels)
    Fp = sum(GE.table_width(c) for c in channels)
    Op = GE.core_out_width('render', 2, O)
    t = torch.from_numpy
    z, wt = _render_walk(stages, vecs, mats, _padded_vals(vals, channels),
                         t(a_s), t(a_c), t(lc), Fp, sum(channels), Op, K, B,
                         R, P, repeat)
    z_j, wt_j = JFR._reference(
        tuple(map(jnp.asarray, vals)), jnp.asarray(a_s), jnp.asarray(a_c),
        jnp.asarray(lc), tuple(jnp.asarray(p.numpy()) for p in params),
        channels, B, R, P, repeat)
    np.testing.assert_allclose(z[..., :O].numpy(), np.asarray(z_j),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wt_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('K1,H,O', [(180, 100, 37), (804, 268, 134),
                                    (30, 50, 7)])
def test_mlp_layout_at_any_width_matches_jax(K1, H, O):
    """K9 takes its widths as they are (its input rows are read a value at
    a time where K1 % 8 != 0, the tiles are zero past H and O): its layout
    walked in the kernel's order against JAX ``fused_mlp2``."""
    rng = np.random.default_rng(5)
    M = 30
    x1 = rng.standard_normal((M, K1)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (M, 3)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()
    w = (bf(rng.standard_normal((K1, H)).astype(np.float32) / np.sqrt(K1)),
         bf(rng.standard_normal((3, H)).astype(np.float32)),
         torch.from_numpy((0.1 * rng.standard_normal(H)).astype(np.float32)),
         bf(rng.standard_normal((H, O)).astype(np.float32) / np.sqrt(H)),
         torch.from_numpy((0.1 * rng.standard_normal(O)).astype(np.float32)))
    stages, vecs = GE.prepared_mlp(w, 'cpu')
    got = _mlp_walk(stages, vecs, torch.from_numpy(x1), torch.from_numpy(x2),
                    K1, H, O)
    want = JFM.fused_mlp2(jnp.asarray(x1), jnp.asarray(x2),
                          *(jnp.asarray(t.numpy()) for t in w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
