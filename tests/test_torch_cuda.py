"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with ``nvcc`` and is marked ``cuda``;
without a card they skip. This file imports neither JAX nor the JAX
package, so it also runs where JAX is absent:

  python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances are in bf16 units: the kernels and the plain versions read the
same bf16 inputs and accumulate in f32, but round intermediates at
different places (the plain epilogue rounds each product's output to bf16,
the kernel keeps f32 until the next product's input).
"""

import numpy as np
import pytest
import torch

from cross_attention_renderer_torch.ops import _build
from cross_attention_renderer_torch.ops import epipolar_attention as EA
from cross_attention_renderer_torch.ops import fused_mlp as FM
from cross_attention_renderer_torch.ops import fused_render as FR
from cross_attention_renderer_torch.ops import gather_epilogue as GE

pytestmark = pytest.mark.cuda


@pytest.fixture(scope='module')
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card')
    _build.build()
    return torch.device('cuda')


def _max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def _scale(want):
    return max(1.0, float(want.float().abs().max()))


@pytest.mark.parametrize('B,V,R,P,D,C', [(2, 2, 100, 16, 32, 40),
                                         (1, 2, 512, 64, 128, 288),
                                         (1, 3, 512, 48, 128, 288)])
def test_epipolar_attention_kernel(dev, B, V, R, P, D, C):
    g = torch.Generator(device='cpu').manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g).to(dev, torch.bfloat16)

    q, k, v = rnd(B, V, R, P, D), rnd(B, V, R, P, D), rnd(B, V, R, P, C)
    out, wt = EA.epipolar_attention(q, k, v)
    torch.cuda.synchronize()
    out_ref, wt_ref = EA.epipolar_attention_reference(q, k, v)
    assert out.shape == out_ref.shape and wt.shape == wt_ref.shape
    assert _max_err(wt, wt_ref) <= 2 ** -8
    assert _max_err(out, out_ref) <= 2 ** -7 * _scale(out_ref)


def _bf(dev, a):
    return torch.as_tensor(np.asarray(a, np.float32)).to(dev, torch.bfloat16)


def _epilogue_case(dev, channels, H1, O, K, n_img, hw, M, S=2, seed=0):
    """Tables, cells of S streams, S aux arrays and the weights."""
    rng = np.random.default_rng(seed)
    tables = tuple(_bf(dev, rng.standard_normal((n_img, h, h, 4 * c)))
                   for c, h in zip(channels, hw))
    cells = tuple(torch.as_tensor(rng.integers(0, n_img * h * h, S * M),
                                  dtype=torch.int32).to(dev) for h in hw)
    aux = rng.random((S, M, 16)).astype(np.float32)
    aux[:, :, 12:15] = 2 * aux[:, :, 12:15] - 1
    aux[:, ::7, :12] = 0.0
    F = sum(channels)
    lecun = lambda i, o: rng.standard_normal((i, o)) / np.sqrt(i)
    params = tuple(_bf(dev, a) for a in (
        lecun(F + 3, H1), 0.1 * rng.standard_normal(H1), lecun(H1, O),
        0.1 * rng.standard_normal(O), lecun(S * O, O),
        0.1 * rng.standard_normal(O), lecun(S * O, K),
        0.1 * rng.standard_normal(K), lecun(K, K),
        0.1 * rng.standard_normal(K)))
    return tables, cells, tuple(_bf(dev, a) for a in aux), params


@pytest.mark.parametrize('channels,H1,O,K,hw,M,rp', [
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 4 * 96, 96),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 2 * 8 * 64 + 40, 8 * 64),
])
def test_exchange_epilogue_kernel(dev, channels, H1, O, K, hw, M, rp):
    tables, cells, (a_s, a_c), params = _epilogue_case(dev, channels, H1, O,
                                                       K, 2, hw, M)
    case = (tables, cells, a_s, a_c, params, rp)
    jl, kv = GE.fused_exchange_epilogue(*case)
    torch.cuda.synchronize()
    jl_ref, kv_ref = GE.fused_exchange_epilogue_reference(*case)
    assert jl.shape == (M, O) and kv.shape == (M, K)
    assert torch.isfinite(jl.float()).all() and torch.isfinite(kv.float()).all()
    assert _max_err(jl, jl_ref) <= 2 ** -5 * _scale(jl_ref)
    assert _max_err(kv, kv_ref) <= 2 ** -5 * _scale(kv_ref)


@pytest.mark.parametrize('channels,H1,O,K,hw,M', [
    ((32, 32, 16), 80, 48, 16, (4, 8, 16), 3 * 96 + 29),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 3 * 8 * 48 + 40),
])
def test_exchange_epilogue_multi_kernel(dev, channels, H1, O, K, hw, M):
    """K3 at S=3 streams, ragged M (not a multiple of the 48-sample tile)."""
    case = _epilogue_case(dev, channels, H1, O, K, 3, hw, M, S=3, seed=1)
    jl, kv = GE.fused_exchange_epilogue_multi(*case)
    torch.cuda.synchronize()
    jl_ref, kv_ref = GE.fused_exchange_epilogue_multi_reference(*case)
    assert jl.shape == (M, O) and kv.shape == (M, K)
    assert torch.isfinite(jl.float()).all() and torch.isfinite(kv.float()).all()
    assert _max_err(jl, jl_ref) <= 2 ** -5 * _scale(jl_ref)
    assert _max_err(kv, kv_ref) <= 2 ** -5 * _scale(kv_ref)


@pytest.mark.parametrize('M,K1,H,O', [(64 * 5 + 23, 96, 80, 40),
                                      (2 * 4096 + 17, 576, 576, 288)])
def test_fused_mlp_kernel(dev, M, K1, H, O):
    """K9 at a ragged M (not a multiple of the 64-row tile)."""
    rng = np.random.default_rng(2)
    lecun = lambda i, o: rng.standard_normal((i, o)) / np.sqrt(i)
    x1 = _bf(dev, rng.standard_normal((M, K1)))
    x2 = _bf(dev, rng.uniform(-1, 1, (M, 3)))
    w1 = lecun(K1 + 3, H)
    weights = (_bf(dev, w1[:K1]), _bf(dev, w1[K1:]),
               torch.as_tensor(0.1 * rng.standard_normal(H),
                               dtype=torch.float32, device=dev),
               _bf(dev, lecun(H, O)),
               torch.as_tensor(0.1 * rng.standard_normal(O),
                               dtype=torch.float32, device=dev))
    out = FM.fused_mlp2(x1, x2, *weights)
    torch.cuda.synchronize()
    ref = FM.fused_mlp2_reference(x1, x2, *weights)
    assert out.shape == (M, O) and torch.isfinite(out.float()).all()
    assert _max_err(out, ref) <= 2 ** -5 * _scale(ref)


def _render_case(dev, channels, H1, O, K, hw, B, R, P, seed=3):
    """K4's arguments: the V=2 epilogue's case for M = B * 2 * R * P
    samples, local coordinates and the ten query weights."""
    M = B * 2 * R * P
    tables, cells, (a_s, a_c), params = _epilogue_case(
        dev, channels, H1, O, K, 2, hw, M, seed=seed)
    rng = np.random.default_rng(seed + 1)
    lecun = lambda i, o: rng.standard_normal((i, o)) / np.sqrt(i)
    bias = lambda n: 0.1 * rng.standard_normal(n)
    lc = _bf(dev, rng.uniform(-1, 1, (M, 16)))
    query = tuple(_bf(dev, a) for a in (
        lecun(16, K), bias(K), lecun(K, K), bias(K), lecun(O, K), bias(K),
        lecun(K + 16, K), bias(K), lecun(K, K), bias(K)))
    return tables, cells, a_s, a_c, lc, params + query


@pytest.mark.parametrize('repeat', [True, False])
@pytest.mark.parametrize('channels,H1,O,K,hw,B,R,P', [
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 2, 13, 24),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 1, 37, 64),
])
def test_fused_render_core_kernel(dev, channels, H1, O, K, hw, B, R, P,
                                  repeat):
    """K4 at a ragged ray count (R not a multiple of 8) and, in the narrow
    case, a last 32-sample tile that is part full and a tile that spans
    both views. Tolerances: z one bf16 step of max(1, |z|), as K2's
    outputs; at_wt 2^-8, as K1's."""
    case = _render_case(dev, channels, H1, O, K, hw, B, R, P)
    before = FR.fused_render_core.launches
    z, wt = FR.fused_render_core(*case, B, R, P, repeat)
    torch.cuda.synchronize()
    assert FR.fused_render_core.launches == before + 1
    z_ref, wt_ref = FR.fused_render_core_reference(*case, B, R, P, repeat)
    assert z.shape == (B, R, O) and wt.shape == (B, 2, R, P)
    assert torch.isfinite(z.float()).all()
    assert _max_err(wt, wt_ref) <= 2 ** -8
    assert _max_err(z, z_ref) <= 2 ** -5 * _scale(z_ref)


def test_kernels_count_launches(dev):
    q = torch.zeros(1, 2, 8, 4, 8, dtype=torch.bfloat16, device=dev)
    before = EA.epipolar_attention.launches
    EA.epipolar_attention(q, q, q)
    assert EA.epipolar_attention.launches == before + 1


def test_kernels_refuse_f32(dev):
    q = torch.zeros(1, 2, 8, 4, 8, device=dev)
    with pytest.raises(ValueError):
        EA.epipolar_attention(q, q, q)
    tables, cells, a_s, a_c, lc, params = _render_case(
        dev, (32, 32, 16), 80, 40, 16, (4, 8, 16), 1, 3, 4)
    with pytest.raises(ValueError):
        FR.fused_render_core([t.float() for t in tables], cells, a_s.float(),
                             a_c.float(), lc.float(), params, 1, 3, 4, True)
