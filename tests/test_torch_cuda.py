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
                                         (1, 2, 512, 64, 128, 288)])
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


def _epilogue_case(dev, channels, H1, O, K, n_img, hw, M, seed=0):
    rng = np.random.default_rng(seed)

    def bf(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(dev,
                                                             torch.bfloat16)

    tables = tuple(bf(rng.standard_normal((n_img, h, h, 4 * c)))
                   for c, h in zip(channels, hw))
    cells = tuple(torch.as_tensor(rng.integers(0, n_img * h * h, 2 * M),
                                  dtype=torch.int32).to(dev) for h in hw)
    aux = rng.random((2, M, 16)).astype(np.float32)
    aux[:, :, 12:15] = 2 * aux[:, :, 12:15] - 1
    aux[:, ::7, :12] = 0.0
    F = sum(channels)
    lecun = lambda i, o: rng.standard_normal((i, o)) / np.sqrt(i)
    params = tuple(bf(a) for a in (
        lecun(F + 3, H1), 0.1 * rng.standard_normal(H1), lecun(H1, O),
        0.1 * rng.standard_normal(O), lecun(2 * O, O),
        0.1 * rng.standard_normal(O), lecun(2 * O, K),
        0.1 * rng.standard_normal(K), lecun(K, K),
        0.1 * rng.standard_normal(K)))
    return tables, cells, bf(aux[0]), bf(aux[1]), params


@pytest.mark.parametrize('channels,H1,O,K,hw,M,rp', [
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 4 * 96, 96),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 2 * 8 * 64 + 40, 8 * 64),
])
def test_exchange_epilogue_kernel(dev, channels, H1, O, K, hw, M, rp):
    case = _epilogue_case(dev, channels, H1, O, K, 2, hw, M)
    jl, kv = GE.fused_exchange_epilogue(*case, rp)
    torch.cuda.synchronize()
    jl_ref, kv_ref = GE.fused_exchange_epilogue_reference(*case, rp)
    assert jl.shape == (M, O) and kv.shape == (M, K)
    assert torch.isfinite(jl.float()).all() and torch.isfinite(kv.float()).all()
    assert _max_err(jl, jl_ref) <= 2 ** -5 * _scale(jl_ref)
    assert _max_err(kv, kv_ref) <= 2 ** -5 * _scale(kv_ref)


def test_kernels_count_launches(dev):
    q = torch.zeros(1, 2, 8, 4, 8, dtype=torch.bfloat16, device=dev)
    before = EA.epipolar_attention.launches
    EA.epipolar_attention(q, q, q)
    assert EA.epipolar_attention.launches == before + 1


def test_kernels_refuse_f32(dev):
    q = torch.zeros(1, 2, 8, 4, 8, device=dev)
    with pytest.raises(ValueError):
        EA.epipolar_attention(q, q, q)
