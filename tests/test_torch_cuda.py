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
from cross_attention_renderer_torch.ops import pallas_gather as PG
from cross_attention_renderer_torch.ops import sorted_gather as SG
from cross_attention_renderer_torch.ops import stream_takes as ST
from cross_attention_renderer_torch.ops.experimental import (
    banded_gather as BG)
from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from torch_stream_cases import stream_case

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
                                         (1, 3, 512, 48, 128, 288),
                                         # V*P = 192; the V=1 latent
                                         # widths of the DPT, ResNet34 and
                                         # U-Net models
                                         (1, 4, 512, 48, 128, 288),
                                         (1, 1, 512, 64, 128, 576),
                                         (1, 1, 300, 64, 128, 512),
                                         (1, 1, 300, 64, 128, 960),
                                         # widths that are no multiple
                                         # of 4: fusion_features 102's
                                         # latent, an odd one, an odd D
                                         (1, 2, 200, 64, 128, 134),
                                         (1, 3, 100, 48, 128, 133),
                                         (2, 2, 50, 16, 30, 41)])
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
    t, width = GE.aux_layout(len(channels))
    aux = rng.random((S, M, width)).astype(np.float32)
    aux[:, :, t:t + 3] = 2 * aux[:, :, t:t + 3] - 1
    aux[:, ::7, :t] = 0.0
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
    # M not a multiple of the 64-sample tile nor of a cluster's tiles; rp
    # under the tile and not dividing it, so tiles straddle views
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 5 * 64 + 17, 40),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 9 * 64 + 3, 200),
    # one and two pyramid levels; H1 not a multiple of the 64-unit chunk
    ((48,), 96, 48, 32, (8,), 300, 24),
    ((64, 32), 112, 56, 48, (8, 16), 3 * 64 + 1, 100),
    # F under one 64-column k-block, with O filling the last exchanged
    # fragment: comb's columns past F must not keep the partial sums
    ((48,), 96, 96, 32, (8,), 2 * 64 + 50, 40),
    # fusion_features 288: O = 320 runs as O tiles split between the
    # warpgroups, layer 1 computed by each
    ((288, 288, 64), 640, 320, 128, (16, 32, 64), 3 * 64 + 21, 100),
    # four levels (24-wide aux, tanh at 16): the ResNet34's widths
    # ('smem'), the U-Net's ('resident', O = 480 split between warpgroups)
    ((256, 128, 64, 64), 512, 256, 128, (8, 16, 32, 32), 2 * 8 * 64 + 40,
     8 * 64),
    ((64, 128, 256, 512), 960, 480, 128, (32, 16, 8, 4), 3 * 64 + 5, 100),
    # any width: levels that are no multiple of 8 (read from zero-padded
    # copies) and f rows that do not tile (S * O = 76, 264, 268; the core's
    # f rows 48, 144, 144 wide), an odd O; fusion_features 100 and 102
    ((36, 20, 12), 80, 38, 16, (4, 8, 16), 5 * 64 + 17, 40),
    ((30, 50, 100), 100, 37, 16, (4, 8, 16), 3 * 64 + 3, 96),
    ((264, 264, 264), 264, 132, 128, (8, 16, 32), 2 * 64 + 40, 100),
    ((268, 268, 268), 268, 134, 128, (8, 16, 32), 2 * 64 + 40, 100),
])
def test_exchange_epilogue_kernel(dev, channels, H1, O, K, hw, M, rp):
    """K2 against its plain version; every case also checks that the launch
    was counted."""
    tables, cells, (a_s, a_c), params = _epilogue_case(dev, channels, H1, O,
                                                       K, 2, hw, M)
    case = (tables, cells, a_s, a_c, params, rp)
    before = GE.fused_exchange_epilogue.launches
    jl, kv = GE.fused_exchange_epilogue(*case)
    torch.cuda.synchronize()
    assert GE.fused_exchange_epilogue.launches == before + 1
    # three warpgroups a block, clusters of one block
    assert GE.fused_exchange_epilogue.last_launch[3:] == (384, 1, 1, 1)
    jl_ref, kv_ref = GE.fused_exchange_epilogue_reference(*case)
    assert jl.shape == (M, O) and kv.shape == (M, K)
    assert torch.isfinite(jl.float()).all() and torch.isfinite(kv.float()).all()
    assert _max_err(jl, jl_ref) <= 2 ** -5 * _scale(jl_ref)
    assert _max_err(kv, kv_ref) <= 2 ** -5 * _scale(kv_ref)


@pytest.mark.parametrize('channels,H1,O,K,hw,M,S', [
    ((32, 32, 16), 80, 48, 16, (4, 8, 16), 3 * 96 + 29, 3),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 3 * 8 * 48 + 40, 3),
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 2 * 64 + 7, 4),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 300, 4),
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 130, 2),
    ((64,), 64, 32, 16, (8,), 150, 3),
    ((32, 16), 48, 32, 32, (8, 16), 77, 3),
    # the last stream's f rows end in comb's first k-block, S*O not a
    # multiple of 64; and F under one k-block
    ((32, 32, 16), 80, 80, 16, (4, 8, 16), 200, 3),
    ((32, 32, 16), 80, 72, 16, (4, 8, 16), 150, 2),
    ((48,), 64, 96, 32, (8,), 140, 3),
    # fusion_features 288 (O = 320): the last stream's f rows in comb after
    # both warpgroups' O tiles
    ((288, 288, 64), 640, 320, 128, (16, 32, 64), 3 * 64 + 5, 3),
    # four levels at the ResNet34's and the U-Net's widths, S = 3 and 4
    ((256, 128, 64, 64), 512, 256, 128, (8, 16, 32, 32), 3 * 64 + 11, 3),
    ((64, 128, 256, 512), 960, 480, 128, (32, 16, 8, 4), 2 * 64 + 9, 3),
    ((256, 128, 64, 64), 512, 256, 128, (8, 16, 32, 32), 4 * 64 + 3, 4),
    # any width (as K2's cases): S * O = 120, 396 (fusion_features 100),
    # 888 (264), 200; levels that are no multiple of 8
    ((36, 20, 12), 80, 40, 16, (4, 8, 16), 150, 3),
    ((264, 264, 264), 264, 132, 128, (8, 16, 32), 3 * 64 + 5, 3),
    ((592, 592, 592), 592, 296, 128, (8, 16, 32), 2 * 64 + 9, 3),
    ((268, 268, 268), 268, 134, 128, (8, 16, 32), 2 * 64 + 9, 3),
    ((30, 50, 100), 100, 40, 16, (4, 8, 16), 130, 5),
    ((36, 20, 12), 80, 37, 16, (4, 8, 16), 150, 3),     # odd O
])
def test_exchange_epilogue_multi_kernel(dev, channels, H1, O, K, hw, M, S):
    """K3 at S = 2, 3 and 4 streams, ragged M (not a multiple of the tile),
    one to four levels, H1 not a multiple of the hidden chunk, and the
    shapes whose padding columns in comb are read (they must hold zeros or
    finite values)."""
    case = _epilogue_case(dev, channels, H1, O, K, 3, hw, M, S=S, seed=1)
    jl, kv = GE.fused_exchange_epilogue_multi(*case)
    torch.cuda.synchronize()
    jl_ref, kv_ref = GE.fused_exchange_epilogue_multi_reference(*case)
    assert jl.shape == (M, O) and kv.shape == (M, K)
    assert torch.isfinite(jl.float()).all() and torch.isfinite(kv.float()).all()
    assert _max_err(jl, jl_ref) <= 2 ** -5 * _scale(jl_ref)
    assert _max_err(kv, kv_ref) <= 2 ** -5 * _scale(kv_ref)


def test_exchange_epilogue_prepared_once(dev):
    """The weights K2 reads are laid out on the first call and reused until
    a parameter changes in place; the result follows the change."""
    tables, cells, (a_s, a_c), params = _epilogue_case(
        dev, (32, 32, 16), 80, 40, 16, 2, (4, 8, 16), 200)
    case = (tables, cells, a_s, a_c, params, 50)
    GE.fused_exchange_epilogue(*case)
    prep = GE.prepared_weights(params, 2, dev)
    GE.fused_exchange_epilogue(*case)
    assert GE.prepared_weights(params, 2, dev) is prep
    params[3].mul_(2.0)     # b2
    assert GE.prepared_weights(params, 2, dev) is not prep
    jl, kv = GE.fused_exchange_epilogue(*case)
    jl_ref, kv_ref = GE.fused_exchange_epilogue_reference(*case)
    assert _max_err(jl, jl_ref) <= 2 ** -5 * _scale(jl_ref)
    assert _max_err(kv, kv_ref) <= 2 ** -5 * _scale(kv_ref)


@pytest.mark.parametrize('M,K1,H,O', [(64 * 5 + 23, 96, 80, 40),
                                      (2 * 4096 + 17, 576, 576, 288),
                                      (3 * 64 + 1, 48, 64, 16),
                                      (64 * 7 + 9, 640, 640, 320),
                                      # any width: K1, H and O that are
                                      # no multiple of 8 or 16, odd O
                                      (64 * 3 + 5, 180, 100, 37),
                                      (2 * 64 + 9, 804, 268, 134),
                                      (150, 30, 50, 7)])
def test_fused_mlp_kernel(dev, M, K1, H, O):
    """K9 at a ragged M (not a multiple of the 64-row tile), the flagship
    widths, a narrow O under one O tile and K1 under one k-block, and O =
    320 (O tiles split between the warpgroups)."""
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
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 1, 150, 16),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 1, 9, 48),
    # F under one k-block and O = 96: padding columns of comb and of the
    # f rows are read (they must hold zeros or finite values)
    ((48,), 96, 96, 32, (8,), 2, 7, 16),
    ((48,), 64, 96, 32, (8,), 1, 5, 48),
    # more rays than SMs, P over one tile a view
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 1, 300, 80),
    # four levels at the ResNet34's and the U-Net's widths
    ((256, 128, 64, 64), 512, 256, 128, (8, 16, 32, 32), 1, 21, 64),
    ((64, 128, 256, 512), 960, 480, 128, (32, 16, 8, 4), 1, 11, 64),
    # any width: levels that are no multiple of 8, O = 38 and 134 (the f
    # rows 48 and 144 wide), an odd O
    ((36, 20, 12), 80, 38, 16, (4, 8, 16), 1, 13, 24),
    ((30, 50, 100), 100, 37, 16, (4, 8, 16), 2, 7, 16),
    ((268, 268, 268), 268, 134, 128, (8, 16, 32), 1, 9, 64),
])
def test_fused_render_core_kernel(dev, channels, H1, O, K, hw, B, R, P,
                                  repeat):
    """K4 at ragged ray counts (R not a multiple of 8), P = 16, 24, 48, 64
    and 80 (tiles of one view with empty rows; two tiles a view), more rays
    than the persistent grid's blocks. Tolerances: z one bf16 step of
    max(1, |z|), as K2's outputs; at_wt 2^-8, as K1's."""
    case = _render_case(dev, channels, H1, O, K, hw, B, R, P)
    before = FR.fused_render_core.launches
    z, wt = FR.fused_render_core(*case, B, R, P, repeat)
    torch.cuda.synchronize()
    assert FR.fused_render_core.launches == before + 1
    assert FR.fused_render_core.last_launch[3:] == (384, 1, 1, 1)
    z_ref, wt_ref = FR.fused_render_core_reference(*case, B, R, P, repeat)
    assert z.shape == (B, R, O) and wt.shape == (B, 2, R, P)
    assert torch.isfinite(z.float()).all()
    assert _max_err(wt, wt_ref) <= 2 ** -8
    assert _max_err(z, z_ref) <= 2 ** -5 * _scale(z_ref)


def test_fused_render_core_prepared_once(dev):
    """K4 lays its weights out on the first call and again after an
    in-place change, whose effect the result shows; without repeat it
    takes the 14 parameters alone."""
    case = _render_case(dev, (32, 32, 16), 80, 40, 16, (4, 8, 16), 1, 9, 16)
    params = case[-1]
    FR.fused_render_core(*case, 1, 9, 16, True)
    prep = GE.prepared_render(params, True, dev)
    assert GE.prepared_render(params, True, dev) is prep
    params[13].mul_(2.0)     # qe2b
    assert GE.prepared_render(params, True, dev) is not prep
    for repeat, p in ((True, params), (False, params[:14])):
        args = case[:-1] + (p, 1, 9, 16, repeat)
        z, wt = FR.fused_render_core(*args)
        z_ref, wt_ref = FR.fused_render_core_reference(*args)
        assert _max_err(wt, wt_ref) <= 2 ** -8
        assert _max_err(z, z_ref) <= 2 ** -5 * _scale(z_ref)


@pytest.mark.parametrize('mode', ['pair', 'streams', 'mlp', 'render'])
@pytest.mark.parametrize('ff', [256, 320, 352, 384, 416, 448, 480, 512,
                                528, 640, 672, 768])
def test_exchange_core_at_wide_fusion_widths(dev, mode, ff):
    """K2, K3 (S = 3), K9 and K4 at wide fusion_features (F = H1 = 2 ff +
    64, O = ff + 32, K = 128), widths whose tiles outgrow a block's shared
    memory in some modes: each takes the plan and stage slots ``core_plan``
    names for it and matches its plain version, as at the flagship. The
    widths include each mode's last width of a plan and the first of the
    next (K2 and K3: 'smem' 256 | 'resident' 320, 512 | 'global' 528; K4:
    'smem' 320 | 'resident' 352, 480 | 'global' 512; K9: 'smem' 640 |
    'global' 672)."""
    channels, F, O, K = (ff, ff, 64), 2 * ff + 64, ff + 32, 128
    hw = (8, 16, 32)
    if mode == 'pair':
        case = _epilogue_case(dev, channels, F, O, K, 2, hw, 2 * 64 + 37)
        case = (case[0], case[1], *case[2], case[3], 60)
        fn, plain = (GE.fused_exchange_epilogue,
                     GE.fused_exchange_epilogue_reference)
        want = GE.core_plan('pair', 2, F, F, O, K)
    elif mode == 'streams':
        case = _epilogue_case(dev, channels, F, O, K, 3, hw, 3 * 64 + 5,
                              S=3, seed=1)
        fn, plain = (GE.fused_exchange_epilogue_multi,
                     GE.fused_exchange_epilogue_multi_reference)
        want = GE.core_plan('streams', 3, F, F, O, K)
    elif mode == 'mlp':
        rng = np.random.default_rng(2)
        M = 64 * 3 + 9
        lecun = lambda i, o: rng.standard_normal((i, o)) / np.sqrt(i)
        w1 = lecun(F + 3, F)
        case = (_bf(dev, rng.standard_normal((M, F))),
                _bf(dev, rng.uniform(-1, 1, (M, 3))), _bf(dev, w1[:F]),
                _bf(dev, w1[F:]), _bf(dev, 0.1 * rng.standard_normal(F)),
                _bf(dev, lecun(F, O)), _bf(dev, 0.1 * rng.standard_normal(O)))
        fn, plain = FM.fused_mlp2, FM.fused_mlp2_reference
        want = GE.core_plan('mlp', 1, F, F, O, 0)
    else:
        case = _render_case(dev, channels, F, O, K, hw, 1, 5, 64) + (
            1, 5, 64, True)
        fn, plain = FR.fused_render_core, FR.fused_render_core_reference
        want = GE.core_plan('render', 2, F, F, O, K, 64)
    got = fn(*case)
    torch.cuda.synchronize()
    assert (fn.last_plan, fn.last_launch[1] // 2) == (want.plan, want.slots)
    want = plain(*case)
    if mode == 'render':        # at_wt within 2^-8, as K1's
        assert _max_err(got[1], want[1]) <= 2 ** -8
        got, want = got[:1], want[:1]
    elif mode == 'mlp':
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        assert _max_err(g, w) <= 2 ** -5 * _scale(w)


def _gather_case(dev, rows, C, M, seed, sort, edges=False):
    """A bf16 (rows, C) table, (M, 4) corner rows (sorted, or scattered over
    the whole table) with coincident corners, as at the border, and (M, 4)
    weights with zeros, as in 'zeros' padding. ``edges`` adds a run of 70
    samples whose weights are all 0 (across two of a warp's 32-sample
    batches) and samples whose four corners all lie on one row."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, rows, (M, 4))
    if sort:
        idx = np.sort(idx, axis=0)
    idx[::7, 1] = idx[::7, 0]
    idx[::11, 2:] = idx[::11, :1]
    w = rng.uniform(0, 1, (M, 4))
    w[::5, 2:] = 0.0
    if edges:
        w[M // 3:M // 3 + 70] = 0.0
        idx[3::13] = idx[3::13, :1]
    return (_bf(dev, rng.standard_normal((rows, C))),
            torch.as_tensor(idx, dtype=torch.int32, device=dev),
            torch.as_tensor(w, dtype=torch.float32, device=dev))


GATHER_KERNELS = [
    (SG.resident_gather, torch.bfloat16), (SG.windowed_gather, torch.float32),
    (PG.onehot_gather, torch.bfloat16), (BG.banded_gather, torch.bfloat16)]


@pytest.mark.parametrize('kernel,out', GATHER_KERNELS)
@pytest.mark.parametrize('rows,C,M,sort,edges', [
    (2 * 16 * 16, 32, 1003, True, False),
    (2 * 128 * 128, 256, 20000, True, False),
    (3 * 64 * 64, 64, 4097, False, False),
    # the flagship's three levels (V=2), M not a multiple of a warp's 32
    # samples; the last two tables hold more than 2^16 rows
    (2 * 64 * 64, 256, 65537, True, True),
    (2 * 128 * 128, 256, 65555, True, True),
    (2 * 256 * 256, 64, 65571, True, True),
    (3 * 256 * 256, 64, 33333, False, True),
    # widths that are no multiple of 8: rows read a value at a time
    (2 * 16 * 16, 12, 1003, True, False),
    (2 * 64 * 64, 134, 4097, False, True),
    (3 * 16 * 16, 5, 777, True, False),
    (2 * 32 * 32, 268, 2049, True, True)])
def test_gather_kernels(dev, kernel, out, rows, C, M, sort, edges):
    """K5-K8 against ``take_gather`` cast to the kernel's output type. Both
    round each corner's weight to bf16; the kernel sums the bf16 products in
    f32 and rounds once, the plain version rounds each product and partial
    sum to bf16: a few bf16 steps of max(1, |want|). Samples whose weights
    are all 0 are exactly 0."""
    table, idx, w = _gather_case(dev, rows, C, M, seed=rows % 7, sort=sort,
                                 edges=edges)
    before = kernel.launches
    got = kernel(table, idx, w)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert kernel.last_plan == SG.card_plan(dev, M, C, out)
    want = SG.take_gather(table, idx, w).to(out)
    assert got.shape == (M, C) and got.dtype == out
    assert _max_err(got, want) <= 2 ** -5 * _scale(want)
    dead = (w == 0).all(dim=1)
    assert bool((got[dead] == 0).all())


def test_gather_plan_is_waves_of_resident_blocks(dev):
    """Every instantiation of the bilinear gather fits at least one block
    an SM, and the wrappers' plan at K8's 1,048,576 samples is
    ``GATHER_WAVES`` waves of them on this card."""
    sms = SG.sm_count(dev)
    for depth in SG.GATHER_DEPTHS:
        for f32 in (False, True):
            assert SG.resident_blocks(dev, depth, f32) >= 1
    for C, out in ((256, torch.bfloat16), (64, torch.bfloat16),
                   (256, torch.float32)):
        plan = SG.card_plan(dev, 1 << 20, C, out)
        assert plan.grid == sms * SG.GATHER_WAVES * SG.resident_blocks(
            dev, plan.depth, out == torch.float32)


def test_gather_kernels_cast_and_refuse(dev):
    """K5's output type follows ``out_dtype``; an f32 table is cast to bf16
    first, as the TPU wrappers cast theirs; the wrappers raise on what the
    kernel cannot take."""
    table, idx, w = _gather_case(dev, 512, 64, 300, seed=9, sort=True)
    want = SG.take_gather(table, idx, w)
    got = SG.resident_gather(table.float(), idx, w, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    assert _max_err(got, want) <= 2 ** -5 * _scale(want)
    narrow = table[:, :60].contiguous()     # C = 60 is taken
    want = SG.take_gather(narrow.float(), idx, w)
    got = SG.resident_gather(narrow.float(), idx, w, out_dtype=torch.float32)
    assert got.shape == (300, 60)
    assert _max_err(got, want) <= 2 ** -5 * _scale(want)
    for bad in ((table[:0], idx, w),
                (table.t(), idx, w), (table, idx.long(), w),
                (table, idx, w.half()), (table, idx[:, :3].contiguous(), w)):
        for kernel in (SG.resident_gather, SG.windowed_gather,
                       PG.onehot_gather, BG.banded_gather):
            with pytest.raises(ValueError):
                kernel(*bad)


def test_kernels_count_launches(dev):
    q = torch.zeros(1, 2, 8, 4, 8, dtype=torch.bfloat16, device=dev)
    before = EA.epipolar_attention.launches
    EA.epipolar_attention(q, q, q)
    assert EA.epipolar_attention.launches == before + 1


def test_kernels_refuse_f32(dev):
    """The kernels take all-bf16 or all-f32 inputs (their two
    instantiations): f32 mixed with bf16, and f16, are refused."""
    q = torch.zeros(1, 2, 8, 4, 8, device=dev)
    for args in ((q, q, q.bfloat16()), (q.bfloat16(), q, q),
                 (q.half(), q.half(), q.half())):
        with pytest.raises(ValueError):
            EA.epipolar_attention(*args)
    tables, cells, a_s, a_c, lc, params = _render_case(
        dev, (32, 32, 16), 80, 40, 16, (4, 8, 16), 1, 3, 4)
    with pytest.raises(ValueError):
        FR.fused_render_core([t.float() for t in tables], cells, a_s,
                             a_c, lc, params, 1, 3, 4, True)
    with pytest.raises(ValueError):
        FR.fused_render_core(tables, cells, a_s.float(), a_c.float(),
                             lc.float(), params, 1, 3, 4, True)
    with pytest.raises(ValueError):
        GE.fused_exchange_epilogue([t.half() for t in tables], cells,
                                   a_s.half(), a_c.half(), params[:10], 12)


# f32 inputs (an f32 model's): each kernel's f32 instantiation against its
# plain version in f32. The kernel rounds its f32 operands to bf16 on their
# way into the products (csrc/exchange_core.cuh, "Element types"; K1 keeps
# f32 throughout), where the plain version multiplies in f32, so the
# tolerances are the bf16 tests' above. Shapes: the flagship widths
# (fusion_features 256, 'smem' plan), and fusion_features 384 and 512,
# where K2 and K3 take the 'resident' plan, and K4 the 'resident' (384)
# and the 'global' one (512).
def _f32_case(dev, key, ff):
    def f32(t):
        return tuple(f32(x) for x in t) if isinstance(t, tuple) else (
            t.float() if t.is_floating_point() else t)

    channels, H1, O, K = (ff, ff, 64), 2 * ff + 64, ff + 32, 128
    hw = (8, 16, 32)
    if key == 'K1':
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(1, 2, 300, 64, d, generator=g).to(dev)
                   for d in (128, 128, O))
        return (EA.epipolar_attention, EA.epipolar_attention_reference,
                (q, k, v), {0: 2 ** -7, 1: 2 ** -8})
    if key == 'K2':
        t, c, (a_s, a_c), prm = _epilogue_case(dev, channels, H1, O, K, 2,
                                               hw, 3 * 64 + 37)
        return (GE.fused_exchange_epilogue,
                GE.fused_exchange_epilogue_reference,
                f32((t, c, a_s, a_c, prm)) + (100,), {0: 2 ** -5, 1: 2 ** -5})
    if key == 'K3':
        t, c, aux, prm = _epilogue_case(dev, channels, H1, O, K, 3, hw,
                                        3 * 64 + 5, S=3, seed=1)
        return (GE.fused_exchange_epilogue_multi,
                GE.fused_exchange_epilogue_multi_reference,
                f32((t, c, aux, prm)), {0: 2 ** -5, 1: 2 ** -5})
    if key == 'K4':
        case = _render_case(dev, channels, H1, O, K, hw, 1, 5, 64)
        return (FR.fused_render_core, FR.fused_render_core_reference,
                f32(case) + (1, 5, 64, True), {0: 2 ** -5, 1: 2 ** -8})
    rng = np.random.default_rng(2)
    M = 64 * 3 + 9
    lecun = lambda i, o: rng.standard_normal((i, o)) / np.sqrt(i)
    w1 = lecun(H1 + 3, H1)
    arrays = (rng.standard_normal((M, H1)), rng.uniform(-1, 1, (M, 3)),
              w1[:H1], w1[H1:], 0.1 * rng.standard_normal(H1),
              lecun(H1, O), 0.1 * rng.standard_normal(O))
    return (FM.fused_mlp2, FM.fused_mlp2_reference,
            tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                  for a in arrays), {0: 2 ** -5})


@pytest.mark.parametrize('ff', [100, 102, 256, 384, 512])
@pytest.mark.parametrize('key', ['K1', 'K2', 'K3', 'K4', 'K9'])
def test_f32_kernels_against_plain_f32(dev, key, ff):
    """Each f32 instantiation launches (one counted launch), returns f32
    outputs of the plain version's shapes, finite, within the stated
    fraction of max(1, max |plain|) (K1's and K4's weights within an
    absolute 2^-8)."""
    fn, plain, args, tols = _f32_case(dev, key, ff)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if hasattr(fn, 'last_plan'):
        print(f'{key} ff={ff}: plan {fn.last_plan}')
    for i, tol in tols.items():
        g, w = got[i], want[i]
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert torch.isfinite(g).all()
        bound = tol if (key, i) in (('K1', 1), ('K4', 1)) else (
            tol * _scale(w))
        err = _max_err(g, w)
        print(f'{key} ff={ff} output {i}: max err {err:.3e} (tol '
              f'{bound:.3e})')
        assert err <= bound, (key, ff, i, err, bound)


# A narrow f32 model renders on every forward path on the card, through
# that path's kernels in f32, within 0.1 of max(1, max |rgb|) of its f32
# render on the CPU (the plain versions): chip_smoke.py's small-input gate.
# NARROW (below) is the model's size.
F32_PATHS = {
    'v2': (dict(), {'epipolar_attention': 2, 'fused_exchange_epilogue': 1}),
    'v2_fused_render': (dict(fused_render=True), {'fused_render_core': 1}),
    'v3': (dict(n_view=3), {'epipolar_attention': 2,
                            'fused_exchange_epilogue_multi': 1}),
    'v3_compat': (dict(n_view=3, reference_exchange_compat=True,
                       fused_mlp=True),
                  {'epipolar_attention': 2, 'fused_mlp2': 9}),
    'v2_sorted': (dict(sorted_stream=True), {'resident_gather': 6,
                                             'epipolar_attention': 2}),
    'v3_sorted': (dict(n_view=3, sorted_stream=True),
                  {'resident_gather': 6, 'epipolar_attention': 2}),
    'v3_compat_onehot': (dict(n_view=3, reference_exchange_compat=True,
                              fused_mlp=True, gather='onehot'),
                         {'onehot_gather': 6, 'epipolar_attention': 2,
                          'fused_mlp2': 9}),
    # every level of the narrow 64x64 model is small enough for K8
    'v3_compat_banded': (dict(n_view=3, reference_exchange_compat=True,
                              fused_mlp=True, gather='banded'),
                         {'banded_gather': 6, 'epipolar_attention': 2,
                          'fused_mlp2': 9}),
}


@pytest.mark.parametrize('path', sorted(F32_PATHS))
def test_f32_model_renders_on_every_path(dev, path):
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    kw, want_launches = F32_PATHS[path]
    n_view = kw.get('n_view', 2)
    wrappers = {w.__name__: w for w in (
        EA.epipolar_attention, GE.fused_exchange_epilogue,
        GE.fused_exchange_epilogue_multi, FR.fused_render_core,
        FM.fused_mlp2, SG.resident_gather, PG.onehot_gather,
        BG.banded_gather)}
    ref = CrossAttentionRenderer(seed=1, device='cpu', **NARROW, **kw)
    model = CrossAttentionRenderer(dtype=torch.float32, seed=1, device=dev,
                                   **NARROW, **kw)
    s_cpu = make_scene(1, n_view=n_view, H=64, W=64, n_rays=512,
                       device='cpu')
    s_dev = make_scene(1, n_view=n_view, H=64, W=64, n_rays=512, device=dev)
    with torch.inference_mode():
        want = ref(s_cpu)['rgb']
        for w in wrappers.values():
            w.launches = 0
        got = model(s_dev)['rgb']
        torch.cuda.synchronize()
    launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    assert launches == want_launches, launches
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    err = _max_err(got.cpu(), want)
    print(f'{path}: f32 card render vs f32 CPU render, max err {err:.3e}')
    assert err <= 0.1 * _scale(want)


def test_f32_train_step_kernel_route(dev, monkeypatch):
    """A narrow f32 model's train step through the kernels
    (CAR_TRAIN_KERNELS=1: K2 and 2 K1 in f32) against the default route
    from the same parameters and batch: losses within 2^-5 relative, each
    gradient as in the bf16 route test."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from cross_attention_renderer_torch.train import trainer as T
    scene = make_scene(1, batch=2, H=64, W=64, n_rays=256, device=dev)
    cfg = T.TrainConfig(clip_norm=1e9)
    runs = {}
    for route in ('default', 'kernels'):
        monkeypatch.setenv('CAR_TRAIN_KERNELS',
                           '1' if route == 'kernels' else '0')
        model = CrossAttentionRenderer(dtype=torch.float32, seed=1,
                                       device=dev, **NARROW)
        state = T.create_train_state(model, cfg)
        k1, k2 = EA.epipolar_attention, GE.fused_exchange_epilogue
        before = (k1.launches, k2.launches)
        _, m = T.make_train_step(model, cfg)(state, scene)
        torch.cuda.synchronize()
        launches = (k1.launches - before[0], k2.launches - before[1])
        assert launches == ((2, 1) if route == 'kernels' else (0, 0))
        runs[route] = (float(m['total_loss']),
                       {n: p.grad.float() for n, p in
                        model.named_parameters()})
    (loss_d, g_d), (loss_k, g_k) = runs['default'], runs['kernels']
    total = float(sum(g.norm() ** 2 for g in g_d.values())) ** 0.5
    errs = {name: float((g_k[name] - g).norm()) / max(float(g.norm()),
                                                      1e-3 * total)
            for name, g in g_d.items()}
    worst = max(errs, key=errs.get)
    print(f'narrow f32 train step, kernel vs default route: loss '
          f'{abs(loss_k - loss_d) / abs(loss_d):.3e} relative, worst '
          f'gradient {worst} {errs[worst]:.3e}')
    assert abs(loss_k - loss_d) <= 2 ** -5 * abs(loss_d)
    assert errs[worst] <= 0.25, (worst, errs[worst])


# The row-gather probes' instantiations (T1-T13): (entry point, options,
# table shape, dtype); M is ragged (not a multiple of bm) where the
# instantiation takes it, and the indices run past both ends of the table.
ROW_GATHERS = [
    ('copy', dict(bm=512, unroll=1, index='shared'), (3000, 1024),
     torch.bfloat16),                                           # T1
    ('copy', dict(bm=512, unroll=8, index='shared'), (3000, 1024),
     torch.bfloat16),                                           # T1
    ('bulk', dict(bm=512, window=16), (3000, 1024), torch.bfloat16),  # T2
    ('copy', dict(bm=2048, unroll=4), (5000, 256), torch.bfloat16),   # T3
    ('copy', dict(bm=512, unroll=8), (700, 16, 128), torch.bfloat16),  # T4
    ('copy', dict(bm=512, index='shared'), (8192, 256), torch.float32),
    ('copy', dict(bm=512, index='shared', stage=True), (8192, 256),
     torch.float32),                                            # T9
    ('bulk', dict(bm=512, window=1), (8192, 256), torch.float32),  # T10
    ('copy', dict(bm=512, unroll=1), (8192, 256), torch.float32),  # T12
    ('copy', dict(bm=512, index='bulk'), (8192, 256), torch.float32),
]


@pytest.mark.parametrize('entry,kw,shape,dtype', ROW_GATHERS)
def test_row_gather_kernels(dev, entry, kw, shape, dtype):
    """Each probe instantiation equals ``table[clip(idx)]`` bit for bit."""
    g = torch.Generator(device='cpu').manual_seed(len(shape) + shape[0])
    table = torch.randn(shape, generator=g).to(dev, dtype)
    M = 4 * 1000 if kw.get('index') == 'bulk' else 4 * 1000 + 3
    idx = torch.randint(-5, shape[0] + 5, (M,), generator=g,
                        dtype=torch.int32).to(dev)
    fn = RG.copy_gather if entry == 'copy' else RG.bulk_gather
    before = fn.launches
    got = fn(table, idx, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got, RG.row_gather_reference(table, idx))


# The launch geometry's edges (``row_gather.launch_plan``): each gather
# option at rows of 16 B to 4 KB, on a table smaller than any block's rows
# and on a larger one, at M of 1, 3, one less and one more than the rows a
# warp has in flight, one less than a block's tile, and a ragged M of more
# tiles than the grid has blocks (the grid-stride loop); the bulk gathers'
# blocks hold several issuing warps. Row widths as (table shape, dtype).
GATHER_ROWS = {16: ((4,), torch.float32), 512: ((256,), torch.bfloat16),
               1024: ((256,), torch.float32),
               2048: ((1024,), torch.bfloat16),
               4096: ((16, 128), torch.bfloat16)}
GATHER_OPTIONS = [
    ('copy', dict(unroll=1)), ('copy', dict(unroll=4, index='shared')),
    ('copy', dict(unroll=8, index='bulk')),
    ('copy', dict(index='shared', stage=True)),
    ('bulk', dict(window=1)), ('bulk', dict(window=16))]


@pytest.mark.parametrize('row_bytes', sorted(GATHER_ROWS))
@pytest.mark.parametrize('entry,kw', GATHER_OPTIONS)
def test_row_gather_launch_geometry(dev, entry, kw, row_bytes):
    """Every edge of the launch plan equals ``table[clip(idx)]`` bit for bit,
    one launch a call."""
    tail, dtype = GATHER_ROWS[row_bytes]
    fn = RG.copy_gather if entry == 'copy' else RG.bulk_gather
    sms = RG.sm_count(dev)
    kind = 'copy' if entry == 'copy' else 'bulk'
    opts = {k: v for k, v in kw.items() if k != 'stage'}
    small = RG.launch_plan(kind, 4096, row_bytes, sms, **kw)
    big = RG.launch_plan(kind, 1 << 16, row_bytes, sms, **kw)
    Ms = {1, 3, small.in_flight - 1, small.in_flight + 1, small.tile - 1,
          big.tile * big.grid * (3 if kind == 'copy' else 1) + 5}
    if kw.get('index') == 'bulk':
        Ms = {m + (-m) % 4 for m in Ms}
    g = torch.Generator(device='cpu').manual_seed(row_bytes)
    for hw in (5, 3000):
        table = torch.randn((hw,) + tail, generator=g).to(dev, dtype)
        for M in sorted(m for m in Ms if m > 0):
            idx = torch.randint(-7, hw + 7, (M,), generator=g,
                                dtype=torch.int32).to(dev)
            before = fn.launches
            got = fn(table, idx, **kw)
            torch.cuda.synchronize()
            assert fn.launches == before + 1, (M, hw, opts)
            assert torch.equal(got, RG.row_gather_reference(table, idx)), (
                M, hw, fn.last_plan)
    if kind == 'bulk':
        assert fn.last_plan.warps > 1


def test_release_l2_leaves_the_table_and_counts_no_launch(dev):
    """``release_l2`` (undoing the gathers' evict_last marks) runs on an
    unaligned table view and changes neither the table nor the counts."""
    g = torch.Generator(device='cpu').manual_seed(0)
    table = torch.randn(3000, 256, generator=g).to(dev, torch.bfloat16)
    idx = torch.randint(0, 3000, (4096,), generator=g,
                        dtype=torch.int32).to(dev)
    want = RG.copy_gather(table, idx)
    kept, launches = table.clone(), RG.copy_gather.launches
    RG.release_l2(table)
    RG.release_l2(table[1:, 8:])
    torch.cuda.synchronize()
    assert torch.equal(table, kept)
    assert RG.copy_gather.launches == launches
    assert torch.equal(RG.copy_gather(table, idx), want)


@pytest.mark.parametrize('width', [4, 128, 512])
@pytest.mark.parametrize('bm', [64, 512, 4096])
@pytest.mark.parametrize('M', [1, 777, 2000, 2048])
def test_block_fill_kernel(dev, M, bm, width):
    """T6 and T11: each block of bm rows holds its first index, bit for
    bit, at blocks shorter than, equal to and longer than M (4096), one
    launch of ``launch_plan``'s fill plan a call."""
    idx = torch.randint(-9, 9000, (M,), dtype=torch.int32, device=dev)
    before = RG.block_fill.launches
    got = RG.block_fill(idx, bm, width)
    torch.cuda.synchronize()
    assert RG.block_fill.launches == before + 1
    assert RG.block_fill.last_plan == RG.launch_plan(
        'fill', M, width * 4, RG.sm_count(dev))
    assert torch.equal(got, RG.block_fill_reference(idx, bm, width))


def test_fill_and_bilinear_gather_replay_in_a_cuda_graph(dev):
    """The block fill and the four bilinear gather entry points capture in
    a CUDA graph, and a replay writes bit for bit what an eager call
    does."""
    idx = torch.randint(-3, 4100, (2048,), dtype=torch.int32, device=dev)
    table, cidx, w = _gather_case(dev, 2 * 64 * 64, 256, 4099, seed=3,
                                  sort=True, edges=True)
    calls = [lambda: RG.block_fill(idx, 512)] + [
        (lambda k=kernel: k(table, cidx, w)) for kernel, _ in GATHER_KERNELS]
    for call in calls:
        want = call()
        torch.cuda.synchronize()
        out = torch.zeros_like(want)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out.copy_(call())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def test_row_gather_kernels_replay_in_a_cuda_graph(dev):
    """The probe scripts time each kernel as calls captured in one CUDA
    graph (``utils/profiling.py`` ``graph_ms``): each entry point and its
    plain version capture, and a replay writes what an eager call does."""
    from cross_attention_renderer_torch.utils.profiling import graph_ms
    table = torch.randn((4096, 256), device=dev)
    idx = torch.randint(-3, 4100, (2048,), dtype=torch.int32, device=dev)
    want = RG.row_gather_reference(table, idx)
    for call in (lambda: RG.copy_gather(table, idx, index='bulk'),
                 lambda: RG.bulk_gather(table, idx, window=16),
                 lambda: RG.row_gather_reference(table, idx)):
        out = torch.zeros_like(want)
        graph = torch.cuda.CUDAGraph()
        call()
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            out.copy_(call())
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert graph_ms(call, 16) > 0
    assert graph_ms(lambda: RG.block_fill(idx, 512), 16) > 0
    assert graph_ms(lambda: RG.block_fill_reference(idx, 512), 16) > 0


def test_row_gather_refuses_what_the_kernels_do_not_take(dev):
    table = torch.zeros((64, 20), dtype=torch.bfloat16, device=dev)
    idx = torch.zeros(8, dtype=torch.int32, device=dev)
    for call in (lambda: RG.copy_gather(table, idx),          # 40-byte rows
                 lambda: RG.copy_gather(table.float()[:, :16].t(), idx),
                 lambda: RG.copy_gather(table[:, :16].half(), idx),
                 lambda: RG.copy_gather(table[:, :16].contiguous(),
                                        idx.long()),
                 lambda: RG.copy_gather(table[:, :16].contiguous(), idx,
                                        unroll=3),
                 lambda: RG.copy_gather(table[:, :16].contiguous(), idx[:6],
                                        index='bulk'),
                 lambda: RG.bulk_gather(table[:, :16].contiguous(), idx,
                                        window=4),
                 lambda: RG.block_fill(idx.long(), 4)):
        with pytest.raises(ValueError):
            call()


# Gradients through the kernels' autograd Function (ops/_autograd.py): the
# backward recomputes each kernel's plain version on the saved inputs, so
# the gradients are the plain version's own. With PyTorch's deterministic
# algorithms (index_select's backward then sums each table row's bf16
# contributions in a fixed order, not by atomics, whose order changes the
# rounding by up to ~2% of a row that takes 80 of them) both sides do the
# same arithmetic: within 2^-8 of each tensor's largest gradient. The
# parameters are f32, as the renderer's.

def _f32(params):
    return tuple(p.float() for p in params)


def _grad_case(dev, key):
    """(wrapper, plain version, arguments) of kernel ``key`` at a small
    card shape."""
    if key == 'K1':
        g = torch.Generator().manual_seed(0)
        q, k, v = (torch.randn(2, 2, 40, 16, d, generator=g).to(
            dev, torch.bfloat16) for d in (32, 32, 40))
        return EA.epipolar_attention, EA.epipolar_attention_reference, (
            q, k, v)
    if key == 'K2':
        tables, cells, (a_s, a_c), params = _epilogue_case(
            dev, (32, 32, 16), 80, 40, 16, 2, (4, 8, 16), 5 * 64 + 17)
        return (GE.fused_exchange_epilogue,
                GE.fused_exchange_epilogue_reference,
                (tables, cells, a_s, a_c, _f32(params), 40))
    if key == 'K3':
        tables, cells, aux, params = _epilogue_case(
            dev, (32, 32, 16), 80, 48, 16, 2, (4, 8, 16), 3 * 96 + 29, S=3)
        return (GE.fused_exchange_epilogue_multi,
                GE.fused_exchange_epilogue_multi_reference,
                (tables, cells, aux, _f32(params)))
    if key == 'K4':
        tables, cells, a_s, a_c, lc, params = _render_case(
            dev, (32, 32, 16), 80, 40, 16, (4, 8, 16), 1, 9, 16)
        return (FR.fused_render_core, FR.fused_render_core_reference,
                (tables, cells, a_s, a_c, lc, _f32(params), 1, 9, 16, True))
    if key == 'K9':
        rng = np.random.default_rng(2)
        M, K1, Hd, O = 64 * 5 + 23, 96, 80, 40
        w1 = rng.standard_normal((K1 + 3, Hd)) / np.sqrt(K1 + 3)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        return FM.fused_mlp2, FM.fused_mlp2_reference, (
            _bf(dev, rng.standard_normal((M, K1))),
            _bf(dev, rng.uniform(-1, 1, (M, 3))), f32(w1[:K1]),
            f32(w1[K1:]), f32(0.1 * rng.standard_normal(Hd)),
            f32(rng.standard_normal((Hd, O)) / np.sqrt(Hd)),
            f32(0.1 * rng.standard_normal(O)))
    kernel, out = dict(zip(('K5', 'K6', 'K7', 'K8'), GATHER_KERNELS))[key]
    table, idx, w = _gather_case(dev, 2 * 16 * 16, 32, 1003, seed=4,
                                 sort=key == 'K5')
    return (lambda t, i, x: kernel(t, i, x),
            lambda t, i, x: SG.plain_gather(t, i, x, out), (table, idx, w))


@pytest.mark.parametrize('key', ['K1', 'K2', 'K3', 'K4', 'K5', 'K6', 'K7',
                                 'K8', 'K9'])
def test_kernel_gradients_equal_plain_version(dev, key):
    """Each kernel's outputs all carry a gradient; the forward launches the
    kernel once and the backward none; the gradients of every floating
    input (at_wt's cotangent included) equal the plain version's."""
    from torch_grad_cases import max_rel_err, outputs_and_grads
    fn, plain, args = _grad_case(dev, key)
    counters = (EA.epipolar_attention, GE.fused_exchange_epilogue,
                GE.fused_exchange_epilogue_multi, FR.fused_render_core,
                FM.fused_mlp2, SG.resident_gather, SG.windowed_gather,
                PG.onehot_gather, BG.banded_gather)
    before = sum(c.launches for c in counters)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, grads = outputs_and_grads(fn, args)
        torch.cuda.synchronize()
        assert sum(c.launches for c in counters) == before + 1
        _, want = outputs_and_grads(plain, args)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    assert len(grads) == len(want)
    for i, (got, w) in enumerate(zip(grads, want)):
        assert (got is None) == (w is None), i
        if w is not None:
            assert torch.isfinite(got.float()).all()
            assert max_rel_err(got, w) <= 2 ** -8, (key, i)


# A narrow model's bf16 train step on the kernel route against the default
# route from the same parameters and batch: the kernel route's forward runs
# K2 and K1 (f32 until each product's input), the default route's the
# unfused exchange and the plain attention, so their rgb differ by a few
# bf16 steps. The loss within 2^-5 relative; each tensor's gradient within
# 0.25 of the larger of its norm and 1e-3 of the whole gradient's norm.
NARROW = dict(npoints=16, fusion_features=32, vit_width=64, vit_depth=2,
              vit_heads=2, resnet_layers=(1, 1, 1))


def test_train_step_kernel_route_matches_default_route(dev):
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from cross_attention_renderer_torch.tools import bench_train as BT
    from cross_attention_renderer_torch.train import trainer as T
    scene = make_scene(1, batch=2, H=64, W=64, n_rays=256, device=dev)
    cfg = T.TrainConfig(clip_norm=1e9)
    runs = {}
    for route in BT.ROUTES:
        model = CrossAttentionRenderer(dtype=torch.bfloat16, seed=1,
                                       device=dev, **NARROW)
        state = T.create_train_state(model, cfg)
        k1, k2 = EA.epipolar_attention, GE.fused_exchange_epilogue
        before = (k1.launches, k2.launches)
        _, m = BT.make_route_step(model, cfg, route)(state, scene)
        torch.cuda.synchronize()
        launches = (k1.launches - before[0], k2.launches - before[1])
        assert launches == ((2, 1) if route == 'kernels' else (0, 0))
        runs[route] = (float(m['total_loss']),
                       {n: p.grad.float() for n, p in
                        model.named_parameters()})
    (loss_d, g_d), (loss_k, g_k) = runs['default'], runs['kernels']
    total = float(sum(g.norm() ** 2 for g in g_d.values())) ** 0.5
    errs = {name: float((g_k[name] - g).norm()) / max(float(g.norm()),
                                                      1e-3 * total)
            for name, g in g_d.items()}
    worst = max(errs, key=errs.get)
    print(f'narrow train step, kernel vs default route: loss '
          f'{abs(loss_k - loss_d) / abs(loss_d):.3e} relative, worst '
          f'gradient {worst} {errs[worst]:.3e}')
    assert abs(loss_k - loss_d) <= 2 ** -5 * abs(loss_d)
    assert errs[worst] <= 0.25, (worst, errs[worst])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
@pytest.mark.parametrize('channels,H1,O,K,hw,M,S', [
    # the flagship's widths: 'resident' from S = 4
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 3 * 64 + 29, 5),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 2 * 64 + 7, 6),
    ((256, 256, 64), 576, 288, 128, (16, 32, 64), 150, 8),
    # narrow widths keep 'smem' at S = 8; S*O not a multiple of 64
    ((32, 32, 16), 80, 48, 16, (4, 8, 16), 2 * 64 + 7, 7),
    ((32, 32, 16), 80, 40, 16, (4, 8, 16), 130, 8),
    # four levels at the ResNet34's widths ('resident' at 5 and 6)
    ((256, 128, 64, 64), 512, 256, 128, (8, 16, 32, 32), 3 * 64 + 11, 5),
    ((256, 128, 64, 64), 512, 256, 128, (8, 16, 32, 32), 2 * 64 + 3, 6),
])
def test_exchange_epilogue_multi_any_stream_count(dev, channels, H1, O, K,
                                                  hw, M, S, dtype):
    """K3 at S = 5 to 8 streams in bf16 and f32, its aux rows handed as
    views of one tensor and as S separate arrays: both equal, within the
    stated fraction of the plain version, and the plan the one core_plan
    predicts."""
    tables, cells, aux, params = _epilogue_case(
        dev, channels, H1, O, K, 3, hw, M, S=S, seed=S)
    tables = tuple(t.to(dtype) for t in tables)
    params = tuple(p.to(dtype) for p in params)
    whole = torch.stack(aux).to(dtype)
    views = tuple(whole.unbind(0))
    copies = tuple(a.clone() for a in views)
    jl, kv = GE.fused_exchange_epilogue_multi(tables, cells, views, params)
    jl2, kv2 = GE.fused_exchange_epilogue_multi(tables, cells, copies,
                                                params)
    torch.cuda.synchronize()
    plan = GE.core_plan('streams', S, sum(channels), H1, O, K,
                        levels=len(channels))[0]
    assert GE.fused_exchange_epilogue_multi.last_plan == plan
    jl_ref, kv_ref = GE.fused_exchange_epilogue_multi_reference(
        tables, cells, views, params)
    assert torch.equal(jl, jl2) and torch.equal(kv, kv2)
    assert jl.dtype == dtype and jl.shape == (M, O) and kv.shape == (M, K)
    assert torch.isfinite(jl.float()).all() and torch.isfinite(kv.float()).all()
    assert _max_err(jl, jl_ref) <= 2 ** -5 * _scale(jl_ref)
    assert _max_err(kv, kv_ref) <= 2 ** -5 * _scale(kv_ref)


# int8 tables (the quantized pyramid of fast evaluation) beside bf16 or f32
# aux, local coordinates and weights: K2, K3 and K4's int8 instantiations
# against their plain versions, which cast the rows to aux's type and
# combine in it. The rows are integers in [-127, 127] and W1's feature rows
# carry the 1/127-scale a quantization folds into them, so the products
# have the float cases' magnitudes; the tolerances are the float cases'.
# Shapes: fusion_features 256 ('smem' plan) and 512 ('resident' for K2 and
# K3, 'global' for K4), K4 also at the pruned renderer's P = 8 and 24.
def _int8_case(dev, key, ff, dtype, P=64):
    channels, H1, O, K = (ff, ff, 64), 2 * ff + 64, ff + 32, 128
    hw = (8, 16, 32)
    F = sum(channels)
    if key == 'K4':
        t, c, a_s, a_c, lc, prm = _render_case(dev, channels, H1, O, K, hw,
                                               1, 5, P)
        rest, aux = (lc, prm), (a_s, a_c)
    else:
        S = 2 if key == 'K2' else int(key[-1]) if '=' in key else 3
        t, c, aux, prm = _epilogue_case(dev, channels, H1, O, K, S, hw,
                                        3 * 64 + 37, S=S, seed=S)
        rest = (prm,)
    rng = np.random.default_rng(5)
    tables = tuple(torch.as_tensor(rng.integers(-127, 128, x.shape),
                                   dtype=torch.int8).to(dev) for x in t)
    w1 = prm[0].float().clone()
    w1[:F] *= 1.0 / 127
    prm = (w1,) + tuple(prm[1:])
    aux = tuple(a.to(dtype) for a in aux)
    if key == 'K4':
        return (FR.fused_render_core, FR.fused_render_core_reference,
                (tables, c, *aux, lc.to(dtype), prm, 1, 5, P, True),
                {0: 2 ** -5, 1: 2 ** -8})
    if key == 'K2':
        return (GE.fused_exchange_epilogue,
                GE.fused_exchange_epilogue_reference,
                (tables, c, *aux, prm, 100), {0: 2 ** -5, 1: 2 ** -5})
    return (GE.fused_exchange_epilogue_multi,
            GE.fused_exchange_epilogue_multi_reference,
            (tables, c, aux, prm), {0: 2 ** -5, 1: 2 ** -5})


INT8_CASES = ([(k, ff, 64) for k in ('K2', 'K3', 'K4')
               for ff in (102, 256, 512)]
              + [('K4', 256, 8), ('K4', 256, 24), ('K3 S=5', 256, 64),
                 ('K3 S=8', 256, 64), ('K3 S=5', 100, 64)])


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
@pytest.mark.parametrize('key,ff,P', INT8_CASES)
def test_int8_tables_against_plain_int8(dev, key, ff, P, dtype):
    """Each int8 instantiation launches (one counted launch), writes
    outputs in aux's type and of the plain version's shapes, finite,
    within the stated fraction of max(1, max |plain|) (K4's weights within
    an absolute 2^-8)."""
    fn, plain, args, tols = _int8_case(dev, key, ff, dtype, P)
    before = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = plain(*args)
    print(f'{key} int8 ff={ff} P={P} {dtype}: plan {fn.last_plan}')
    for i, tol in tols.items():
        g, w = got[i], want[i]
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.isfinite(g.float()).all()
        bound = tol if (key, i) == ('K4', 1) else tol * _scale(w)
        err = _max_err(g, w)
        print(f'  output {i}: max err {err:.3e} (tol {bound:.3e})')
        assert err <= bound, (key, ff, P, i, err, bound)


def test_int8_tables_refuse_mixed_types(dev):
    """int8 tables are taken beside bf16 or f32 aux only; a table of
    another integer type, and int8 beside f16 aux, are refused."""
    tables, cells, a_s, a_c, lc, params = _render_case(
        dev, (32, 32, 16), 80, 40, 16, (4, 8, 16), 1, 3, 4)
    i8 = [torch.zeros_like(t, dtype=torch.int8) for t in tables]
    with pytest.raises(ValueError):
        FR.fused_render_core([t.to(torch.int16) for t in i8], cells, a_s,
                             a_c, lc, params, 1, 3, 4, True)
    with pytest.raises(ValueError):
        GE.fused_exchange_epilogue(i8, cells, a_s.half(), a_c.half(),
                                   params[:10], 12)


# A narrow model's fast-eval render (the CLI's --fast composition: pruned
# 4,8, narrow, q8) in bf16 on the card against its f32 render on the CPU,
# through the same entry point: chip_smoke.py's small-input gate. Per
# image of 2 blocks: the coarse and the fine pass of each block.
FAST_PATHS = {
    'v2': (dict(), {'epipolar_attention': 6, 'fused_exchange_epilogue': 4}),
    'v2_fused_render': (dict(fused_render=True), {'fused_render_core': 4}),
    'v3': (dict(n_view=3), {'epipolar_attention': 6,
                            'fused_exchange_epilogue_multi': 4}),
}


@pytest.mark.parametrize('path', sorted(FAST_PATHS))
def test_fast_renderer_on_the_card_matches_the_cpu(dev, path):
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer)
    kw, want_launches = FAST_PATHS[path]
    n_view = kw.get('n_view', 2)
    wrappers = {w.__name__: w for w in (
        EA.epipolar_attention, GE.fused_exchange_epilogue,
        GE.fused_exchange_epilogue_multi, FR.fused_render_core)}
    fast = dict(pruned=(4, 8), narrow=(16, 16, 32), q8=True)
    out = {}
    for where, dtype in (('cpu', torch.float32), (dev, torch.bfloat16)):
        model = CrossAttentionRenderer(dtype=dtype, seed=1, device=where,
                                       **NARROW, **kw)
        scene = make_scene(1, n_view=n_view, H=64, W=64, n_rays=512,
                           device=where)
        with torch.inference_mode():
            z = model.encode(scene)
        for w in wrappers.values():
            w.launches = 0
        rgb, _ = make_fast_renderer(model, 2, **fast)(
            scene, z, scene['query']['uv'])
        out[str(where)] = rgb.float().cpu()
    launches = {n: w.launches for n, w in wrappers.items() if w.launches}
    assert launches == want_launches, launches
    got, want = out[str(dev)], out['cpu']
    assert torch.isfinite(got).all()
    err = _max_err(got, want)
    print(f'{path}: fast bf16 card render vs f32 CPU render, max err '
          f'{err:.3e}')
    assert err <= 0.1 * _scale(want)


def test_fast_renderer_layout_cache_stays_bounded(dev):
    """Each image's folded fuse kernel is a new tensor, so K2 lays out its
    weights again for each image; the entries of the images before are
    dropped, so the cache holds as many entries after the fifth image as
    after the second."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer)
    model = CrossAttentionRenderer(dtype=torch.bfloat16, seed=1, device=dev,
                                   **NARROW)
    render = make_fast_renderer(model, 2, narrow=(16, 16, 32), q8=True)
    sizes = []
    for seed in range(5):
        scene = make_scene(seed, H=64, W=64, n_rays=256, device=dev)
        with torch.inference_mode():
            z = model.encode(scene)
        render(scene, z, scene['query']['uv'])
        torch.cuda.synchronize()
        sizes.append(len(GE._PREPARED))
    assert sizes[1:] == [sizes[1]] * 4, sizes


# The 'resident' plan (comb in shared memory, the f rows in the scratch,
# read one k-block ahead) at the rows it was made for: K3 at the
# flagship's widths at S = 4 and 6 (bf16, f32, int8), K3 at the U-Net's and
# the ResNet34's four levels, K2 and K4 at the U-Net's.
RESIDENT_CASES = {
    'K3 S=4': ('streams', (256, 256, 64), 576, 288, (16, 32, 64), 4),
    'K3 S=6': ('streams', (256, 256, 64), 576, 288, (16, 32, 64), 6),
    'K3 ResNet34 S=5': ('streams', (256, 128, 64, 64), 512, 256,
                        (8, 16, 32, 32), 5),
    'K3 U-Net V=3': ('streams', (64, 128, 256, 512), 960, 480,
                     (32, 16, 8, 4), 3),
    'K2 U-Net': ('pair', (64, 128, 256, 512), 960, 480, (32, 16, 8, 4), 2),
    'K4 U-Net': ('render', (64, 128, 256, 512), 960, 480, (32, 16, 8, 4), 2),
}


@pytest.mark.parametrize('table', ['bf16', 'f32', 'int8'])
@pytest.mark.parametrize('key', sorted(RESIDENT_CASES))
def test_resident_plan_against_plain_and_repeatable(dev, key, table):
    """Each case takes the 'resident' plan with the stage slots
    ``core_plan`` names, matches its plain version within the stated
    fraction, and gives the same bits on 5 more calls (the f rows the
    consumers store are read back by the other warpgroup: a stale read
    would show as a difference between calls)."""
    mode, channels, H1, O, hw, S = RESIDENT_CASES[key]
    K = 128
    if mode == 'render':
        case = _render_case(dev, channels, H1, O, K, hw, 1, 9, 64)
        tables, cells, a_s, a_c, lc, params = case
        aux = (a_s, a_c)
        fn, plain = FR.fused_render_core, FR.fused_render_core_reference
    else:
        tables, cells, aux, params = _epilogue_case(
            dev, channels, H1, O, K, 3, hw, 5 * 64 + 13, S=S, seed=S)
        fn, plain = ((GE.fused_exchange_epilogue,
                      GE.fused_exchange_epilogue_reference) if mode == 'pair'
                     else (GE.fused_exchange_epilogue_multi,
                           GE.fused_exchange_epilogue_multi_reference))
    dtype = torch.float32 if table == 'f32' else torch.bfloat16
    if table == 'int8':
        rng = np.random.default_rng(5)
        tables = tuple(torch.as_tensor(rng.integers(-127, 128, t.shape),
                                       dtype=torch.int8).to(dev)
                       for t in tables)
        w1 = params[0].clone()
        w1[:sum(channels)] *= 1.0 / 127
        params = (w1,) + tuple(params[1:])
    else:
        tables = tuple(t.to(dtype) for t in tables)
    params = tuple(p.to(dtype) for p in params)
    aux = tuple(a.to(dtype) for a in aux)
    if mode == 'render':
        args = (tables, cells, *aux, lc.to(dtype), params, 1, 9, 64, True)
    elif mode == 'pair':
        args = (tables, cells, *aux, params, 100)
    else:
        args = (tables, cells, aux, params)
    got = fn(*args)
    torch.cuda.synchronize()
    want = GE.core_plan(mode, S, sum(channels), H1, O, K,
                        64 if mode == 'render' else 0, levels=len(channels))
    assert want.plan == 'resident'
    assert (fn.last_plan, fn.last_launch[1] // 2) == (want.plan, want.slots)
    for _ in range(5):
        again = fn(*args)
        for g, a in zip(got, again):
            assert torch.equal(g, a)
    ref = plain(*args)
    for i, (g, w) in enumerate(zip(got, ref)):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        if mode == 'render' and i == 1:
            assert _max_err(g, w) <= 2 ** -8
        else:
            assert _max_err(g, w) <= 2 ** -5 * _scale(w)


# --- the exchange streams' address math ------------------------------------

# (V, levels, aux type, B, R, P): the 2-view flagship's and co3d's block
# shapes cut to R rays, 4-level pyramids, f32 models, B = 4 (the batch4
# evaluation), an odd P (the pruned renderer's fine pass), V = 5, and 40
# scenes of 5 views, whose transforms exceed what the kernel stages in
# shared memory
STREAM_CASES = [(2, 3, torch.bfloat16, 1, 64, 64),
                (2, 4, torch.float32, 4, 24, 48),
                (3, 3, torch.bfloat16, 4, 24, 48),
                (3, 4, torch.bfloat16, 1, 64, 7),
                (5, 3, torch.float32, 1, 32, 48),
                (5, 4, torch.bfloat16, 4, 16, 7),
                (3, 3, torch.float32, 1, 32, 64),
                (5, 4, torch.float32, 40, 4, 9)]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize('V,levels,dtype,B,R,P', STREAM_CASES)
def test_stream_takes_kernel(dev, V, levels, dtype, B, R, P):
    """The address math kernel, one launch, against its plain version on
    the card, on the planted samples of ``torch_stream_cases`` (NaN, inf
    and huge points, points behind the camera, 1e10 sentinel projections,
    coords on cell edges and image borders, dead 'zeros' samples): every
    cell equal and every aux value equal bit for bit (no exception)."""
    case = stream_case(V, levels, B, R, P, seed=100 * V + 10 * levels + B,
                       device=dev)
    args = (case['level_hw'], case['pixel_val'], case['pt_views'],
            case['ctx_c2w'], case['ctx_intr'], case['H'], case['W'], dtype)
    before = ST.stream_takes.launches
    cells, aux = ST.stream_takes(*args)
    assert ST.stream_takes.launches == before + 1
    pt_in = ST.exchange_points(case['pt_views'], case['ctx_c2w'])
    want_cells, want_aux = ST.stream_takes_reference(
        case['level_hw'], case['pixel_val'], pt_in, case['ctx_intr'],
        case['H'], case['W'], dtype)
    torch.cuda.synchronize()
    M = B * V * R * P
    for l, (got, want) in enumerate(zip(cells, want_cells)):
        diff = (got != want).reshape(V, M).sum(-1).tolist()
        assert diff == [0] * V, f'level {l}: cells differ by stream {diff}'
    t_col, width = GE.aux_layout(levels)
    for s, (got, want) in enumerate(zip(aux, want_aux)):
        assert got.dtype == dtype and got.shape == want.shape == (M, width)
        diff = (_bits(got) != _bits(want)).sum(0).tolist()
        assert diff == [0] * width, (f'stream {s}: aux bits differ by '
                                     f'column {diff}')
    # the planted branches were reached: dead cross samples on row 0, and
    # samples with non-finite (NaN) self-stream weights
    assert any(bool((a[:, :4 * levels] == 0).all(-1).any()) for a in aux[1:])
    assert bool(torch.isnan(aux[0][:, :4 * levels].float()).any())


def test_stream_takes_refuses_grad_and_renders_a_block_in_one_launch(dev):
    """CUDA inputs that require a gradient are refused under grad mode (no
    graph is cut silently); a forward of a V=2 and a V=3 model launches
    the kernel once a block, under ``car.address_math``."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    case = stream_case(2, 3, 1, 8, 16, device=dev)
    args = [case['level_hw'], case['pixel_val'], case['pt_views'],
            case['ctx_c2w'].clone().requires_grad_(), case['ctx_intr'],
            case['H'], case['W'], torch.bfloat16]
    with pytest.raises(ValueError, match='gradient'):
        ST.stream_takes(*args)
    with torch.no_grad():
        ST.stream_takes(*args)
    for n_view in (2, 3):
        model = CrossAttentionRenderer(n_view=n_view, dtype=torch.bfloat16,
                                       seed=1, device=dev, **NARROW)
        scene = make_scene(1, n_view=n_view, H=64, W=64, n_rays=512,
                           device=dev)
        before = ST.stream_takes.launches
        with torch.inference_mode():
            model(scene)
        torch.cuda.synchronize()
        assert ST.stream_takes.launches == before + 1
