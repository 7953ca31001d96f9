"""The weights of the exchange core's kernels K2, K3, K9 and K4 as they read
them (``ops/gather_epilogue.py:layout_stages``, ``layout_mlp``,
``layout_render``), on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
Here: the laid-out stages unpack to the weights exactly; walking them in the
kernel's order (``csrc/exchange_core.cuh``) with the kernel's arithmetic in
f32 gives the JAX references' epilogue (f32 sums in another order: rtol
1e-4); the layout is built once per set of parameters and again after an
in-place change; the wrappers refuse what the kernel does not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.ops.gather_epilogue as JGE
from cross_attention_renderer_tpu.ops import fused_render as JFR
from cross_attention_renderer_tpu.ops.experimental import fused_mlp as JFM
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.ops import gather_epilogue as GE

SHAPES = [  # (channels, H1, O, K, S)
    ((32, 32, 16), 80, 40, 16, 2),
    ((256, 256, 64), 576, 288, 128, 2),
    ((256, 256, 64), 576, 288, 128, 3),
    ((48,), 96, 48, 32, 2),
    ((32, 16), 48, 32, 32, 3),
    ((32, 32, 16), 80, 40, 16, 4),
    ((288, 288, 64), 640, 320, 128, 3),
]


def _cdiv(a, b):
    return -(-a // b)


def _untiles(t, N, D):
    """Inverse of ``GE._tiles``: the (N, D) weight back from its tiles."""
    nt, nkb, n_rows, _ = t.shape
    t = t.reshape(nt, nkb, n_rows, 8, 8)
    t = torch.gather(t, 3, GE._swizzle_index(n_rows, t.shape, t.device))
    return t.permute(0, 2, 1, 3, 4).reshape(nt * n_rows, nkb * 64)[:N, :D]


def _unpack_stages(stages, F, H1, O, K, S):
    """The (out, in) weights back from ``GE.layout_stages``' stream:
    ``w1t`` (H1, F), ``w2t`` (O, H1), ``lvt`` (O, S*O), ``kmt`` (K, S*O),
    ``k2t`` (K, K)."""
    nch, nkbF, OT = _cdiv(H1, 64), _cdiv(F, 64), _cdiv(O, 96)
    KT, nkbf, nkbK = _cdiv(K, 64), _cdiv(S * O, 64), _cdiv(K, 64)
    per_chunk = (nkbF * 64 + OT * 96) * 64
    mlp = stages[:nch * per_chunk].reshape(nch, per_chunk)
    t1 = mlp[:, :nkbF * 64 * 64].reshape(nch, nkbF, 64, 64)
    t2 = mlp[:, nkbF * 64 * 64:].reshape(nch, OT, 96, 64).transpose(0, 1)
    sizes = (nkbf * OT * 96 * 64, nkbf * KT * 64 * 64, KT * nkbK * 64 * 64)
    tl, tm, tk = torch.split(stages[nch * per_chunk:], sizes)
    return {
        'w1t': _untiles(t1, H1, F), 'w2t': _untiles(t2, O, H1),
        'lvt': _untiles(tl.reshape(nkbf, OT, 96, 64).transpose(0, 1),
                        O, S * O),
        'kmt': _untiles(tm.reshape(nkbf, KT, 64, 64).transpose(0, 1),
                        K, S * O),
        'k2t': _untiles(tk.reshape(KT, nkbK, 64, 64), K, K)}


def _params(F, H1, O, K, S, seed=0):
    """The ten epilogue weights, rounded to bf16 values (kept in f32), as
    the kernel reads them."""
    rng = np.random.default_rng(seed)
    shapes = ((F + 3, H1), (H1,), (H1, O), (O,), (S * O, O), (O,),
              (S * O, K), (K,), (K, K), (K,))
    return [torch.from_numpy(
        (rng.standard_normal(s) / np.sqrt(s[0] if len(s) > 1 else 10))
        .astype(np.float32)).to(torch.bfloat16).float() for s in shapes]


@pytest.mark.parametrize('channels,H1,O,K,S', SHAPES)
def test_layout_unpacks_to_the_weights(channels, H1, O, K, S):
    F = sum(channels)
    p = _params(F, H1, O, K, S)
    stages, vecs = GE.layout_stages(p, S)
    assert stages.dtype == torch.bfloat16 and vecs.dtype == torch.float32
    got = _unpack_stages(stages, F, H1, O, K, S)
    bf = torch.bfloat16
    want = {'w1t': p[0][:F].to(bf).t(), 'w2t': p[2].to(bf).t(),
            'lvt': p[4].to(bf).t(), 'kmt': p[6].to(bf).t(),
            'k2t': p[8].to(bf).t()}
    for key, w in want.items():
        assert torch.equal(got[key], w), key
    H1p, Op, Kp = _cdiv(H1, 64) * 64, _cdiv(O, 96) * 96, _cdiv(K, 64) * 64
    parts = torch.split(vecs, [3 * H1p, H1p, Op, Op, Kp, Kp])
    for part, v, n in zip(parts, (p[0][F:F + 3], p[1], p[3], p[5], p[7],
                                  p[9]), (H1p, H1p, Op, Op, Kp, Kp)):
        part = part.reshape(-1, n)
        assert torch.equal(part[:, :v.shape[-1]], v.reshape(-1, v.shape[-1]))
        assert not part[:, v.shape[-1]:].any()


def _reader(stages):
    """stage(off, rows): the (rows, 64) tile at element offset ``off`` of
    the stream, unswizzled, as f32 (output units by k-values)."""
    st = stages.float()

    def stage(off, rows):
        t = st[off:off + rows * 64].reshape(1, 1, rows, 64)
        return _untiles(t, rows, 64)
    return stage


def _fuse_walk(stage, wt, b1, b2, comb, th, F, H1, O):
    """One stream's fuse MLP (f32) as the core's warpgroups read its stages
    (csrc/exchange_core.cuh ``produce``): up to three O tiles, every chunk's
    W1 k-blocks then its W2 tiles (the two warpgroups split the chunks and
    add their partial f: the sum is the same); above that each
    warpgroup's half of the O tiles, up to three at a time, each group
    running every chunk's layer 1 again. comb (M, F); th (M, 3) the tanh
    (or x2) columns; wt (3, H1p), b1, b2 the vectors."""
    nch, nkbF, OT = _cdiv(H1, 64), _cdiv(F, 64), _cdiv(O, 96)
    chunk = (nkbF * 64 + OT * 96) * 64
    M = comb.shape[0]
    comb = torch.nn.functional.pad(comb, (0, nkbF * 64 - F))
    split = OT - OT // 2
    groups = [(0, OT)] if OT <= 3 else [
        (g, min(g + 3, e)) for a, e in ((0, split), (split, OT))
        for g in range(a, e, 3)]
    f = torch.zeros(M, OT * 96)
    for g0, g1 in groups:
        for c in range(nch):
            a1 = b1[c * 64:(c + 1) * 64] + th @ wt[:, c * 64:(c + 1) * 64]
            for kb in range(nkbF):
                a1 = a1 + (comb[:, kb * 64:(kb + 1) * 64]
                           @ stage(c * chunk + kb * 4096, 64).t())
            h = torch.relu(a1)
            for nt in range(g0, g1):
                off = c * chunk + nkbF * 4096 + nt * 96 * 64
                f[:, nt * 96:(nt + 1) * 96] += h @ stage(off, 96).t()
    return f[:, :O] + b2[:O], nch * chunk


def _walk(stages, vecs, vals, aux_list, F, H1, O, K, rp, whole=True):
    """The kernel's arithmetic in f32, reading the weights stage by stage at
    the offsets its producer streams them: per stream the fuse MLP
    (:func:`_fuse_walk`); then lv, km and k2. rp: the V=2 view swap's
    samples per view, or None. Returns (jl, kv, where the stream's
    exchange part ends); with ``whole`` that must be its end."""
    S, M = len(aux_list), aux_list[0].shape[0]
    nch, OT = _cdiv(H1, 64), _cdiv(O, 96)
    KT, nkbf, nkbK = _cdiv(K, 64), _cdiv(S * O, 64), _cdiv(K, 64)
    stage = _reader(stages)
    ldv = nch * 64
    wt, b1, b2, lvb, kmb, k2b = torch.split(
        vecs[:4 * ldv + 2 * OT * 96 + 2 * KT * 64],
        [3 * ldv, ldv, OT * 96, OT * 96, KT * 64, KT * 64])
    wt = wt.reshape(3, ldv)
    fs = torch.zeros(M, nkbf * 64)
    rows = torch.arange(M)
    for s in range(S):
        comb = GE._combine([v[s * M:(s + 1) * M] for v in vals], aux_list[s])
        f, jl0 = _fuse_walk(stage, wt, b1, b2, comb, aux_list[s][:, 12:15],
                            F, H1, O)
        slot = torch.full((M,), s)
        if rp is not None:
            slot = torch.where((rows // rp) % 2 == s, 0, 1)
        for k in range(2 if rp is not None else 1):
            sel = slot == k if rp is not None else slice(None)
            col = (k if rp is not None else s) * O
            fs[sel, col:col + O] = f[sel]
    kh0 = jl0 + nkbf * OT * 96 * 64
    kv0 = kh0 + nkbf * KT * 64 * 64
    end = kv0 + KT * nkbK * 64 * 64
    jl = torch.zeros(M, OT * 96)
    for kb in range(nkbf):
        for nt in range(OT):
            jl[:, nt * 96:(nt + 1) * 96] += (
                fs[:, kb * 64:(kb + 1) * 64]
                @ stage(jl0 + (kb * OT + nt) * 96 * 64, 96).t())
    kh = torch.zeros(M, KT * 64)
    for kb in range(nkbf):
        for nt in range(KT):
            kh[:, nt * 64:(nt + 1) * 64] += (
                fs[:, kb * 64:(kb + 1) * 64]
                @ stage(kh0 + (kb * KT + nt) * 4096, 64).t())
    kh = torch.relu(kh + kmb)
    kv = torch.zeros(M, KT * 64)
    for nt in range(KT):
        for kb in range(nkbK):
            kv[:, nt * 64:(nt + 1) * 64] += (
                kh[:, kb * 64:(kb + 1) * 64]
                @ stage(kv0 + (nt * nkbK + kb) * 4096, 64).t())
    if whole:
        assert end == stages.numel()
    return jl[:, :O] + lvb[:O], kv[:, :K] + k2b[:K], end


@pytest.mark.parametrize('channels,H1,O,K,S,M,rp', [
    ((32, 32, 16), 80, 40, 16, 2, 100, 20),
    ((32, 16), 48, 32, 32, 3, 77, None),
    ((32, 32, 16), 80, 40, 16, 4, 65, None),
    # O = 320: four O tiles, split between the warpgroups
    ((32, 32, 16), 80, 320, 16, 2, 50, 10),
    ((32, 16), 48, 320, 32, 3, 40, None),
    # O = 416 and 544 (fusion_features 384 and 512, the 'global' plan's
    # widths): five and six O tiles
    ((32, 32, 16), 80, 416, 16, 2, 30, 10),
    ((32, 16), 48, 544, 32, 3, 20, None),
])
def test_kernel_order_matches_jax_reference(channels, H1, O, K, S, M, rp):
    F = sum(channels)
    rng = np.random.default_rng(1)
    vals = [rng.standard_normal((S * M, 4 * c)).astype(np.float32)
            for c in channels]
    aux = rng.random((S, M, 16)).astype(np.float32)
    aux[:, :, 12:15] = 2 * aux[:, :, 12:15] - 1
    p = _params(F, H1, O, K, S, seed=2)
    stages, vecs = GE.layout_stages(p, S)
    jl, kv, _ = _walk(stages, vecs, [torch.from_numpy(v) for v in vals],
                      [torch.from_numpy(a) for a in aux], F, H1, O, K, rp)
    pj = tuple(jnp.asarray(t.numpy()) for t in p)
    if rp is not None:
        jl_j, kv_j = JGE._reference(tuple(map(jnp.asarray, vals)),
                                    jnp.asarray(aux[0]), jnp.asarray(aux[1]),
                                    pj, rp)
    else:
        jl_j, kv_j = JGE._reference_multi(tuple(map(jnp.asarray, vals)),
                                          tuple(map(jnp.asarray, aux)), pj)
    np.testing.assert_allclose(jl.numpy(), np.asarray(jl_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(kv.numpy(), np.asarray(kv_j), rtol=1e-4,
                               atol=1e-4)


def test_prepared_once_and_again_after_an_inplace_edit():
    p = _params(80, 80, 40, 16, 2)
    first = GE.prepared_weights(p, 2, 'cpu')
    assert GE.prepared_weights(p, 2, 'cpu') is first
    assert GE.prepared_weights([t.clone() for t in p], 2, 'cpu') is not first
    with torch.no_grad():
        p[1].add_(1.0)          # b1, in place
    again = GE.prepared_weights(p, 2, 'cpu')
    assert again is not first
    assert torch.equal(again[1][3 * 128:3 * 128 + 80],
                       p[1].to(torch.bfloat16).float())
    assert GE.prepared_weights(p, 2, 'cpu') is again


def test_inference_tensors_are_laid_out_every_call():
    with torch.inference_mode():
        p = _params(80, 80, 40, 16, 2)
        a = GE.prepared_weights(p, 2, 'cpu')
        b = GE.prepared_weights(p, 2, 'cpu')
    assert a is not b and torch.equal(a[0], b[0])


def test_renderer_hands_the_parameters_themselves():
    """The fused epilogues get the model's parameter tensors (not casts made
    per call), so their layout is built once per set of weights."""
    model = CrossAttentionRenderer(device='cpu', npoints=8,
                                   fusion_features=32, vit_width=64,
                                   vit_depth=2, vit_heads=2,
                                   resnet_layers=(1, 1, 1))
    w = model._epilogue_weights()
    params = {id(t) for t in model.parameters()}
    assert len(w) == 10 and all(id(t) in params for t in w)
    assert all(a is b for a, b in zip(w, model._epilogue_weights()))


def _core_case(O=40, K=16, S=2, M=50, H1=80):
    channels = (32, 32, 16)
    F = sum(channels)
    tables = [torch.zeros((2, 4, 4, 4 * c), dtype=torch.bfloat16)
              for c in channels]
    cells = [torch.zeros(S * M, dtype=torch.int32) for _ in channels]
    aux = [torch.zeros((M, 16), dtype=torch.bfloat16) for _ in range(S)]
    return tables, cells, aux, _params(F, H1, O, K, S)


@pytest.mark.parametrize('bad', ['f32 tables', 'strided aux', 'cells shape',
                                 'long vectors', 'wide K'])
def test_wrappers_refuse_what_the_kernel_does_not_take(bad):
    tables, cells, aux, params = _core_case()
    if bad == 'f32 tables':
        tables[0] = tables[0].float()
    elif bad == 'strided aux':
        aux[1] = torch.zeros((16, 50), dtype=torch.bfloat16).t()
    elif bad == 'cells shape':
        cells[2] = cells[2][:-1]
    elif bad == 'long vectors':
        # the vectors of H1 = 30,000 hidden units alone outgrow a block's
        # shared memory, which even the 'global' plan keeps them in
        tables, cells, aux, params = _core_case(H1=30_000)
    else:
        tables, cells, aux, params = _core_case(K=272)
    with pytest.raises(ValueError):
        GE._core_args('fused_exchange_epilogue', 'pair', tables, cells, aux,
                      params)


def test_wrappers_accept_the_case_the_refusals_start_from():
    tables, cells, aux, params = _core_case()
    levels, sizes, stages, vecs, scratch = GE._core_args(
        'fused_exchange_epilogue', 'pair', tables, cells, aux, params)
    assert sizes == (50, 80, 80, 40, 16)
    assert scratch is None      # the 'smem' plan needs no scratch
    assert stages.numel() * 2 == (2 * (2 * 8192 + 12288) + 2 * 12288
                                  + 2 * 8192 + 8192)


# ---------------------------------------------------------------------------
# K9 and K4 on the same core: their layouts, walked in the kernel's order
# ---------------------------------------------------------------------------

def _mlp_walk(stages, vecs, x1, x2, K1, H, O):
    """K9's arithmetic in f32 on ``GE.layout_mlp``'s stream: the fuse-MLP
    walk with x1 in place of comb and x2 in place of the tanh columns."""
    H1p, Op = _cdiv(H, 64) * 64, _cdiv(O, 96) * 96
    w1b, b1, b2 = torch.split(vecs, [3 * H1p, H1p, Op])
    out, end = _fuse_walk(_reader(stages), w1b.reshape(3, H1p), b1, b2, x1,
                          x2, K1, H, O)
    assert end == stages.numel()
    return out


@pytest.mark.parametrize('K1,H,O,M', [(96, 80, 40, 70), (576, 576, 288, 65),
                                      (48, 64, 16, 20), (80, 96, 320, 33),
                                      (80, 96, 416, 21), (48, 64, 544, 13)])
def test_mlp_layout_matches_jax_fused_mlp2(K1, H, O, M):
    """K9's layout (``layout_mlp``) walked in the kernel's order against JAX
    ``fused_mlp2`` off the TPU, all in f32; O = 320 takes the O tiles split
    between the warpgroups. The biases stay f32, W1b is rounded to bf16, as
    the kernel reads them."""
    rng = np.random.default_rng(5)
    x1 = rng.standard_normal((M, K1)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (M, 3)).astype(np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float()
    w = (bf(rng.standard_normal((K1, H)).astype(np.float32) / np.sqrt(K1)),
         bf(rng.standard_normal((3, H)).astype(np.float32)),
         torch.from_numpy((0.1 * rng.standard_normal(H)).astype(np.float32)),
         bf(rng.standard_normal((H, O)).astype(np.float32) / np.sqrt(H)),
         torch.from_numpy((0.1 * rng.standard_normal(O)).astype(np.float32)))
    stages, vecs = GE.layout_mlp(*w)
    got = _mlp_walk(stages, vecs, torch.from_numpy(x1), torch.from_numpy(x2),
                    K1, H, O)
    want = JFM.fused_mlp2(jnp.asarray(x1), jnp.asarray(x2),
                          *(jnp.asarray(t.numpy()) for t in w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _render_walk(stages, vecs, mats, vals, aux_s, aux_c, lc, F, H1, O, K, B,
                 R, P, repeat):
    """K4's arithmetic in f32 on ``GE.layout_render``'s stream: the V=2
    exchange walk (each row's view by its index), then the query MLP on
    its stages (the 16-deep first layer as one k-step), the round-1 logits
    and joint softmax per ray, z1; with ``repeat`` ze and u from ``mats``,
    the repeat MLP on its stages, round 2 and z2 + 2 z1."""
    M = B * 2 * R * P
    KT = _cdiv(K, 64)
    Kp = KT * 64
    stage = _reader(stages)
    jl, kv, q0 = _walk(stages, vecs, vals, [aux_s, aux_c], F, H1, O, K,
                       R * P, whole=False)
    qe1b, qe2b, elb, qr1b, qr2b = torch.split(vecs[-5 * Kp:], Kp)

    def query(l1, init):
        h = torch.zeros(M, Kp)
        for nt in range(KT):
            h[:, nt * 64:(nt + 1) * 64] = (
                init[:, nt * 64:(nt + 1) * 64]
                + lc @ stage(l1 + nt * 4096, 64)[:, :16].t())
        h = torch.relu(h)
        out = torch.zeros(M, Kp)
        l2 = l1 + KT * 4096
        for nt in range(KT):
            for kb in range(KT):
                out[:, nt * 64:(nt + 1) * 64] += (
                    h[:, kb * 64:(kb + 1) * 64]
                    @ stage(l2 + (nt * KT + kb) * 4096, 64).t())
        return out[:, :K], l2 + KT * KT * 4096

    def attend(q, k):
        logit = (q * k).sum(-1).reshape(B, 2, R, P) / 16.0
        w = torch.softmax(logit.permute(0, 2, 1, 3).reshape(B, R, 2 * P), -1)
        w = w.reshape(B, R, 2, P).permute(0, 2, 1, 3)
        return torch.einsum('bvrp,bvrpc->brc', w, jl.reshape(B, 2, R, P, O)), w

    ce, r0 = query(q0, qe1b.expand(M, Kp))
    ce = ce + qe2b[:K]
    z1, wt = attend(ce, kv)
    if not repeat:
        assert r0 == stages.numel()
        return z1, wt
    el, qr1z = mats[:O * K].float().reshape(O, K), mats[O * K:].float()
    ze = z1 @ el + elb[:K]
    u = ze @ qr1z.reshape(K, K) + qr1b[:K]                  # (B, R, K)
    u = torch.nn.functional.pad(u, (0, Kp - K))
    u = u[:, None, :, None].expand(B, 2, R, P, Kp).reshape(M, Kp)
    q2, end = query(r0, u)
    assert end == stages.numel()
    z2, _ = attend(q2 + qr2b[:K], ce)
    return z2 + 2.0 * z1, wt


def _render_case(B, R, P, channels=(32, 32, 16), O=48, K=16, seed=3):
    """Rows of both streams, aux, local coordinates and K4's 20 weights
    (bf16 values kept in f32), as numpy."""
    rng = np.random.default_rng(seed)
    F, M = sum(channels), B * 2 * R * P
    vals = [(0.3 * rng.standard_normal((2 * M, 4 * c))).astype(np.float32)
            for c in channels]
    aux = rng.random((2, M, 16)).astype(np.float32) * 0.5
    aux[:, ::5, :12] = 0.0
    lc = rng.uniform(-1, 1, (M, 16)).astype(np.float32)
    shapes = ((F + 3, F), (F,), (F, O), (O,), (2 * O, O), (O,), (2 * O, K),
              (K,), (K, K), (K,), (16, K), (K,), (K, K), (K,), (O, K), (K,),
              (K + 16, K), (K,), (K, K), (K,))
    params = [torch.from_numpy(
        (rng.standard_normal(s) / np.sqrt(s[0] if len(s) > 1 else 10))
        .astype(np.float32)).to(torch.bfloat16).float() for s in shapes]
    return vals, aux[0], aux[1], lc, params


@pytest.mark.parametrize('repeat', [False, True])
@pytest.mark.parametrize('against', ['reference', 'interpret'])
def test_render_layout_matches_jax(monkeypatch, repeat, against):
    """K4's layout (``layout_render``, all 20 weights) walked in the
    kernel's order against JAX ``fused_render._reference`` and the Pallas
    kernel in interpret mode, in f32 (rtol 1e-4: f32 sums in another
    order)."""
    B, R, P, channels = 2, 4, 4, (32, 32, 16)
    F, O, K = sum(channels), 48, 16
    vals, a_s, a_c, lc, params = _render_case(B, R, P, channels, O, K)
    stages, vecs, mats = GE.layout_render(params, repeat)
    t = torch.from_numpy
    z, wt = _render_walk(stages, vecs, mats, [t(v) for v in vals], t(a_s),
                         t(a_c), t(lc), F, F, O, K, B, R, P, repeat)
    args = (tuple(map(jnp.asarray, vals)), jnp.asarray(a_s),
            jnp.asarray(a_c), jnp.asarray(lc),
            tuple(jnp.asarray(p.numpy()) for p in params))
    if against == 'reference':
        z_j, wt_j = JFR._reference(*args, channels, B, R, P, repeat)
    else:
        monkeypatch.setattr(JFR, 'RAY_BLOCK', 4)
        z_j, wt_j = JFR._pallas_forward(*args, channels, B, R, P, repeat,
                                        interpret=True)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wt_j), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('O', [416, 544])
def test_render_layout_matches_jax_at_wide_latents(O):
    """K4's layout at O = 416 and 544 (fusion_features 384 and 512: five
    and six O tiles, split between the warpgroups) against JAX
    ``fused_render._reference``, as above."""
    B, R, P, channels = 1, 2, 4, (32, 16)
    F, K = sum(channels), 16
    vals, a_s, a_c, lc, params = _render_case(B, R, P, channels, O, K)
    stages, vecs, mats = GE.layout_render(params, True)
    t = torch.from_numpy
    z, wt = _render_walk(stages, vecs, mats, [t(v) for v in vals], t(a_s),
                         t(a_c), t(lc), F, F, O, K, B, R, P, True)
    z_j, wt_j = JFR._reference(
        tuple(map(jnp.asarray, vals)), jnp.asarray(a_s), jnp.asarray(a_c),
        jnp.asarray(lc), tuple(jnp.asarray(p.numpy()) for p in params),
        channels, B, R, P, True)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wt_j), rtol=1e-4,
                               atol=1e-4)


def test_render_layout_without_repeat_is_the_repeat_layouts_head():
    """Without repeat K4 streams the same stages up to the repeat MLP's,
    and the round-2 vectors are zeros."""
    params = _render_case(1, 2, 4)[-1]
    s1, v1, _ = GE.layout_render(params, True)
    s0, v0, m0 = GE.layout_render(params[:14], False)
    assert torch.equal(s1[:s0.numel()], s0) and s1.numel() > s0.numel()
    assert torch.equal(v1[:-3 * 64], v0[:-3 * 64]) and not v0[-3 * 64:].any()
    assert m0.numel() == 8


def test_mlp_and_render_prepared_once_and_again_after_an_inplace_edit():
    """K9's layout is keyed by the parameters a view was taken of (the
    renderer hands W1's two row blocks as slices), K4's by its 14 or 20
    parameters; both are rebuilt after an in-place edit."""
    w1 = torch.randn(83, 64)
    w = (w1[:80], w1[80:], torch.randn(64), torch.randn(64, 40),
         torch.randn(40))
    first = GE.prepared_mlp(w, 'cpu')
    assert GE.prepared_mlp((w1[:80], w1[80:]) + w[2:], 'cpu') is first
    assert GE.prepared_mlp((w1[:79], w1[79:82]) + w[2:], 'cpu') is not first
    with torch.no_grad():
        w1[81].add_(1.0)     # a row of W1b, in place on the parameter
    again = GE.prepared_mlp(w, 'cpu')
    assert again is not first
    assert torch.equal(again[1][64:128], w1[81].to(torch.bfloat16).float())
    params = _render_case(1, 2, 4)[-1]
    r = GE.prepared_render(params, True, 'cpu')
    assert GE.prepared_render(params, True, 'cpu') is r
    assert GE.prepared_render(params, False, 'cpu') is not r
    with torch.no_grad():
        params[17].mul_(2.0)     # qr1b
    assert GE.prepared_render(params, True, 'cpu') is not r


def test_renderer_hands_k4_and_k9_the_parameters_themselves(monkeypatch):
    """The fused render gets the model's parameter tensors, 14 of them
    without repeat attention; K9 gets parameters or views of them, so both
    layouts are built once per set of weights."""
    import cross_attention_renderer_torch.models.renderer as RM
    from cross_attention_renderer_torch.data.synthetic import make_scene
    seen = {}

    def spy(name, fn):
        def wrapper(*args):
            seen.setdefault(name, args)
            return fn(*args)
        monkeypatch.setattr(RM, name, wrapper)

    spy('fused_render_core', RM.fused_render_core)
    spy('fused_mlp2', RM.fused_mlp2)
    small = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
                 vit_heads=2, resnet_layers=(1, 1, 1), device='cpu')
    for repeat in (True, False):
        seen.clear()
        model = CrossAttentionRenderer(fused_render=True,
                                       repeat_attention=repeat, **small)
        ids = {id(t) for t in model.parameters()}
        with torch.no_grad():
            model(make_scene(0, H=32, W=32, n_rays=8, device='cpu'))
        params = seen['fused_render_core'][5]
        assert len(params) == (20 if repeat else 14)
        assert all(id(t) in ids for t in params)
    model = CrossAttentionRenderer(n_view=3, reference_exchange_compat=True,
                                   fused_mlp=True, **small)
    ids = {id(t) for t in model.parameters()}
    with torch.no_grad():
        model(make_scene(0, n_view=3, H=32, W=32, n_rays=8, device='cpu'))
    for t in seen['fused_mlp2'][2:]:
        assert id(t._base if t._base is not None else t) in ids


@pytest.mark.parametrize('mode,F,H1,O,K,says', [
    ('render', 80, 80, 1024, 272, 'K = 272 > 256: K is the attention'),
    ('pair', 576, 576, 288, 320, 'K = 320 > 256: K is the attention'),
    ('mlp', 4096, 30_000, 64, 0, 'even with its tiles in device memory'),
    ('render', 80, 80, 48, 272, 'HIDDEN_DIM, 128 in both packages')])
def test_core_refuses_what_does_not_fit_and_says_why(mode, F, H1, O, K,
                                                     says):
    """Only K above 256 (the attention width, not configurable) and vectors
    too long for shared memory in either plan are refused."""
    with pytest.raises(ValueError, match=says):
        GE.check_core_widths('k', mode, 1 if mode == 'mlp' else 2, F, H1, O,
                             K, 64)


def test_core_takes_fusion_features_288():
    """O = 320 (fusion_features 288) fits every instantiation at the
    flagship's other widths (F = 640 at that fusion width)."""
    for mode, S in (('pair', 2), ('streams', 3), ('mlp', 1), ('render', 2)):
        GE.check_core_widths('k', mode, S, 640, 640, 320, 128, 64)


@pytest.mark.parametrize('mode,S', [('pair', 2), ('streams', 2),
                                    ('streams', 3), ('mlp', 1),
                                    ('render', 2)])
def test_core_takes_every_fusion_width(mode, S):
    """Every fusion_features from 32 to 768 in steps of 32 (F = H1 = 2 ff +
    64, O = ff + 32, K = 128; K4 at 64 samples) is taken, with at least
    three stage slots a ring (K9: one): the flagship's and the narrower
    widths by the 'smem' plan, the widths whose f rows do not fit beside
    comb by the 'resident' one (not K9, which has no f rows), those where
    even comb does not fit by the 'global' one."""
    plans = {}
    for ff in range(32, 769, 32):
        F, O = 2 * ff + 64, ff + 32
        GE.check_core_widths('k', mode, S, F, F, O, 128, 64)
        got = GE.core_plan(mode, S, F, F, O, 128, 64)
        assert got.smem <= GE.SMEM_LIMIT
        assert got.slots >= (1 if mode == 'mlp' else 3)
        assert (got.scratch > 0) == (got.plan != 'smem' or mode == 'render')
        plans[ff] = got.plan
    assert plans[256] == 'smem' and plans[768] == 'global'
    # the plans come in the order 'smem', 'resident', 'global' as the
    # width grows
    rank = {'smem': 0, 'resident': 1, 'global': 2}
    order = [plans[ff] for ff in sorted(plans)]
    assert order == sorted(order, key=rank.get)
    assert ('resident' in order) == (mode != 'mlp')
