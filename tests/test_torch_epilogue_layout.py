"""The weights of the exchange epilogues K2 and K3 as their Hopper kernel
reads them (``ops/gather_epilogue.py:layout_stages``), on the CPU.

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


def _walk(stages, vecs, vals, aux_list, F, H1, O, K, rp):
    """The kernel's arithmetic in f32, reading the weights stage by stage in
    the order its producer streams them: per stream, chunk by chunk, the
    W1 k-blocks then the W2 column tiles (the kernel hands the chunks to
    two warpgroups and adds their partial f; the sum is the same); then lv,
    km and k2. rp: the V=2 view swap's samples per view, or None."""
    S, M = len(aux_list), aux_list[0].shape[0]
    nch, nkbF, OT = _cdiv(H1, 64), _cdiv(F, 64), _cdiv(O, 96)
    KT, nkbf, nkbK = _cdiv(K, 64), _cdiv(S * O, 64), _cdiv(K, 64)
    st = stages.float()
    pos = 0

    def stage(rows):
        nonlocal pos
        t = st[pos:pos + rows * 64].reshape(1, 1, rows, 64)
        pos += rows * 64
        return _untiles(t, rows, 64)     # (output units, 64 k-values)

    ldv = nch * 64
    wt, b1, b2, lvb, kmb, k2b = torch.split(
        vecs, [3 * ldv, ldv, OT * 96, OT * 96, KT * 64, KT * 64])
    wt = wt.reshape(3, ldv)
    fs = torch.zeros(M, nkbf * 64)
    rows = torch.arange(M)
    for s in range(S):
        comb = torch.zeros(M, nkbF * 64)
        comb[:, :F] = GE._combine([v[s * M:(s + 1) * M] for v in vals],
                                  aux_list[s])
        th = aux_list[s][:, 12:15]
        acc = torch.zeros(M, OT * 96)
        pos = 0
        for c in range(nch):
            a1 = b1[c * 64:(c + 1) * 64] + th @ wt[:, c * 64:(c + 1) * 64]
            for kb in range(nkbF):
                a1 = a1 + comb[:, kb * 64:(kb + 1) * 64] @ stage(64).t()
            h = torch.relu(a1)
            for nt in range(OT):
                acc[:, nt * 96:(nt + 1) * 96] += h @ stage(96).t()
        f = acc[:, :O] + b2[:O]
        slot = torch.full((M,), s)
        if rp is not None:
            slot = torch.where((rows // rp) % 2 == s, 0, 1)
        for k in range(2 if rp is not None else 1):
            sel = slot == k if rp is not None else slice(None)
            col = (k if rp is not None else s) * O
            fs[sel, col:col + O] = f[sel]
    jl = torch.zeros(M, OT * 96)
    for kb in range(nkbf):
        for nt in range(OT):
            jl[:, nt * 96:(nt + 1) * 96] += (fs[:, kb * 64:(kb + 1) * 64]
                                             @ stage(96).t())
    kh = torch.zeros(M, KT * 64)
    for kb in range(nkbf):
        for nt in range(KT):
            kh[:, nt * 64:(nt + 1) * 64] += (fs[:, kb * 64:(kb + 1) * 64]
                                             @ stage(64).t())
    kh = torch.relu(kh + kmb)
    kv = torch.zeros(M, KT * 64)
    for nt in range(KT):
        for kb in range(nkbK):
            kv[:, nt * 64:(nt + 1) * 64] += (kh[:, kb * 64:(kb + 1) * 64]
                                             @ stage(64).t())
    assert pos == st.numel()
    return jl[:, :O] + lvb[:O], kv[:, :K] + k2b[:K]


@pytest.mark.parametrize('channels,H1,O,K,S,M,rp', [
    ((32, 32, 16), 80, 40, 16, 2, 100, 20),
    ((32, 16), 48, 32, 32, 3, 77, None),
    ((32, 32, 16), 80, 40, 16, 4, 65, None),
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
    jl, kv = _walk(stages, vecs, [torch.from_numpy(v) for v in vals],
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


def _core_case(O=40, K=16, S=2, M=50):
    channels = (32, 32, 16)
    F = sum(channels)
    tables = [torch.zeros((2, 4, 4, 4 * c), dtype=torch.bfloat16)
              for c in channels]
    cells = [torch.zeros(S * M, dtype=torch.int32) for _ in channels]
    aux = [torch.zeros((M, 16), dtype=torch.bfloat16) for _ in range(S)]
    return tables, cells, aux, _params(F, 80, O, K, S)


@pytest.mark.parametrize('bad', ['f32 tables', 'strided aux', 'cells shape',
                                 'wide O', 'wide K'])
def test_wrappers_refuse_what_the_kernel_does_not_take(bad):
    tables, cells, aux, params = _core_case()
    if bad == 'f32 tables':
        tables[0] = tables[0].float()
    elif bad == 'strided aux':
        aux[1] = torch.zeros((16, 50), dtype=torch.bfloat16).t()
    elif bad == 'cells shape':
        cells[2] = cells[2][:-1]
    elif bad == 'wide O':
        tables, cells, aux, params = _core_case(O=296)
    else:
        tables, cells, aux, params = _core_case(K=272)
    with pytest.raises(ValueError):
        GE._core_args('fused_exchange_epilogue', tables, cells, aux, params)


def test_wrappers_accept_the_case_the_refusals_start_from():
    tables, cells, aux, params = _core_case()
    levels, sizes, stages, vecs = GE._core_args(
        'fused_exchange_epilogue', tables, cells, aux, params)
    assert sizes == (50, 80, 80, 40, 16)
    assert stages.numel() * 2 == (2 * (2 * 8192 + 12288) + 2 * 12288
                                  + 2 * 8192 + 8192)
