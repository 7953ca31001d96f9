"""The port at more than four context views, against the JAX package, on the
CPU.

* V = 5 and V = 6 renders of a tiny model against JAX's on every route JAX
  takes at that view count: the default (the port's fused route through
  K3's plain version; JAX's CPU default reaches its plain exchange), the
  unfused exchange, the reference-compatible exchange with the fused MLP
  (K9's plain version) under the take, one-hot (K7) and banded (K8)
  gathers, the sorted stream (K5), the ResNet34 encoder (K3's 4-level
  mode, held against JAX's unfused exchange as ROADMAP.md Queue C 14
  says), and the fast-eval renderers pruned, narrow and q8. Both sides
  render from JAX's pyramid; tolerance 1e-4 + 1e-4 max(1, |JAX|), as
  tests/test_torch_renderer_v3.py (narrow: 2.5e-4 relative, the V=2
  tests' tolerance for its two eigh implementations).
* K3's plain version at S = 5 to 8 streams against JAX's
  ``_reference_multi``, and the exchange core's layout mirror
  (``core_plan``, ``core_scratch``, ``check_core_widths``) at S = 2 to 8
  against the layout counted out here from ``csrc/exchange_core.cuh``.
* One stage-1 loss and gradient at V = 5 against JAX's ``make_loss_fn``
  (each tensor within 1e-4 of its largest JAX gradient).
* ``cli/eval.py --views 5`` on a corpus written by the port's writer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.ops.gather_epilogue as JGE
from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.train import evaluation as JE
from cross_attention_renderer_tpu.train import trainer as JT
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.train import evaluation as E
from cross_attention_renderer_torch.train import trainer as T
from torch_parity import assert_close, random_flax_params

TINY = dict(npoints=4, fusion_features=16, vit_width=32, vit_depth=1,
            vit_heads=2, resnet_layers=(1, 1, 1))
SCENE = dict(H=32, W=32, n_rays=8)
OUTPUTS = ('rgb', 'depth_ray', 'valid_mask', 'at_wt', 'pixel_val')
# route: (the port's flags, JAX's flags, encoder)
ROUTES = {
    'default': ({}, {}, 'midas_vit'),
    'unfused': (dict(fused_epilogue=False), dict(fused_epilogue=False),
                'midas_vit'),
    'compat_k9': (dict(reference_exchange_compat=True, fused_mlp=True),
                  dict(reference_exchange_compat=True), 'midas_vit'),
    'compat_onehot': (dict(reference_exchange_compat=True, fused_mlp=True,
                           gather='onehot'),
                      dict(reference_exchange_compat=True), 'midas_vit'),
    'compat_banded': (dict(reference_exchange_compat=True, gather='banded'),
                      dict(reference_exchange_compat=True), 'midas_vit'),
    'sorted': (dict(sorted_stream=True), dict(sorted_stream=True),
               'midas_vit'),
    'resnet': ({}, dict(fused_epilogue=False), 'resnet'),
}
FAST = {'pruned': dict(pruned=(2, 4)), 'q8': dict(q8=True),
        'narrow': dict(narrow=(8, 8, 32))}
# narrow's PCA bases come from two eigh implementations: the V=2 tests'
# tolerance for it (tests/torch_fast_cases.py LEVER_RTOL)
FAST_RTOL = {'pruned': 1e-4, 'q8': 1e-4, 'narrow': 2.5e-4}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Views:
    """One view count's and encoder's JAX weights, scene and pyramid (JAX's
    encode), the port's scene and the same pyramid; JAX's renders cached
    by flags."""

    def __init__(self, V: int, encoder: str):
        self.V, self.encoder = V, encoder
        self.jscene = jax_scene(V, n_view=V, **SCENE)
        jmodel = JaxRenderer(n_view=V, model=encoder, fused_attention=False,
                             **TINY)
        self.params = random_flax_params(jmodel, 0, self.jscene)
        self.jz = jax.jit(lambda p, s: jmodel.apply(p, s, method='encode'))(
            self.params, self.jscene)
        self.scene = make_scene(V, n_view=V, device='cpu', **SCENE)
        self.z = tuple(torch.from_numpy(np.array(x)) for x in self.jz)
        self._jax = {}

    def jmodel(self, **kw):
        return JaxRenderer(n_view=self.V, model=self.encoder,
                           fused_attention=False, **TINY, **kw)

    def jax_render(self, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._jax:
            m = self.jmodel(**kw)
            self._jax[key] = jax.jit(lambda p, s, z: m.apply(p, s, z=z))(
                self.params, self.jscene, self.jz)
        return self._jax[key]

    def model(self, **kw) -> CrossAttentionRenderer:
        m = CrossAttentionRenderer(n_view=self.V, model=self.encoder,
                                   device='cpu', **TINY, **kw)
        m.load_state_dict(params_from_jax(self.params), strict=True)
        return m.eval()


@pytest.fixture(scope='module')
def views():
    cache = {}

    def get(V, encoder='midas_vit'):
        if (V, encoder) not in cache:
            cache[V, encoder] = Views(V, encoder)
        return cache[V, encoder]

    return get


@pytest.mark.parametrize('route', sorted(ROUTES))
@pytest.mark.parametrize('V', [5, 6])
def test_render_matches_jax(views, V, route):
    port_kw, jax_kw, encoder = ROUTES[route]
    case = views(V, encoder)
    model = case.model(**port_kw)
    assert model.n_samples == TINY['npoints']
    with torch.no_grad():
        got = model(case.scene, z=case.z)
    want = case.jax_render(**jax_kw)
    for k in OUTPUTS:
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=1e-4)
    assert float(got['valid_mask'].mean()) > 0


@pytest.mark.parametrize('lever', sorted(FAST))
@pytest.mark.parametrize('V', [5, 6])
def test_fast_renderer_matches_jax(views, V, lever):
    """make_fast_renderer's pruned, narrow and q8 renders (K3's plain
    int8 mode for q8) against JAX's on the same pyramid."""
    case = views(V)
    rgb, valid = E.make_fast_renderer(case.model(), 2, **FAST[lever])(
        case.scene, case.z, case.scene['query']['uv'])
    rgb_j, valid_j = JE.make_fast_renderer(case.jmodel(), 2, **FAST[lever])(
        case.params, case.jscene, case.jz, case.jscene['query']['uv'])
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
    assert_close('rgb', rgb.numpy(), rgb_j, atol=1e-4, rtol=FAST_RTOL[lever])


def test_n_samples_and_refusals():
    """48 samples above two views whatever the count; the fused render core
    still takes two views only, and a scene must match the model."""
    for V in (5, 6, 9):
        kw = {k: v for k, v in TINY.items() if k != 'npoints'}
        assert CrossAttentionRenderer(n_view=V, device='cpu',
                                      **kw).n_samples == 48
    with pytest.raises(ValueError, match='fused render'):
        CrossAttentionRenderer(n_view=5, fused_render=True, device='cpu',
                               **TINY)
    with pytest.raises(ValueError):
        CrossAttentionRenderer(n_view=0, device='cpu', **TINY)
    with pytest.raises(ValueError, match='built for 5'):
        CrossAttentionRenderer(n_view=5, device='cpu', **TINY)(
            make_scene(0, n_view=6, device='cpu', **SCENE))


def test_stream_takes_keep_jax_stream_order(views):
    """K3 is handed V aux arrays of (M, aux_w), one a stream, in JAX's
    order (renderer.py:698-703): stream 0 holds each view's own samples,
    stream j >= 1 for the samples of view v those in v's j-th other view,
    in ascending frame order (read back from the tanh(pt/5) columns)."""
    case = views(5)
    model = case.model()
    seen = {}
    exchange_points = model._exchange_points

    def points(*args):
        seen['pt_in'] = exchange_points(*args)
        return seen['pt_in']

    def spy(tables, cells, aux_list, params):
        seen['aux'] = aux_list
        return GE.fused_exchange_epilogue_multi_reference(tables, cells,
                                                          aux_list, params)

    import cross_attention_renderer_torch.models.renderer as R
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(R, 'fused_exchange_epilogue_multi', spy)
        mp.setattr(model, '_exchange_points', points)
        model(case.scene, z=case.z)
    aux, pt_in = seen['aux'], seen['pt_in']
    V = 5
    M = pt_in[:, 0].numel() // 3
    t_col, width = GE.aux_layout(len(case.z))
    assert len(aux) == V
    assert all(tuple(a.shape) == (M, width) for a in aux)
    others = [[k for k in range(V) if k != v] for v in range(V)]
    for j in range(V):
        pt = torch.stack([pt_in[:, v if j == 0 else others[v][j - 1], v]
                          for v in range(V)], dim=1)
        torch.testing.assert_close(
            aux[j][:, t_col:t_col + 3],
            torch.tanh(pt.reshape(M, 3) / 5.0).to(aux[j].dtype),
            rtol=0, atol=0)


# --- K3's plain version and the core's layout at any stream count --------

CHANNELS, H1, LD, HID = (16, 16, 32), 48, 40, 16


def _multi_case(S, M, seed=0):
    """Taken rows (S*M, 4C) a level, S aux arrays, the weights."""
    rng = np.random.default_rng(seed)
    F = sum(CHANNELS)
    t, width = GE.aux_layout(3)
    vals = [rng.standard_normal((S * M, 4 * c)).astype(np.float32)
            for c in CHANNELS]
    aux = rng.random((S, M, width)).astype(np.float32)
    aux[:, :, t:t + 3] = 2 * aux[:, :, t:t + 3] - 1
    aux[:, ::7, :t] = 0.0
    shapes = ((F + 3, H1), (H1,), (H1, LD), (LD,), (S * LD, LD), (LD,),
              (S * LD, HID), (HID,), (HID, HID), (HID,))
    params = [(rng.standard_normal(s) / np.sqrt(s[0] if len(s) == 2 else 10)
               ).astype(np.float32) for s in shapes]
    return vals, list(aux), params


@pytest.mark.parametrize('S', [5, 6, 7, 8])
def test_multi_reference_matches_jax_at_any_stream_count(S):
    """K3's plain version (the math the kernel is held to) at S = 5 to 8
    against JAX's ``_reference_multi``; JAX's reads tanh at aux column 12,
    so four levels are held against the port's 3-level layout only."""
    vals, aux, params = _multi_case(S, 97, seed=S)
    t = lambda arrs: [torch.from_numpy(a) for a in arrs]
    jl, kv = GE._reference_multi(t(vals), t(aux), t(params))
    jl_j, kv_j = JGE._reference_multi(
        tuple(map(jnp.asarray, vals)), tuple(map(jnp.asarray, aux)),
        tuple(map(jnp.asarray, params)))
    assert_close('jl', jl.numpy(), jl_j, atol=1e-4, rtol=1e-4)
    assert_close('kv', kv.numpy(), kv_j, atol=1e-4, rtol=1e-4)
    # the S aux arrays as views of one stream-major tensor read the same
    jl2, kv2 = GE._reference_multi(t(vals),
                                   list(torch.cat(t(aux)).chunk(S)),
                                   t(params))
    torch.testing.assert_close(jl2, jl, rtol=0, atol=0)
    torch.testing.assert_close(kv2, kv, rtol=0, atol=0)


def _counted_layout(S, F, H1, O, K, levels):
    """K3's layout counted from ``csrc/exchange_core.cuh`` (``fill_sizes``
    and ``launch_core``) on the H100's 232,448 bytes a block: (plan, shared
    bytes with two 12 KB stage slots, scratch bytes a block, stage slots a
    ring). A plan is taken where its tiles leave six slots (three a ring),
    the slots being as many more as fit, up to eight."""
    cdiv = lambda a, b: -(-a // b)
    slots = max(levels, 3)
    aux_w = cdiv(4 * slots + 3, 8) * 8
    nkbF, nkbf = cdiv(F, 64), cdiv(S * O, 64)
    OT, KT = cdiv(O, 96), cdiv(K, 64)
    n_vecs = 3 * cdiv(H1, 64) * 64 + cdiv(H1, 64) * 64 + 2 * OT * 96 \
        + 2 * KT * 64
    common = 1024 + 64 * aux_w * 2 + 64 * slots * 4 + 2 * n_vecs + 16 * 8
    ring = lambda nkb: min(8, (232_448 - common - nkb * 8192) // 12288
                           // 2 * 2) // 2
    # 'smem': the first S - 1 streams' f rows beside comb, the last
    # stream's in comb (where they fit there)
    fbuf = cdiv((S - 1) * O, 64) if OT <= 6 else nkbf
    if nkbf - fbuf > nkbF:
        fbuf = nkbf
    if ring(nkbF + fbuf) >= 3:
        return ('smem', common + (nkbF + fbuf) * 8192 + 2 * 12288, 0,
                ring(nkbF + fbuf))
    # 'resident': comb alone in shared memory, the f rows in the scratch
    if ring(nkbF) >= 3:
        return ('resident', common + nkbF * 8192 + 2 * 12288, nkbf * 8192,
                ring(nkbF))
    return ('global', common + 8192 + 2 * 12288, (nkbF + nkbf) * 8192,
            ring(1))


@pytest.mark.parametrize('S', range(2, 9))
@pytest.mark.parametrize('widths', [
    (576, 576, 288, 128, 3),     # the flagship ('resident' from S = 4)
    (512, 512, 256, 128, 4),     # ResNet34 ('resident' from S = 4)
    (960, 960, 480, 128, 4),     # U-Net ('resident' from S = 2)
    (64, 80, 48, 16, 3),         # narrow ('smem' at every S)
], ids=['flagship', 'resnet', 'unet', 'narrow'])
def test_core_layout_mirror_at_any_stream_count(monkeypatch, S, widths):
    F, H1_, O, K, levels = widths
    want = _counted_layout(S, F, H1_, O, K, levels)
    assert GE.core_plan('streams', S, F, H1_, O, K, levels=levels) == want
    assert want[3] >= 3
    GE.check_core_widths('k3', 'streams', S, F, H1_, O, K, levels=levels)

    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device: Props)
    M = 64 * 200 + 5
    scratch = GE.core_scratch('streams', S, F, H1_, O, K, -(-M // 64),
                              'cpu', levels=levels)
    if want[2] == 0:
        assert scratch is None
    else:
        assert scratch.numel() == 132 * want[2]


def test_core_widths_refused_with_their_shape():
    """A width the core cannot take (a capacity) raises with the shape at
    any S; nothing is routed to the plain version. An f row S * O wide
    that does not tile the 16-deep product steps (S * O = 5 * 40 = 200) is
    no longer refused: the core's f rows are 48 wide there, the weights
    zero past O."""
    with pytest.raises(ValueError, match='S = 7, F = 576, H1 = 40000'):
        GE.check_core_widths('k3', 'streams', 7, 576, 40000, 288, 128)
    with pytest.raises(ValueError, match='K = 320'):
        GE.check_core_widths('k3', 'streams', 6, 576, 576, 288, 320)
    GE.check_core_widths('k3', 'streams', 5, 64, 80, 40, 16)
    assert GE.core_out_width('streams', 5, 40) == 48
    assert (GE.core_plan('streams', 5, 64, 80, 40, 16)
            == GE.core_plan('streams', 5, 64, 80, 48, 16))
    GE.check_core_widths('k3', 'streams', 6, 64, 80, 40, 16)
    assert GE.core_out_width('streams', 6, 40) == 40


# --- training and the CLI at five views ------------------------------------

def test_stage1_gradients_match_jax_at_five_views():
    """The default training route's loss and every parameter's gradient at
    V = 5 against JAX's make_loss_fn (1e-5 relative loss, 1e-4 of each
    tensor's largest gradient, floor 1e-7 of the largest of all)."""
    scene = jax_scene(0, batch=1, n_view=5, n_rays=16, H=32, W=32)
    jmodel = JaxRenderer(n_view=5, **TINY)
    params = random_flax_params(jmodel, 0, scene)
    cfg = JT.TrainConfig()
    (want_tot, _), want_grads = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(jmodel, cfg), has_aux=True))(params, scene)
    model = CrossAttentionRenderer(n_view=5, device='cpu', **TINY)
    model.load_state_dict(params_from_jax(params), strict=True)
    tscene = make_scene(0, batch=1, n_view=5, n_rays=16, H=32, W=32,
                        device='cpu')
    tot, _ = T.make_loss_fn(model, T.TrainConfig())(tscene)
    tot.backward()
    np.testing.assert_allclose(float(tot.detach()), float(want_tot),
                               rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    floor = 1e-7 * max(float(w.abs().max()) for w in want.values())
    for name, p in model.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= max(1e-4 * float(w.abs().max()), floor), name


def test_eval_cli_at_five_views(tmp_path):
    """``cli/eval.py --views 5``: five context frames spaced evenly over
    the scene, finite metrics equal to evaluate_scene's on the same
    model."""
    from cross_attention_renderer_torch.cli import common as C
    from cross_attention_renderer_torch.cli import eval as eval_cli
    from cross_attention_renderer_torch.data import realestate as PR
    from cross_attention_renderer_torch.tools import make_corpus as PM
    hw = (64, 114)
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in ((PR, ('IMG_H', 'IMG_W', 'CROP')),
                           (PM, ('H', 'W'))):
            for n, v in zip(names, (hw[0], hw[1], hw[0])):
                mp.setattr(mod, n, v)
        PM.main(['--root', str(tmp_path), '--scenes', '1', '--defects', '0',
                 '--seed_base', '2'])
        img_root, pose_root = tmp_path / 'frames', tmp_path / 'poses.mat'
        flags = ['--fusion_features', '16', '--vit_width', '32',
                 '--vit_depth', '1', '--vit_heads', '2', '--resnet_layers',
                 '1', '1', '1', '--npoints', '4', '--device', 'cpu']
        argv = ['--img_root', str(img_root), '--pose_root', str(pose_root),
                '--logging_root', str(tmp_path / 'logs'), '--max_scenes',
                '1', '--views', '5', *flags]
        res = eval_cli.main(argv)
        opt = C.base_parser('x').parse_known_args(argv)[0]
        model = C.build_model(opt).eval()
        assert model.n_view == 5
        ds = PR.RealEstate10kVis(img_root, pose_root, num_ctxt_views=5)
        scene = C.scene_batch(ds[0], 'cpu')
        assert scene['context']['rgb'].shape[1] == 5
        want = E.evaluate_scene(model, scene, 64, 64, n_chunks=8)
    for k in ('mse', 'psnr', 'ssim'):
        assert np.isfinite(res['scenes'][0][k])
        np.testing.assert_allclose(res['scenes'][0][k], float(want[k]),
                                   rtol=1e-6, err_msg=k)
