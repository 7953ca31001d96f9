"""The port's other encoders, ablation flags and view counts against JAX.

The same numpy-seeded weights (``random_flax_params``, then
``params_from_jax``) and scenes go through the JAX package and the port, in
f32 on the CPU, at 32x32 with 8 samples (48 at V=4) on 16 rays and a
1-block, 64-wide ViT:

* ``volumetric_epipolar_lines`` (the ``no_sample`` geometry), atol 1e-5;
* the ResNet34 and U-Net encoders, each level within 1e-4 of its largest
  value;
* the renderer's rgb, at_wt, depth_ray and valid_mask for ResNet V=2 and
  V=3, U-Net V=1, DPT V=1 and V=4, and each ablation flag at V=2, within
  1e-4 + 1e-4 max(1, max |JAX|) (test_torch_renderer.py's tolerance), on
  the port's default route (the plain versions of K2 and K3), its unfused
  route (``fused_epilogue=False``), where there is a V=2 exchange its
  fused render (K4's plain version), and at four levels and at V=4 the
  sorted stream and the one-hot and banded gathers (K5, K7, K8's plain
  versions). The JAX side runs its unfused
  exchange (``fused_epilogue=False``): with four pyramid levels its fused
  epilogues read tanh(pt/5) from level 3's slot weights, a divergence that
  ``test_jax_fused_exchange_differs_at_four_levels`` measures;
* the whole-image renderers against one forward at the new settings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.encoders.spatial import (
    SpatialEncoder as JaxSpatial)
from cross_attention_renderer_tpu.encoders.unet import UNetEncoder as JaxUNet
from cross_attention_renderer_tpu.geometry import epipolar as JG
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.encoders.spatial import SpatialEncoder
from cross_attention_renderer_torch.encoders.unet import UNetEncoder
from cross_attention_renderer_torch.geometry import epipolar as E
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.train import evaluation as EV
from torch_parity import assert_close, random_flax_params

SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=1,
             vit_heads=2, resnet_layers=(1, 1, 1))
OUTPUTS = ('rgb', 'at_wt', 'depth_ray', 'valid_mask')
CASES = {
    'resnet-v2': dict(model='resnet', n_view=2),
    'unet-v1': dict(model='unet', n_view=1),
    'dpt-v1': dict(n_view=1),
    'dpt-v4': dict(n_view=4, npoints=48),
    'resnet-v3': dict(model='resnet', n_view=3),
    'no_sample': dict(n_view=2, no_sample=True),
    'no_latent_concat': dict(n_view=2, no_latent_concat=True),
    'no_multiview': dict(n_view=2, no_multiview=True),
    'no_high_freq': dict(n_view=2, no_high_freq=True),
}
# The port's routes: the default (fused epilogues' plain versions), the
# unfused exchange, K4's plain version where a V=2 exchange exists, and
# the sorted stream (K5) and the one-hot and banded gathers (K7, K8) of
# the unfused V>=3 exchange, at four levels and at V=4.
ROUTES = {'default': {}, 'unfused': dict(fused_epilogue=False),
          'fused_render': dict(fused_render=True),
          'sorted': dict(sorted_stream=True),
          'onehot': dict(fused_epilogue=False, gather='onehot'),
          'banded': dict(fused_epilogue=False, gather='banded')}
RENDER_CASES = ('resnet-v2', 'no_sample', 'no_multiview', 'no_high_freq')
PAIRS = ([(c, r) for c in CASES for r in ('default', 'unfused')]
         + [(c, 'fused_render') for c in RENDER_CASES]
         + [(c, 'sorted') for c in ('resnet-v2', 'resnet-v3', 'dpt-v4')]
         + [('resnet-v3', 'onehot'), ('dpt-v4', 'banded')])


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(case):
    kw = dict(SMALL)
    kw.update(CASES[case])
    return kw


def _scene_kw(case):
    return dict(H=32, W=32, n_rays=16, n_view=_kw(case)['n_view'])


@pytest.fixture(scope='module')
def jax_runs():
    """{case: (params, JAX outputs)}, each case's JAX model compiled once
    on first use."""
    cache = {}

    def run(case):
        if case not in cache:
            kw = _kw(case)
            model = JaxRenderer(fused_attention=False, fused_epilogue=False,
                                **kw)
            scene = jax_scene(3, **_scene_kw(case))
            params = random_flax_params(model, 0, scene)
            cache[case] = (params, jax.jit(model.apply)(params, scene))
        return cache[case]

    return run


def _port(case, params, **route):
    model = CrossAttentionRenderer(device='cpu', **_kw(case), **route)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def test_volumetric_epipolar_lines_match_jax():
    rng = np.random.default_rng(0)
    B, V, R, P, H, W = 2, 3, 5, 64, 48, 40
    # rays ahead of the context camera (|ndc| up to ~50: f32 rounds them
    # to ~5e-6)
    d = rng.standard_normal((B, V, R, 3)) * [0.5, 0.5, 0.0] + [0, 0, 1]
    plucker = np.concatenate([d / np.linalg.norm(d, axis=-1, keepdims=True),
                              rng.standard_normal((B, V, R, 3))], -1)
    c2w = np.tile(np.eye(4), (B, V, 1, 1))
    c2w[..., :2, 3] = rng.standard_normal((B, V, 2))
    intr = np.tile(np.diag([40.0, 40.0, 1.0, 1.0]), (B, V, 1, 1))
    intr[..., 0, 2], intr[..., 1, 2] = W / 2, H / 2
    args = [a.astype(np.float32) for a in (plucker, c2w, intr)]
    want = JG.volumetric_epipolar_lines(*map(jnp.asarray, args), H, W, P)
    got = E.volumetric_epipolar_lines(*map(torch.from_numpy, args), H, W, P)
    for name, g, w in zip(('start', 'end', 'valid', 'pixel'), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0, err_msg=name)
    assert 0 < float(got[2].mean()) < 1


@pytest.mark.parametrize('jax_cls,port_cls', [(JaxSpatial, SpatialEncoder),
                                              (JaxUNet, UNetEncoder)])
def test_encoder_matches_jax(jax_cls, port_cls):
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    params = random_flax_params(jax_cls(), 0, jnp.asarray(x))
    want = jax_cls().apply(params, jnp.asarray(x))
    enc = port_cls()
    enc.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(f'level {i}', g.numpy(), w, atol=0, rtol=1e-4)


@pytest.mark.parametrize('case,route', PAIRS,
                         ids=[f'{c}-{r}' for c, r in PAIRS])
def test_render_matches_jax(jax_runs, case, route):
    params, want = jax_runs(case)
    model = _port(case, params, **ROUTES[route])
    with torch.no_grad():
        got = model(make_scene(3, device='cpu', **_scene_kw(case)))
    for k in OUTPUTS:
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=1e-4)
    assert float(got['valid_mask'].mean()) > 0


def test_jax_fused_exchange_differs_at_four_levels(jax_runs):
    """The kept divergence of the JAX package (ROADMAP.md Queue C): its
    fused V=2 epilogue reads tanh(pt/5) at aux columns 12-14, which with
    the ResNet34's four levels hold level 3's slot weights, so it departs
    from its own unfused exchange (the reference's math), which the port
    follows."""
    params, want = jax_runs('resnet-v2')
    fused = JaxRenderer(fused_attention=False, fused_epilogue=True,
                        **_kw('resnet-v2'))
    got = jax.jit(fused.apply)(params, jax_scene(3,
                                                 **_scene_kw('resnet-v2')))
    rgb_fused, rgb = np.asarray(got['rgb']), np.asarray(want['rgb'])
    rel = np.abs(rgb_fused - rgb).max() / max(1.0, np.abs(rgb).max())
    # 6.8e-3 of max(1, max |rgb|) here: 68 times the tolerance the port
    # is held to
    assert rel > 1e-3, rel


def test_params_from_jax_maps_update_val_merge(jax_runs):
    """The V=1 merge layer is a plain Dense: its (in, out) kernel becomes
    the port's (out, in) weight."""
    params, _ = jax_runs('dpt-v1')
    kernel = np.asarray(params['params']['update_val_merge']['kernel'])
    sd = params_from_jax(params)
    np.testing.assert_array_equal(sd['update_val_merge.weight'].numpy(),
                                  kernel.T)
    model = CrossAttentionRenderer(device='cpu', **_kw('dpt-v1'))
    assert model.latent_dim == kernel.shape[1] == 2 * 32 + 64
    assert not hasattr(model, 'query_encode_latent')


@pytest.mark.parametrize('kw', [dict(n_view=1), dict(n_view=4),
                                dict(model='resnet'),
                                dict(model='unet', n_view=3),
                                dict(no_sample=True, fused_render=True),
                                dict(no_latent_concat=True)],
                         ids=['v1', 'v4', 'resnet', 'unet-v3', 'no_sample',
                              'no_latent_concat'])
def test_scan_renderer_matches_one_call(kw):
    kw = dict(SMALL, **kw)
    model = CrossAttentionRenderer(seed=0, device='cpu', **kw).eval()
    V = kw.get('n_view', 2)
    scene = make_scene(1, H=32, W=32, n_rays=48, n_view=V, device='cpu')
    with torch.no_grad():
        z = model.encode(scene)
        whole = model(scene, z=z)
    assert len(z) == (3 if kw.get('model', 'midas_vit') == 'midas_vit'
                      else 4)
    rgb, valid = EV.make_scan_renderer(model, 4)(scene, z,
                                                 scene['query']['uv'])
    np.testing.assert_allclose(rgb.numpy(), whole['rgb'].numpy(), atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(),
                                  whole['valid_mask'].numpy())
    out = EV.make_summary_renderer(model, 2)(scene, z, scene['query']['uv'])
    assert out['at_wt'].shape == (1, V, 48, model.n_samples)


def test_fields_and_refusals():
    """The latent width, the packed tables and the paths each setting
    takes (V = 5 builds, with 48 samples), and what is refused: V below
    1, t_vals or pruned under
    no_sample, the fused render without the V=2 exchange, narrow and q8
    without the exchange, narrow widths that are not one a level."""
    kw = {k: v for k, v in SMALL.items() if k != 'npoints'}
    m4 = CrossAttentionRenderer(n_view=4, device='cpu', **kw)
    assert m4.n_samples == 48 and m4.latent_dim == 64
    assert m4.uses_packed_tables
    assert CrossAttentionRenderer(model='unet', device='cpu',
                                  **kw).latent_dim == 480
    v1 = CrossAttentionRenderer(n_view=1, model='resnet', device='cpu', **kw)
    assert v1.latent_dim == 512 and not v1.uses_packed_tables
    nlc = CrossAttentionRenderer(no_latent_concat=True, device='cpu', **kw)
    assert nlc.latent_dim == 128 and not nlc.uses_packed_tables
    assert CrossAttentionRenderer(n_view=5, device='cpu',
                                  **kw).n_samples == 48
    for bad in (dict(n_view=0), dict(model='vgg'),
                dict(n_view=1, fused_render=True),
                dict(no_latent_concat=True, fused_render=True),
                dict(model='resnet', narrow_features=(8, 8, 8))):
        with pytest.raises(ValueError):
            CrossAttentionRenderer(device='cpu', **kw, **bad)
    ns = CrossAttentionRenderer(no_sample=True, device='cpu', **SMALL)
    scene = make_scene(0, H=32, W=32, n_rays=8, device='cpu')
    with pytest.raises(ValueError, match='no_sample'):
        ns(scene, t_vals=torch.rand(1, 2, 8, 8))
    with pytest.raises(ValueError, match='no_sample'), torch.no_grad():
        EV.make_fast_renderer(ns, 2, pruned=(4, 4))(
            scene, ns.encode(scene), scene['query']['uv'])
    for model in (v1, nlc):
        with pytest.raises(ValueError, match='multiview'):
            EV.make_fast_renderer(model, 2, q8=True)
    resnet = CrossAttentionRenderer(model='resnet', device='cpu', **SMALL)
    with torch.no_grad():
        z = resnet.encode(make_scene(0, H=32, W=32, n_rays=8, device='cpu'))
    with pytest.raises(ValueError, match='one width a pyramid level'):
        EV.narrow_pyramid(resnet, z, (16, 16, 16))
