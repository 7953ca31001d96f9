"""The port's V=3 render, both wirings, against JAX and the reference fixture.

* Path A, the default V=3 render (the multi-stream fused epilogue, K3):
  against JAX ``CrossAttentionRenderer(n_view=3, fused_epilogue=True,
  fused_attention=False).apply``, whose epilogue reaches its jnp
  ``_reference_multi`` on the CPU.
* Path B, the reference-compatible V=3 render (``reference_exchange_compat``,
  the unfused exchange, with and without the fused MLP K9): against the JAX
  model with the same flag, and against tests/fixtures/renderer_golden_v3.npz
  (the reference torch model's outputs and per-stage activations) at
  test_renderer_parity's tolerances.

The JAX side is a small model (encoder included) with random weights passed
through ``params_from_jax``; tolerance 1e-4 relative to max(1, |ref|), f32 on
both sides.
"""

import jax
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.train.evaluation import (
    make_scan_renderer)
from torch_parity import (assert_close, golden_fixture_model,
                          random_flax_params)

SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))
OUTPUTS = ('rgb', 'depth_ray', 'valid_mask', 'at_wt', 'pixel_val')
SCENE = dict(H=64, W=64, n_rays=32, n_view=3)


@pytest.fixture(scope='module')
def jax_params():
    """Random weights of the small V=3 model (one tree serves both
    wirings: they have the same parameters)."""
    return random_flax_params(JaxRenderer(n_view=3, **SMALL), 0,
                              jax_scene(3, **SCENE))


def _port(params, **kw):
    model = CrossAttentionRenderer(n_view=3, device='cpu', **SMALL, **kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _render_both(params, jax_kw, port_kw):
    jax_model = JaxRenderer(n_view=3, fused_attention=False, **SMALL,
                            **jax_kw)
    want = jax.jit(jax_model.apply)(params, jax_scene(3, **SCENE))
    with torch.no_grad():
        got = _port(params, **port_kw)(make_scene(3, device='cpu', **SCENE))
    return got, want


def test_default_render_matches_jax(jax_params):
    """Path A: K3's plain version inside the whole V=3 render."""
    got, want = _render_both(jax_params, dict(fused_epilogue=True), {})
    for k in OUTPUTS:
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=1e-4)
    assert float(got['valid_mask'].mean()) > 0


@pytest.mark.parametrize('fused_mlp', [False, True])
def test_compat_render_matches_jax(jax_params, fused_mlp):
    """Path B: the unfused exchange with the reference's index swap, its
    fuse MLP plain or through K9's plain version."""
    got, want = _render_both(jax_params,
                             dict(reference_exchange_compat=True),
                             dict(reference_exchange_compat=True,
                                  fused_mlp=fused_mlp))
    for k in OUTPUTS:
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=1e-4)


def test_fused_matches_unfused_exchange(jax_params):
    """Inside the port, compat off: K3's plain version against the unfused
    exchange (JAX's test_fused_exchange_multi_matches_standard_v3)."""
    scene = make_scene(5, device='cpu', **SCENE)
    with torch.no_grad():
        fused = _port(jax_params)(scene)
        unfused = _port(jax_params, fused_epilogue=False)(scene)
    for k in OUTPUTS:
        np.testing.assert_allclose(fused[k].numpy(), unfused[k].numpy(),
                                   atol=2e-4)


@pytest.mark.parametrize('fused_mlp', [False, True])
def test_render_matches_reference_fixture(fused_mlp):
    d, model, scene, z, (B, V, R, P) = golden_fixture_model(
        3, reference_exchange_compat=True, fused_mlp=fused_mlp)
    with torch.no_grad():
        out = model(scene, z=z)
    assert_close('pixel_val', out['pixel_val'],
                 d['out_pixel_val'].reshape(B, V, R, P, 2), atol=1e-4)
    assert_close('at_wt', out['at_wt'], d['out_at_wt'].reshape(B, V, R, P),
                 atol=1e-4)
    assert_close('depth_ray', out['depth_ray'], d['out_depth_ray'],
                 atol=1e-3)
    assert_close('valid_mask', out['valid_mask'], d['out_valid_mask'],
                 atol=1e-6)
    assert_close('rgb', out['rgb'], d['out_rgb'].reshape(B, 1, R, 3),
                 atol=1e-3)


def test_render_stages_match_reference_fixture():
    """The fixture's per-stage activations: the nine exchange encodes, the
    joint latent and key, the query and round-2 embeddings, phi's input."""
    d, model, scene, z, (B, V, R, P) = golden_fixture_model(
        3, reference_exchange_compat=True)
    got = {}

    def keep(name):
        def hook(module, args, out):
            got.setdefault(name, []).append(out)
        return hook

    for name in ('query_encode_latent_2', 'latent_value', 'key_map_2',
                 'query_embed_2', 'encode_latent', 'query_repeat_embed_2'):
        getattr(model, name).register_forward_hook(keep(name))
    model.phi.register_forward_pre_hook(
        lambda module, args: got.setdefault('phi_in', args[0]))
    with torch.no_grad():
        model(scene, z=z)

    def fixture(name, shape, i=0):
        """torch (N, C, R[, P]) channel-first -> channel-last ``shape``."""
        return np.moveaxis(d[f'stage_{name}_{i}'], 1, -1).reshape(shape)

    # The reference encodes [self_v, cross pair of v] per view
    # (models.py:437-473); the port all selfs first, then per view its two
    # cross parts in ascending frame order (as JAX's _latent_exchange).
    enc = got['query_encode_latent_2']
    assert len(enc) == 9
    for v in range(V):
        assert_close(f'exchange_self[{v}]', enc[v],
                     fixture('exchange_encode', (B, R, P, -1), 2 * v))
        pair = fixture('exchange_encode', (B, 2, R, P, -1), 2 * v + 1)
        for j in range(2):
            assert_close(f'exchange_cross[{v},{j}]', enc[3 + 2 * v + j],
                         pair[:, j])
    per_sample = (B, V, R, P, -1)
    for name, key in (('joint_latent', 'latent_value'),
                      ('key_val', 'key_map_2'),
                      ('coords_embed', 'query_embed_2'),
                      ('repeat_embed', 'query_repeat_embed_2')):
        assert_close(name, got[key][0], fixture(name, per_sample))
    assert_close('z_embed', got['encode_latent'][0],
                 fixture('z_embed', (B, V, R, -1)))
    assert_close('phi_in', got['phi_in'], d['stage_phi_in_0'])


@pytest.mark.parametrize('kw', [{}, dict(reference_exchange_compat=True,
                                         fused_mlp=True)])
def test_scan_renderer_matches_one_call(kw):
    model = CrossAttentionRenderer(n_view=3, seed=0, device='cpu', **SMALL,
                                   **kw)
    scene = make_scene(1, H=32, W=32, n_rays=48, n_view=3, device='cpu')
    with torch.no_grad():
        z = model.encode(scene)
        whole = model(scene, z=z)
    rgb, valid = make_scan_renderer(model, 4)(scene, z, scene['query']['uv'])
    np.testing.assert_allclose(rgb.numpy(), whole['rgb'].numpy(), atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(),
                                  whole['valid_mask'].numpy())


def test_npoints_default_and_unported_wiring():
    """npoints=0 takes 64 samples at V=2 and 48 from V=3 (five views
    included, which K3 takes as five streams); the fused render core at
    V=3 is refused, and a scene must match the model's view count."""
    kw = {k: v for k, v in SMALL.items() if k != 'npoints'}
    assert CrossAttentionRenderer(device='cpu', **kw).n_samples == 64
    model = CrossAttentionRenderer(n_view=3, device='cpu', **kw)
    assert model.n_samples == 48
    with pytest.raises(ValueError):
        CrossAttentionRenderer(n_view=3, fused_render=True, device='cpu',
                               **kw)
    assert CrossAttentionRenderer(n_view=4, device='cpu',
                                  **kw).n_samples == 48
    assert CrossAttentionRenderer(n_view=5, device='cpu',
                                  **kw).n_samples == 48
    with pytest.raises(ValueError):
        model(make_scene(1, H=32, W=32, n_rays=8, device='cpu'))
