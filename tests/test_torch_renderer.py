"""The port's V=2 render, as a whole, against JAX and the reference fixture.

* Against JAX ``CrossAttentionRenderer(n_view=2, fused_epilogue=True,
  fused_attention=False).apply`` at a small size (encoder included), whose
  epilogue reaches its jnp ``_reference`` on the CPU; the same random
  weights through ``params_from_jax``; tolerance 1e-4 relative to
  max(1, |ref|), f32 on both sides.
* Against tests/fixtures/renderer_golden_v2.npz (the reference torch
  model's outputs), its weights through ``convert_reference_state_dict``
  then ``params_from_jax``, at test_renderer_parity's tolerances.
"""

import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
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

ROOT = pathlib.Path(__file__).resolve().parents[1]

SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))
OUTPUTS = ('rgb', 'depth_ray', 'valid_mask', 'at_wt', 'pixel_val')


@pytest.mark.parametrize('n_view', [2, 3])
def test_scene_matches_jax(n_view):
    js = jax_scene(3, n_view=n_view, H=32, W=32, n_rays=16)
    ts = make_scene(3, n_view=n_view, H=32, W=32, n_rays=16, device='cpu')
    for part in ('context', 'query'):
        for k, v in js[part].items():
            np.testing.assert_array_equal(ts[part][k].numpy(), np.asarray(v))


def test_render_matches_jax():
    scene = jax_scene(3, H=64, W=64, n_rays=32)
    jax_model = JaxRenderer(n_view=2, fused_epilogue=True,
                            fused_attention=False, **SMALL)
    params = random_flax_params(jax_model, 0, scene)
    want = jax.jit(jax_model.apply)(params, scene)

    model = CrossAttentionRenderer(device='cpu', **SMALL)
    model.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(make_scene(3, H=64, W=64, n_rays=32, device='cpu'))
    for k in OUTPUTS:
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=1e-4)
    assert float(got['valid_mask'].mean()) > 0


def _fixture_model():
    """The golden fixture's scene, pyramid and weights in the port."""
    return golden_fixture_model(2)


def test_render_matches_reference_fixture():
    d, model, scene, z, (B, V, R, P) = _fixture_model()
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


def test_scan_renderer_matches_one_call():
    model = CrossAttentionRenderer(seed=0, device='cpu', **SMALL)
    scene = make_scene(1, H=32, W=32, n_rays=48, device='cpu')
    with torch.no_grad():
        z = model.encode(scene)
        whole = model(scene, z=z)
    rgb, valid = make_scan_renderer(model, 4)(scene, z, scene['query']['uv'])
    np.testing.assert_allclose(rgb.numpy(), whole['rgb'].numpy(), atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(),
                                  whole['valid_mask'].numpy())


def test_port_imports_no_jax():
    """Neither the port's modules nor chip_smoke.py pull in JAX, Flax or
    the JAX package."""
    code = '''
import importlib, pathlib, sys
pkg = pathlib.Path('cross_attention_renderer_torch')
for f in sorted(pkg.rglob('*.py')):
    importlib.import_module('.'.join(f.with_suffix('').parts).replace(
        '.__init__', ''))
importlib.import_module('chip_smoke')
bad = sorted(m for m in sys.modules if m.split('.')[0] in (
    'jax', 'jaxlib', 'flax', 'cross_attention_renderer_tpu'))
assert not bad, bad
print('clean')
'''
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and 'clean' in res.stdout, res.stderr


def test_render_stages_match_reference_fixture():
    """The fixture's per-stage activations: the epilogue's joint latent and
    key, the query embedding, both round-2 embeddings and phi's input."""
    d, model, scene, z, (B, V, R, P) = _fixture_model()
    got = {}

    def keep(name):
        def hook(module, args, out):
            got.setdefault(name, out)
        return hook

    for name in ('query_embed_2', 'encode_latent', 'query_repeat_embed_2'):
        getattr(model, name).register_forward_hook(keep(name))
    model.phi.register_forward_pre_hook(
        lambda module, args: got.setdefault('phi_in', args[0]))
    exchange = model._fused_exchange_v2

    def spy(*args):
        got['joint_latent'], got['key_val'] = exchange(*args)
        return got['joint_latent'], got['key_val']

    model._fused_exchange_v2 = spy
    with torch.no_grad():
        model(scene, z=z)

    def fixture(name, shape):
        """torch (B*V, C, R[, P]) channel-first -> channel-last ``shape``."""
        return np.moveaxis(d[f'stage_{name}_0'], 1, -1).reshape(shape)

    per_sample = (B, V, R, P, -1)
    for name, key in (('joint_latent', 'joint_latent'),
                      ('key_val', 'key_val'),
                      ('coords_embed', 'query_embed_2'),
                      ('repeat_embed', 'query_repeat_embed_2')):
        assert_close(name, got[key], fixture(name, per_sample))
    assert_close('z_embed', got['encode_latent'],
                 fixture('z_embed', (B, V, R, -1)))
    assert_close('phi_in', got['phi_in'], d['stage_phi_in_0'])


def test_unfused_exchange_stages_match_reference_fixture():
    """The unfused V=2 exchange (``fused_epilogue=False``) against the
    fixture's exchange-encoder outputs (its four calls: view 0's self and
    cross streams, then view 1's cross and self, the per-view channel
    order, models.py:335-346) and their per-view concatenation
    (``stage_interp_val``)."""
    d, model, scene, z, (B, V, R, P) = golden_fixture_model(
        2, fused_epilogue=False)
    got = []
    fuse = model._fuse_latent

    def spy(feat, points):
        got.append(fuse(feat, points))
        return got[-1]

    model._fuse_latent = spy
    with torch.no_grad():
        model(scene, z=z)
    fs0, fs1, fc0, fc1 = got           # self v0, v1, then cross v0, v1
    for k, out in enumerate((fs0, fc0, fc1, fs1)):
        want = np.moveaxis(d[f'stage_exchange_encode_{k}'], 1, -1)
        assert_close(f'exchange_encode_{k}', out.reshape(want.shape), want)
    interp = torch.cat([torch.cat([fs0, fc0], -1),
                        torch.cat([fc1, fs1], -1)])
    assert_close('interp_val', interp,
                 np.moveaxis(d['stage_interp_val_0'], 1, -1))
