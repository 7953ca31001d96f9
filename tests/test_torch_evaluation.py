"""The port's evaluation entry points against the JAX package's, on the CPU.

* ``utils/metrics.py`` (mse, psnr, ssim, eval_image_metrics) against JAX's
  on the same seeded images, f32 on both sides: 1e-5.
* ``losses/lpips.py`` against JAX's on the random-weight ``lpips_npz``
  fixture (tests/conftest.py), at 32x32: 1e-4 relative.
* ``train/evaluation.py:evaluate_scene`` against JAX's on a narrow model
  (the weights through ``params_from_jax``) and a 32x32 synthetic scene in
  2 chunks: PSNR within 1e-3 dB, SSIM within 1e-4, LPIPS 1e-4 relative.
* ``utils/profiling.py``: ``trace`` writing a Chrome trace.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.losses import lpips as JL
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.train import evaluation as JE
from cross_attention_renderer_tpu.utils import metrics as JM
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.losses import lpips as L
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.train import evaluation as E
from cross_attention_renderer_torch.utils import metrics as M
from cross_attention_renderer_torch.utils import profiling as PR
from torch_parity import random_flax_params

SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))


def _images(seed, H=40, W=36):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    target = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(
        np.float32)
    valid = (rng.uniform(0, 1, (H, W, 1)) > 0.2).astype(np.float32)
    return pred, target, valid


@pytest.mark.parametrize('data_range', [2.0, 1.0])
def test_metrics_match_jax(data_range):
    pred, target, _ = _images(0)
    tp, tt = torch.from_numpy(pred), torch.from_numpy(target)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    np.testing.assert_allclose(float(M.mse(tp, tt)), float(JM.mse(jp, jt)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(M.psnr(tp, tt)), float(JM.psnr(jp, jt)),
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(M.ssim(tp, tt, data_range=data_range)),
        float(JM.ssim(jp, jt, data_range=data_range)), rtol=1e-5, atol=1e-5)


def test_eval_image_metrics_match_jax():
    pred, target, valid = _images(1)
    got = M.eval_image_metrics(*map(torch.from_numpy, (pred, target, valid)))
    want = JM.eval_image_metrics(*map(jnp.asarray, (pred, target, valid)))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5)
    # the invalid rays are grey in both images
    grey = np.broadcast_to(valid == 0, pred.shape)
    assert (got['pred'].numpy()[grey] == 0.5).all()
    assert (got['target'].numpy()[grey] == 0.5).all()


def test_lpips_matches_jax(lpips_npz):
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    got = L.load_lpips(str(lpips_npz), device='cpu')(a, b).numpy()
    want = np.asarray(JL.load_lpips(str(lpips_npz))(jnp.asarray(a),
                                                    jnp.asarray(b)))
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4)
    same = L.load_lpips(str(lpips_npz), device='cpu')(a, a).numpy()
    np.testing.assert_allclose(same, 0.0, atol=1e-6)


def test_lpips_convert_weights_writes_the_jax_layout(lpips_npz, tmp_path):
    """The port's converter, given the torch state dicts the fixture's
    arrays came from, writes the same npz as the JAX package's."""
    d = dict(np.load(lpips_npz))
    ids = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    vgg = {}
    for i, lid in enumerate(ids):
        vgg[f'{lid}.weight'] = torch.from_numpy(
            d[f'conv{i}_w'].transpose(3, 2, 0, 1).copy())
        vgg[f'{lid}.bias'] = torch.from_numpy(d[f'conv{i}_b'])
    lins = {f'lin{i}.model.1.weight': torch.from_numpy(
        d[f'lin{i}_w'].reshape(1, -1, 1, 1)) for i in range(5)}
    out = L.convert_weights(vgg, lins, str(tmp_path / 'w.npz'))
    got = dict(np.load(out))
    assert set(got) == set(d)
    for k in d:
        np.testing.assert_array_equal(got[k], d[k])


def test_lpips_missing_weights_clear_error(tmp_path):
    with pytest.raises(FileNotFoundError, match='LPIPS weights not found'):
        L.load_lpips(str(tmp_path / 'nope.npz'), device='cpu')


def test_evaluate_scene_matches_jax(lpips_npz):
    H = W = 32
    jscene = jax_scene(4, H=H, W=W, n_rays=H * W, full_image=True)
    jax_model = JaxRenderer(n_view=2, fused_epilogue=True,
                            fused_attention=False, **SMALL)
    params = random_flax_params(jax_model, 0, jax_scene(4, H=H, W=W,
                                                        n_rays=8))
    want = JE.evaluate_scene(jax_model, params, jscene, H=H, W=W,
                             n_chunks=2,
                             lpips_fn=JL.load_lpips(str(lpips_npz)))

    model = CrossAttentionRenderer(device='cpu', **SMALL)
    model.load_state_dict(params_from_jax(params), strict=True)
    scene = make_scene(4, H=H, W=W, n_rays=H * W, full_image=True,
                       device='cpu')
    got = E.evaluate_scene(model, scene, H=H, W=W, n_chunks=2,
                           lpips_fn=L.load_lpips(str(lpips_npz),
                                                 device='cpu'))
    assert set(got) == set(want)
    assert abs(float(got['psnr']) - float(want['psnr'])) <= 1e-3
    assert abs(float(got['ssim']) - float(want['ssim'])) <= 1e-4
    np.testing.assert_allclose(got['lpips'], want['lpips'], rtol=1e-4)
    np.testing.assert_allclose(got['pred'], np.asarray(want['pred']),
                               atol=1e-4)
    np.testing.assert_array_equal(got['target'], np.asarray(want['target']))


def test_chunk_renderer_matches_one_call():
    model = CrossAttentionRenderer(seed=0, device='cpu', **SMALL)
    scene = make_scene(1, H=32, W=32, n_rays=48, device='cpu')
    encode, render_chunk = E.make_chunk_renderer(model)
    z = encode(scene)
    rgb, valid = E.render_full_image(render_chunk, scene, z,
                                     scene['query']['uv'], 3)
    with torch.no_grad():
        whole = model(scene, z=z)
    np.testing.assert_allclose(rgb.numpy(), whole['rgb'].numpy(), atol=1e-5)
    np.testing.assert_array_equal(valid.numpy(),
                                  whole['valid_mask'].numpy())


@pytest.mark.parametrize('fast', [dict(pruned=(16, 24)),
                                  dict(narrow=(8, 8, 16)), dict(q8=True)])
def test_image_renderer_fast_eval_is_not_ported_yet(fast):
    """The fast-eval options of ``make_image_renderer``, refused until the
    fast renderers were ported, now render the scene's full image: finite,
    with the dense renderer's valid mask (their parity with JAX is in
    tests/test_torch_fast_eval.py)."""
    model = CrossAttentionRenderer(seed=0, device='cpu', **SMALL)
    scene = make_scene(2, H=32, W=32, n_rays=32 * 32, full_image=True,
                       device='cpu')
    encode, render_image = E.make_image_renderer(model, 2, **fast)
    rgb, valid = render_image(scene, encode(scene))
    dense = E.make_image_renderer(model, 2)
    _, valid_dense = dense[1](scene, dense[0](scene))
    assert rgb.shape == (1, 1, 32 * 32, 3) and torch.isfinite(rgb).all()
    assert torch.equal(valid, valid_dense)


def test_trace_writes_a_chrome_trace(tmp_path):
    with PR.trace(str(tmp_path / 'tr'), cuda=False) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / 'tr' / 'trace.json').read_text())
    assert data['traceEvents']
    assert any('mm' in e.key for e in prof.key_averages())
