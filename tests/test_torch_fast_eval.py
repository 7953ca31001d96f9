"""The port's fast-eval renderers against JAX's, at V=2, on the CPU.

* ``resample_epipolar_t`` against JAX's (atol 1e-6: the same f32
  arithmetic in another order), degenerate weights at ``floor=0``
  included.
* ``quantize_pyramid``: the int8 tables equal JAX's exactly, the folded
  fuse kernel within 1e-6 relative. ``narrow_pyramid``: each narrowed
  level times its folded kernel rows (what the fuse layer computes, and
  the same whatever sign ``eigh`` gives each component) within 1e-4 of
  max(1, |JAX|).
* ``forward(t_vals=...)`` on the staged (K2, K1), fused-render (K4) and
  sorted (K5) paths against the JAX renderer with the same ``t_vals``.
* ``make_fast_renderer`` for each lever and their composition on the
  staged and fused-render paths (and pruned and narrow on the sorted one)
  against JAX's, at 1e-4 + rtol max(1, |JAX|) (``LEVER_RTOL``); q8
  refused where no packed table is read.
* The CLI's fast-eval flags: the port's and JAX's parse alike, and their
  image renderers give the same image and metrics on a full image.

The renders' tolerances, and why, are at ``LEVER_RTOL``
(tests/torch_fast_cases.py).

The port's kernels run their plain versions here; the same weights
(``params_from_jax``) and pyramid (torch_fast_cases.py) on both sides, f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.cli import common as JC
from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.train import evaluation as JE
from cross_attention_renderer_torch.cli import common as C
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.train import evaluation as E
from torch_fast_cases import (  # noqa: F401
    LEVER_RTOL, LEVERS, Case, one_torch_thread)
from torch_parity import assert_close

RESAMPLE_CASES = {
    'random': ((1, 2, 5, 16), 24, 0.1),
    'random_floor0': ((2, 2, 3, 8), 12, 0.0),
    'peaked': ((1, 1, 4, 16), 32, 0.1),
    'zeros_floor0': ((1, 2, 3, 8), 16, 0.0),
    'zeros': ((1, 2, 3, 8), 16, 0.1),
}


def _weights(name, shape):
    rng = np.random.default_rng(len(name))
    if name.startswith('zeros'):
        return np.zeros(shape, np.float32)
    w = rng.random(shape).astype(np.float32)
    if name == 'peaked':
        w *= 1e-6
        w[..., 10] = 1.0
    return w / w.sum(axis=(1, 3), keepdims=True)


@pytest.mark.parametrize('name', sorted(RESAMPLE_CASES))
def test_resample_matches_jax(name):
    shape, n_fine, floor = RESAMPLE_CASES[name]
    w = _weights(name, shape)
    got = E.resample_epipolar_t(torch.from_numpy(w), n_fine, floor).numpy()
    want = np.asarray(jax.jit(JE.resample_epipolar_t, static_argnums=(
        1, 2))(jnp.asarray(w), n_fine, floor))
    assert got.shape == shape[:-1] + (n_fine,)
    assert np.isfinite(got).all() and (np.diff(got, axis=-1) >= 0).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.fixture(scope='module')
def case():
    return Case(2)


def _fuse_kernel(params):
    return np.asarray(params['params']['query_encode_latent']['kernel'])


def test_quantize_pyramid_matches_jax(case):
    # one all-zero channel (its scale clamps to 1e-8, its rows to 0)
    z = [np.array(x) for x in case.jz]
    z[2][..., 5] = 0.0
    z_q, m_q = E.quantize_pyramid(case.model(),
                                  [torch.from_numpy(x) for x in z])
    jz_q, p_q = JE.quantize_pyramid(case.params, tuple(map(jnp.asarray, z)))
    for got, want in zip(z_q, jz_q):
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kern = m_q.query_encode_latent.kernel.detach().numpy()
    want = _fuse_kernel(p_q)
    np.testing.assert_allclose(kern, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_narrow_pyramid_fold_matches_jax(case):
    widths = (16, 32, 32)           # level 1 passes at its full width
    z_n, m_n = E.narrow_pyramid(case.model(), case.z, widths)
    jz_n, p_n = JE.narrow_pyramid(case.params, case.jz, widths)
    assert m_n.narrow_features == widths
    kern = m_n.query_encode_latent.kernel.detach().numpy()
    jkern = _fuse_kernel(p_n)
    assert kern.shape == jkern.shape == (sum(widths) + 3, 128)
    off = 0
    for got, want, k in zip(z_n, jz_n, widths):
        rows = slice(off, off + k)
        assert_close('z_n @ fold', got.reshape(-1, k).numpy()
                     @ kern[rows], np.asarray(want).reshape(-1, k)
                     @ jkern[rows], atol=1e-4, rtol=1e-4)
        off += k
    np.testing.assert_allclose(kern[off:], jkern[off:], rtol=1e-6)
    # the caller's model keeps its full-width fuse kernel
    assert case.model().query_encode_latent.kernel.shape[0] == 128 + 3


def test_folds_share_every_other_weight(case):
    """The narrow and q8 siblings hold their own fuse kernel and share
    every other parameter tensor with the model, which keeps its own; the
    coarse pass's sibling shares all of them."""
    model = case.model()
    kernel = model.query_encode_latent.kernel
    z_n, narrow = E.narrow_pyramid(model, case.z, (16, 16, 32))
    _, both = E.quantize_pyramid(narrow, z_n)
    coarse = model.clone(repeat_attention=False)
    assert model.query_encode_latent.kernel is kernel
    assert model.repeat_attention and not coarse.repeat_attention
    theirs = dict(model.named_parameters())
    for sibling in (narrow, both, coarse):
        own = dict(sibling.named_parameters())
        folded = sibling is not coarse
        assert set(theirs) - set(own) == (
            {'query_encode_latent.kernel'} if folded else set())
        assert all(own[k] is theirs[k] for k in own)
    assert both.query_encode_latent.kernel.shape == (16 + 16 + 32 + 3, 128)


PATHS = {'staged': {}, 'fused': dict(fused_render=True),
         'sorted': dict(sorted_stream=True)}


@pytest.fixture(scope='module')
def t_vals_render(case):
    """Sorted random sample positions (12 a ray, not the model's 8) and
    JAX's render at them."""
    rng = np.random.default_rng(7)
    t = np.sort(rng.random((1, 2, 64, 12)), axis=-1).astype(np.float32)
    want = jax.jit(lambda p, s, z, t: case.jmodel.apply(p, s, z=z,
                                                        t_vals=t))(
        case.params, case.jscene, case.jz, jnp.asarray(t))
    return t, want


@pytest.mark.parametrize('path', sorted(PATHS))
def test_t_vals_match_jax(case, t_vals_render, path):
    t, want = t_vals_render
    model = case.model(**PATHS[path])
    with torch.no_grad():
        got = model(case.scene, z=case.z, t_vals=torch.from_numpy(t))
        default = model(case.scene, z=case.z)
        uniform = model(case.scene, z=case.z, t_vals=torch.linspace(
            0, 1, 8).expand(1, 2, 64, 8))
    for k in ('rgb', 'depth_ray', 'valid_mask', 'at_wt', 'pixel_val'):
        assert_close(k, got[k].numpy(), want[k], atol=1e-4, rtol=1e-4)
        # uniform t_vals are the default path (JAX
        # tests/test_pruned_render.py:78-101)
        np.testing.assert_allclose(uniform[k].numpy(), default[k].numpy(),
                                   atol=1e-6)


@pytest.fixture(scope='module')
def jax_levers(case):
    return {}


def _jax_lever(case, cache, lever):
    if lever not in cache:
        cache[lever] = case.jax_fast(**LEVERS[lever])
    return cache[lever]


FAST_CASES = ([(lever, path) for lever in sorted(LEVERS)
               for path in ('staged', 'fused')]
              + [('narrow', 'sorted'), ('pruned', 'sorted')])


@pytest.mark.parametrize('lever,path', FAST_CASES)
def test_fast_renderer_matches_jax(case, jax_levers, lever, path):
    rgb, valid = case.port_fast(case.model(**PATHS[path]), **LEVERS[lever])
    rgb_j, valid_j = _jax_lever(case, jax_levers, lever)
    assert rgb.shape == rgb_j.shape == (1, 1, 64, 3)
    np.testing.assert_array_equal(valid, valid_j)
    assert_close('rgb', rgb, rgb_j, atol=1e-4, rtol=LEVER_RTOL[lever])


def test_q8_refuses_paths_without_packed_tables(case):
    """The sorted stream and the V=3 one-hot and banded gathers read no
    packed table and have no int8 mode: q8 raises (narrow and pruned
    run, above)."""
    for kw in (dict(sorted_stream=True),):
        with pytest.raises(ValueError, match='int8 cell tables'):
            E.make_fast_renderer(case.model(**kw), 2, q8=True)
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    for gather in ('onehot', 'banded'):
        model = CrossAttentionRenderer(n_view=3, device='cpu',
                                       reference_exchange_compat=True,
                                       gather=gather, npoints=8,
                                       fusion_features=32, vit_width=64,
                                       vit_depth=2, vit_heads=2,
                                       resnet_layers=(1, 1, 1))
        with pytest.raises(ValueError, match='int8 cell tables'):
            E.make_fast_renderer(model, 2, pruned=(4, 8), q8=True)


def test_cli_fast_flags_match_jax(case):
    """The CLI's --fast (narrowed to the small model's widths): both
    packages parse the flags alike, and the image renderers they build
    give the same image and metrics on a full 32x32 image."""
    argv = ['--fast', '--narrow', '16,16,32']
    kw = C.fast_eval_kwargs(C.base_parser('t').parse_args(argv))
    assert kw == JC.fast_eval_kwargs(JC.base_parser('t').parse_args(argv))
    assert kw == dict(pruned=(8, 16), narrow=(16, 16, 32), q8=True)
    H = W = 32
    jscene = jax_scene(4, H=H, W=W, n_rays=H * W, full_image=True)
    renderer = JE.make_image_renderer(case.jmodel, case.params, 2, **kw)
    want = JE.evaluate_scene(case.jmodel, case.params, jscene, H, W,
                             n_chunks=2, renderer=renderer)
    # the port renders JAX's pyramid of the scene (torch_fast_cases.py)
    z = tuple(torch.from_numpy(np.array(x))
              for x in renderer[0](jscene))
    scene = make_scene(4, H=H, W=W, n_rays=H * W, full_image=True,
                       device='cpu')
    model = case.model()
    _, render_image = E.make_image_renderer(model, 2, **kw)
    got = E.evaluate_scene(model, scene, H, W, n_chunks=2,
                           renderer=(lambda s: z, render_image))
    assert_close('pred', got['pred'], want['pred'], atol=1e-4,
                 rtol=LEVER_RTOL['fast'])
    for k in ('mse', 'psnr', 'ssim'):
        np.testing.assert_allclose(got[k], want[k], rtol=LEVER_RTOL['fast'],
                                   err_msg=k)
