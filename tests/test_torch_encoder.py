"""The port's encoder, image utilities and decoder against JAX.

The encoder runs at a small size (ViT width 64, depth 2, 2 heads, fusion
features 32, one bottleneck per stage, 64x64 images) with the same random
weights on both sides, passed through ``params_from_jax``. Tolerance 1e-4
relative to max(1, |ref|): both compute in f32, in another summation order.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.encoders.dpt import (
    DPTHybridEncoder as JaxEncoder)
from cross_attention_renderer_tpu.utils import image as JI
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.encoders.dpt import DPTHybridEncoder
from cross_attention_renderer_torch.models.resnet_fc import ResnetFC
from cross_attention_renderer_torch.utils import image as TI
from torch_parity import assert_close, random_flax_params

SMALL = dict(features=32, vit_width=64, vit_depth=2, vit_heads=2,
             resnet_layers=(1, 1, 1))


@pytest.mark.parametrize('n_view', [2, 3])
def test_encoder_matches_jax(n_view):
    """The joint multi-view ViT attends over every view's tokens at once,
    so V=3 is a distinct sequence length, not a repeat of V=2."""
    rng = np.random.default_rng(0)
    rgb = rng.standard_normal((1, n_view, 64, 64, 3)).astype(np.float32)
    pose = rng.standard_normal((1, n_view, 16)).astype(np.float32)
    jax_enc = JaxEncoder(**SMALL)
    params = random_flax_params(jax_enc, 0, rgb, pose)
    want = jax.jit(jax_enc.apply)(params, jnp.asarray(rgb),
                                  jnp.asarray(pose))

    enc = DPTHybridEncoder(**SMALL)
    enc.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(rgb), torch.from_numpy(pose))
    for name, a, b in zip(('path2', 'path1'), got, want):
        assert_close(name, a.numpy(), b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('align_corners', [False, True])
def test_resize_bilinear_matches_jax(align_corners):
    x = np.random.default_rng(1).standard_normal((2, 14, 14, 5)).astype(
        np.float32)
    got = TI.resize_bilinear(torch.from_numpy(x), (16, 16), align_corners)
    want = JI.resize_bilinear(jnp.asarray(x), (16, 16), align_corners)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_upsample_and_normalize_match_jax():
    x = np.random.default_rng(2).uniform(0, 1, (1, 6, 9, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        TI.upsample2x_align_corners(torch.from_numpy(x)).numpy(),
        np.asarray(JI.upsample2x_align_corners(jnp.asarray(x))), atol=1e-5)
    np.testing.assert_allclose(
        TI.normalize_imagenet(torch.from_numpy(x)).numpy(),
        np.asarray(JI.normalize_imagenet(jnp.asarray(x))), atol=1e-6)


def test_resnetfc_matches_golden():
    """phi with the reference's weights reproduces the reference outputs
    (tests/fixtures/resnetfc_golden.npz, test_resnetfc_parity's 2e-4)."""
    fix = dict(np.load(pathlib.Path(__file__).parent / 'fixtures'
                       / 'resnetfc_golden.npz'))
    phi = ResnetFC(d_in=18, d_latent=576, d_out=3, n_blocks=3, d_hidden=128)
    sd = {}
    for name in ['lin_in', 'lin_out'] + [f'lin_z{i}' for i in range(3)]:
        src = name.replace('lin_z', 'lin_z_')
        sd[f'{name}.weight'] = fix[f'w_{src}_weight']
        sd[f'{name}.bias'] = fix[f'w_{src}_bias']
    for i in range(3):
        for fc in ('fc_0', 'fc_1'):
            for p in ('weight', 'bias'):
                sd[f'block{i}.{fc}.{p}'] = fix[f'w_blocks_{i}_{fc}_{p}']
    phi.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                        strict=True)
    with torch.no_grad():
        out = phi(torch.from_numpy(fix['zx']))
    np.testing.assert_allclose(out.numpy(), fix['out'], atol=2e-4)
