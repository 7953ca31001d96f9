"""Helpers shared by the ``test_torch_*`` parity tests: random Flax
parameters from a seed, the closeness check of test_renderer_parity, and
the reference golden fixtures loaded into the port."""

from __future__ import annotations

import pathlib
import sys

import jax
import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def random_flax_params(module, seed: int, *init_args) -> dict:
    """Parameters of ``module`` with its init tree's shapes, drawn with
    numpy: kernels ~ N(0, 1/fan_in), norm scales near 1, small biases.
    Only the shapes are traced; nothing is compiled."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if name == 'scale':
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == 'bias':
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == 'kernel' and len(s.shape) == 3:
            fan = (s.shape[0] * s.shape[1] if path[-2].key == 'out'
                   else s.shape[0])
        else:
            fan = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.standard_normal(s.shape)
                / np.sqrt(max(fan, 1))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def assert_close(name, got, want, atol=2e-3, rtol=1e-3):
    """max |got - want| <= atol + rtol * max(1, max |want|)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.maximum(np.abs(want), 1.0).max())
    assert err <= atol + rtol * scale, (
        f'{name}: max abs err {err:.2e} (scale {scale:.2e})')


def golden_fixture_model(n_view: int, convert=None, **model_kwargs):
    """tests/fixtures/renderer_golden_v{n_view}.npz (the reference torch
    model's inputs, pyramid, weights and outputs) loaded into the port.

    The weights pass ``convert(sd, n_view=...)``: by default the JAX
    repository's ``convert_reference_state_dict`` then ``params_from_jax``.
    Returns (fixture dict, model, scene, z, (B, V, R, P))."""
    sys.path.insert(0, str(ROOT))
    from cross_attention_renderer_torch.convert import params_from_jax
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from tools.convert_checkpoint import convert_reference_state_dict
    if convert is None:
        def convert(sd, n_view):
            return params_from_jax(convert_reference_state_dict(
                sd, n_view=n_view))

    d = dict(np.load(ROOT / 'tests' / 'fixtures'
                     / f'renderer_golden_v{n_view}.npz'))
    views, npoints, H, W, rays = (int(v) for v in d['meta'])
    assert views == n_view
    scene = {'context': {k: torch.from_numpy(d[f'scene_context_{k}'])
                         for k in ('rgb', 'cam2world', 'intrinsics')},
             'query': {k: torch.from_numpy(d[f'scene_query_{k}'])
                       for k in ('cam2world', 'intrinsics', 'uv')}}
    z = tuple(torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(d[f'z_{i}'], 1, -1))) for i in range(3))
    sd = {k[len('sd_'):]: v for k, v in d.items() if k.startswith('sd_')}
    # Full-width heads (fusion_features 256); the encoder, which the fixture
    # does not hold (z is given), is kept small.
    model = CrossAttentionRenderer(n_view=n_view, npoints=npoints,
                                   vit_width=64, vit_depth=2, vit_heads=2,
                                   resnet_layers=(1, 1, 1), device='cpu',
                                   **model_kwargs)
    missing, unexpected = model.load_state_dict(convert(sd, n_view=views),
                                                strict=False)
    # The fixture also holds the single-view merge layer, which the
    # multi-view paths never build.
    assert all(k.startswith('encoder.') for k in missing)
    assert all(k.startswith('update_val_merge.') for k in unexpected)
    return d, model, scene, z, (1, views, rays, npoints)
