"""Helpers shared by the ``test_torch_*`` parity tests: random Flax
parameters from a seed, and the closeness check of test_renderer_parity."""

from __future__ import annotations

import jax
import numpy as np


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
