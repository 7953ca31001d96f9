"""Inputs shared by the fast-eval parity tests (tests/test_torch_fast_eval*.py):
a narrow model's random weights, its scene and its pyramid, on both sides.

The JAX model runs its standard CPU path (the unfused exchange, the plain
attention); its weights go to the port through ``params_from_jax``. Both
sides render from the same pyramid, JAX's encode of the scene, handed to
the port as it is: the levers' outputs (the int8 tables above all, whose
rounding a 1e-7 difference in the encoders' outputs could flip) are then
functions of the same inputs on both sides.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.train import evaluation as JE
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.train import evaluation as E
from torch_parity import random_flax_params

# fusion_features 32: pyramid levels of 32, 32 and 64 channels
SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))
SCENE = dict(H=64, W=64, n_rays=64)
CHUNKS = 2
# Each lever at the small model's widths, and the three composed (the
# CLI's --fast) at a pruned setting of its own.
LEVERS = {'pruned': dict(pruned=(4, 8)), 'narrow': dict(narrow=(16, 16, 32)),
          'q8': dict(q8=True),
          'fast': dict(pruned=(8, 16), narrow=(16, 16, 32), q8=True)}
# The renders' tolerances against JAX's, relative to max(1, |JAX|) beside
# an absolute 1e-4 (measured at V=2, scale 5.7-5.9). The pruned renderer
# holds the V=2 render tests' 1e-4 (tests/test_torch_fused_render.py). On
# one ray of the V=2 scene the dense render itself differs from JAX's by
# 8.1e-4 (1.4e-4 of the scale; every other ray within 3e-5), and narrow
# and q8 carry that ray on (1.1e-3 and 8.1e-4): 2.5e-4. The composition
# quantizes the narrowed pyramid, whose PCA bases come from two ``eigh``
# implementations that agree to the last bits only, so an entry within
# that of a rounding boundary may take the next int8 value on one side
# (a step is 1/127 of its channel's largest value): 2.6e-3 measured,
# 1e-3.
LEVER_RTOL = {'pruned': 1e-4, 'narrow': 2.5e-4, 'q8': 2.5e-4, 'fast': 1e-3}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Case:
    """One view count's JAX model, weights, scene and pyramid, and the
    port's scene and pyramid (the same values)."""

    def __init__(self, n_view: int, seed: int = 3):
        self.n_view = n_view
        self.jscene = jax_scene(seed, n_view=n_view, **SCENE)
        self.jmodel = JaxRenderer(n_view=n_view, fused_attention=False,
                                  **SMALL)
        self.params = random_flax_params(self.jmodel, 0, self.jscene)
        self.jz = jax.jit(lambda p, s: self.jmodel.apply(
            p, s, method='encode'))(self.params, self.jscene)
        self.scene = make_scene(seed, n_view=n_view, device='cpu', **SCENE)
        self.z = tuple(torch.from_numpy(np.array(x)) for x in self.jz)

    def model(self, **kw) -> CrossAttentionRenderer:
        """The port's model on these weights (CPU, f32)."""
        m = CrossAttentionRenderer(n_view=self.n_view, device='cpu',
                                   **SMALL, **kw)
        m.load_state_dict(params_from_jax(self.params), strict=True)
        return m.eval()

    def jax_fast(self, **lever):
        """JAX's fast renderer's (rgb, valid) on the scene."""
        render = JE.make_fast_renderer(self.jmodel, CHUNKS, **lever)
        rgb, valid = render(self.params, self.jscene, self.jz,
                            self.jscene['query']['uv'])
        return np.asarray(rgb), np.asarray(valid)

    def port_fast(self, model, **lever):
        rgb, valid = E.make_fast_renderer(model, CHUNKS, **lever)(
            self.scene, self.z, self.scene['query']['uv'])
        return rgb.numpy(), valid.numpy()
