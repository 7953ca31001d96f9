"""A default-route train step of the ResNet34 and U-Net models and of a
one-view model against the JAX package's, on the CPU.

As tests/test_torch_train.py's stage 1, at its tolerances: the same random
weights and scene (16 query rays, 64x64, 8 samples, f32) through JAX's
``make_loss_fn`` under ``jax.value_and_grad`` and the port's
``make_loss_fn`` under ``backward`` (the unfused exchange, the plain
attention). Each loss within 1e-5 relative; each parameter's gradient
within 1e-4 of that tensor's largest JAX gradient, and never below 1e-7
of the largest gradient of all (rounding noise where the gradient is 0 in
exact arithmetic).

The ResNet34 case is held to an f64 run of the port instead, at the same
1e-4, and to JAX within 5e-2: JAX's f32 gradients of that encoder's
convolutions and norms are themselves off the f64 gradient by a few
percent of their largest entry (3.3e-2 for ``layer3_b4.conv1`` here; the
port's f32 ones by 1e-5 in one thread; both packages' by ~5e-3 where
the CPU sums run in several threads), which the assertion message
reports.

Then one ``make_train_step`` step of the port: its loss is the one
checked, its grad_norm finite and most parameters moved.
"""

import jax
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.train import trainer as JT
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.train import trainer as T
from torch_parity import random_flax_params

TINY = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=1,
            vit_heads=2, resnet_layers=(1, 1, 1))
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
JAX_F32_GRAD_TOL = 5e-2     # JAX's f32 ResNet34 gradients against f64
GRAD_FLOOR = 1e-7
CASES = {'resnet': dict(model='resnet', n_view=2),
         'unet': dict(model='unet', n_view=2),
         'dpt-v1': dict(n_view=1)}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('case', CASES)
def test_train_step_matches_jax(case):
    kw = dict(TINY, **CASES[case])
    V = kw['n_view']
    cfg = T.TrainConfig()
    scene = jax_scene(0, batch=1, n_view=V, H=64, W=64, n_rays=16)
    jax_model = JaxRenderer(**kw)
    params = random_flax_params(jax_model, 0, scene)
    (want_tot, want_losses), want_grads = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(jax_model, JT.TrainConfig()), has_aux=True))(
            params, scene)

    model = CrossAttentionRenderer(device='cpu', **kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    tscene = make_scene(0, batch=1, n_view=V, H=64, W=64, n_rays=16,
                        device='cpu')
    tot, losses = T.make_loss_fn(model, cfg)(tscene)
    tot.backward()
    jax_grads = params_from_jax(jax.tree.map(np.asarray, want_grads))
    tol = GRAD_TOL
    if case == 'resnet':
        ref = CrossAttentionRenderer(device='cpu', dtype=torch.float64, **kw)
        ref.load_state_dict(params_from_jax(params), strict=True)
        ref.double()
        T.make_loss_fn(ref, cfg)(tscene)[0].backward()
        want = {n: p.grad for n, p in ref.named_parameters()}
        for name, w in jax_grads.items():
            err = float((w.double() - want[name]).abs().max())
            assert err <= JAX_F32_GRAD_TOL * float(want[name].abs().max()), (
                f'JAX {name}: max abs err {err:.3e} against f64')
    else:
        want = jax_grads
    assert losses.keys() == want_losses.keys()
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(want_losses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(tot.detach()), float(want_tot),
                               rtol=LOSS_RTOL)
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for name, p in got.items():
        g = (p.grad if p.grad is not None else torch.zeros_like(p)).numpy()
        w = want[name].float().numpy()
        err = float(np.abs(g - w).max())
        assert err <= max(tol * float(np.abs(w).max()), floor), (
            f'{name}: max abs err {err:.3e}, max |grad| '
            f'{float(np.abs(w).max()):.3e}')

    model.zero_grad(set_to_none=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = T.create_train_state(model, cfg)
    state, metrics = T.make_train_step(model, cfg)(state, tscene)
    assert state.step == 1
    np.testing.assert_allclose(float(metrics['total_loss']), float(want_tot),
                               rtol=LOSS_RTOL)
    assert np.isfinite(float(metrics['grad_norm']))
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), before[n])]
    assert len(moved) > len(before) // 2
