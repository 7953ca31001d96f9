"""The port's training path against the JAX package's, on the CPU.

The same random weights (``random_flax_params``, then ``params_from_jax``)
and the same scenes (``make_scene``, one numpy draw per seed) go through
JAX's ``make_loss_fn`` under ``jax.value_and_grad`` and the port's
``make_loss_fn`` under ``backward``, both on the default training route
(plain attention, unfused exchange), in f32, at JAX ``test_train.py``'s
``TINY`` shapes. JAX's loss and gradients are compiled once a stage, in
module fixtures. Tolerances:

* each loss within 1e-5 relative;
* stage 1 (16 rays): each parameter's gradient within 1e-4 of that
  tensor's largest JAX gradient, and never below f32 rounding, 1e-7 of
  the largest gradient of all (the ViT's key biases have a gradient of 0
  in exact arithmetic, since the softmax ignores a shift shared by every
  key: both sides give rounding noise there);
* stage 2 (1,024 rays): 2e-3 of each tensor's largest gradient. The two
  forwards agree to ~1.5e-4 of max |rgb| there, and among the decoder's
  ~500k ReLU inputs a few lie within that of 0, where one side passes a
  ray's gradient and the other does not; each such unit moves the
  decoder's first-layer gradient by ~1e-3 of its largest entry (measured:
  1.2e-3 at most; 2.4e-4 for the encoder's first convolution);
* over three train steps at TrainConfig's learning rate (5e-5), losses
  and ``grad_norm`` within 1e-4 relative. The parameters themselves are
  not compared: Adam moves an element whose gradient is rounding noise
  (directions the GroupNorms and the softmax ignore) by up to a whole
  step, in a direction the noise picks.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.losses import lpips as JL
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.train import summaries as JS
from cross_attention_renderer_tpu.train import trainer as JT
from cross_attention_renderer_tpu.utils import params_io as jax_params_io
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.losses.lpips import load_lpips
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.train import summaries as S
from cross_attention_renderer_torch.train import trainer as T
from cross_attention_renderer_torch.utils import params_io
from torch_parity import random_flax_params

TINY = dict(fusion_features=32, vit_width=64, vit_depth=2, vit_heads=2,
            resnet_layers=(1, 1, 1))
MODEL = dict(n_view=2, npoints=8, **TINY)
LOSS_RTOL = 1e-5
GRAD_TOL = {1: 1e-4, 2: 2e-3}
GRAD_FLOOR = 1e-7
STEP_RTOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The module's training steps in one intra-op thread: the tier-1 run
    puts six test workers on the machine's cores, and a backward pass
    whose thread pool spans them all ran up to 50x slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stage(cfg, n_rays, lpips_fn=None, patch=False):
    """JAX's scene, weights and compiled value_and_grad of make_loss_fn."""
    scene = jax_scene(0, batch=1, n_view=2, H=64, W=64, n_rays=n_rays)
    if patch:   # one 32x32 ray patch, mask 1 (the LPIPS / depth gate)
        scene['query']['mask'] = jnp.ones((1,), jnp.float32)
    model = JaxRenderer(**MODEL)
    params = random_flax_params(model, 0, scene)
    vg = jax.jit(jax.value_and_grad(
        JT.make_loss_fn(model, cfg, lpips_fn=lpips_fn), has_aux=True))
    return scene, params, vg


@pytest.fixture(scope='module')
def stage1():
    cfg = JT.TrainConfig()
    return _stage(cfg, 16)


@pytest.fixture(scope='module')
def stage2(lpips_npz):
    cfg = JT.TrainConfig(depth=True, lpips=True)
    return _stage(cfg, 1024, JL.load_lpips(str(lpips_npz)), patch=True)


def _port(params, n_rays, patch=False):
    model = CrossAttentionRenderer(device='cpu', **MODEL)
    model.load_state_dict(params_from_jax(params), strict=True)
    scene = make_scene(0, batch=1, n_view=2, H=64, W=64, n_rays=n_rays,
                       device='cpu')
    if patch:
        scene['query']['mask'] = torch.ones(1)
    return model, scene


def _check_loss_and_grads(stage, cfg, n_rays, grad_tol, lpips_fn=None,
                          patch=False):
    scene, params, vg = stage
    (want_tot, want_losses), want_grads = vg(params, scene)
    model, tscene = _port(params, n_rays, patch)
    tot, losses = T.make_loss_fn(model, cfg, lpips_fn=lpips_fn)(tscene)
    tot.backward()

    assert losses.keys() == want_losses.keys()
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(want_losses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(tot.detach()), float(want_tot),
                               rtol=LOSS_RTOL)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    got = dict(model.named_parameters())
    assert got.keys() == want.keys()
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    for name, p in got.items():
        g = (p.grad if p.grad is not None
             else torch.zeros_like(p)).numpy()
        w = want[name].numpy()
        err = float(np.abs(g - w).max())
        assert err <= max(grad_tol * float(np.abs(w).max()), floor), (
            f'{name}: max abs err {err:.3e}, max |grad| '
            f'{float(np.abs(w).max()):.3e}')
    return losses


def test_stage1_loss_and_gradients_match_jax(stage1):
    _check_loss_and_grads(stage1, T.TrainConfig(), 16, GRAD_TOL[1])


def test_stage2_loss_and_gradients_match_jax(stage2, lpips_npz):
    """depth + LPIPS on one 32x32 patch (mask 1): both terms present and
    nonzero, every gradient as JAX's."""
    losses = _check_loss_and_grads(
        stage2, T.TrainConfig(depth=True, lpips=True), 1024, GRAD_TOL[2],
        load_lpips(str(lpips_npz), device='cpu'), patch=True)
    assert float(losses['lpips_loss']) > 0 and float(losses['depth_loss']) > 0


@jax.jit
def _jax_apply(grads, opt_state, params, clip_norm):
    """JAX make_optimizer's update (optax clip + adam) at TrainConfig's
    learning rate, the clip traced, so both cases share one compile."""
    tx = JT.make_optimizer(JT.TrainConfig(clip_norm=clip_norm))
    updates, opt_state = tx.update(grads, opt_state, params)
    return (optax.apply_updates(params, updates), opt_state,
            optax.global_norm(grads))


@pytest.mark.parametrize('clip_norm', [1e4, 1e-2], ids=['free', 'clipped'])
def test_three_train_steps_track_jax(stage1, clip_norm):
    """Three make_train_step steps against JAX's loss, gradients and
    make_optimizer (optax clip + adam) applied step by step; the 'clipped'
    case's small clip_norm is below every step's grad_norm."""
    scene, params, vg = stage1
    cfg = T.TrainConfig(clip_norm=clip_norm)
    opt_state = JT.make_optimizer(JT.TrainConfig()).init(params)
    want = []
    for _ in range(3):
        (tot, _), grads = vg(params, scene)
        params, opt_state, gnorm = _jax_apply(grads, opt_state, params,
                                              clip_norm)
        want.append((float(tot), float(gnorm)))

    model, tscene = _port(stage1[1], 16)
    state = T.create_train_state(model, cfg)
    step = T.make_train_step(model, cfg)
    got = []
    for _ in range(3):
        state, m = step(state, tscene)
        got.append((float(m['total_loss']), float(m['grad_norm'])))
    assert state.step == 3
    np.testing.assert_allclose(got, want, rtol=STEP_RTOL)
    if clip_norm < 1:
        assert min(g for _, g in want) > 10 * clip_norm


def test_lpips_gradient_matches_jax(lpips_npz):
    """load_lpips's function is differentiable: a nonzero gradient in the
    prediction, equal to JAX's gradient of lpips_distance (1e-4 of its
    largest entry)."""
    rng = np.random.default_rng(1)
    a = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    weights = {k: jnp.asarray(v) for k, v in np.load(lpips_npz).items()}
    want = np.asarray(jax.jit(jax.grad(lambda x, y: JL.lpips_distance(
        weights, x, y).sum()))(jnp.asarray(a), jnp.asarray(b)))
    fn = load_lpips(str(lpips_npz), device='cpu')
    x = torch.from_numpy(a).requires_grad_(True)
    fn(x, torch.from_numpy(b)).sum().backward()
    got = x.grad.numpy()
    assert float(np.abs(want).max()) > 0
    assert float(np.abs(got - want).max()) <= 1e-4 * float(
        np.abs(want).max())


class _Recorder:
    """A writer that keeps what it is given."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, np.asarray(value, np.float64), step))

    def add_image(self, tag, image, step, dataformats='HWC'):
        self.calls.append((tag, np.asarray(image), step, dataformats))


@pytest.mark.parametrize('n_rays,full', [(64, True), (48, False)],
                         ids=['square', 'scattered'])
def test_summaries_match_jax(n_rays, full):
    """The port's summaries on torch tensors equal JAX's on the same
    arrays: every scalar and image write_summaries emits, and the helpers."""
    rng = np.random.default_rng(2)
    V, H, W, P = 2, 8, 8, 6
    R = H * W if full else n_rays
    scene = {'context': {'rgb': rng.uniform(
        -1, 1, (1, V, H, W, 3)).astype(np.float32)},
             'query': {'uv': rng.uniform(0, H - 1, (1, 1, R, 2)).astype(
                 np.float32)}}
    at = rng.dirichlet(np.ones(V * P), (1, R)).reshape(1, R, V, P)
    out = {'at_wt': at.transpose(0, 2, 1, 3),
           'rgb': rng.uniform(-1, 1, (1, 1, R, 3)),
           'depth_ray': rng.uniform(0, 5, (1, R, 1)),
           'pixel_val': rng.uniform(-1, 1, (1, V, R, P, 2))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    if full:
        del scene['query']['uv']

    def torchify(tree):
        return {k: torchify(v) if isinstance(v, dict)
                else torch.from_numpy(v)
                for k, v in tree.items()}

    want, got = _Recorder(), _Recorder()
    JS.write_summaries(want, 5, scene, out, prefix='train_')
    S.write_summaries(got, 5, torchify(scene), torchify(out),
                      prefix='train_')
    assert [c[0] for c in got.calls] == [c[0] for c in want.calls]
    for g, w in zip(got.calls, want.calls):
        assert g[2:] == w[2:] and g[1].dtype == w[1].dtype, g[0]
        np.testing.assert_allclose(g[1], w[1], atol=1e-6, err_msg=g[0])
    np.testing.assert_allclose(S.attention_entropy(torch.from_numpy(
        out['at_wt'])), JS.attention_entropy(out['at_wt']), rtol=1e-6)
    depth = out['depth_ray'][0, :, 0]
    np.testing.assert_array_equal(S.colorize_depth(depth),
                                  JS.colorize_depth(depth))


def test_params_io_reads_jax_files(tmp_path):
    """A file written by the JAX package's save_params loads into the port
    as params_from_jax of the same tree."""
    model = JaxRenderer(**MODEL)
    scene = jax_scene(0, batch=1, n_view=2, H=64, W=64, n_rays=16)
    params = random_flax_params(model, 3, scene)
    path = str(tmp_path / 'jax.npz')
    jax_params_io.save_params(path, params)
    got = params_io.load_params(path)
    want = params_from_jax(params)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    CrossAttentionRenderer(device='cpu', **MODEL).load_state_dict(
        got, strict=True)
