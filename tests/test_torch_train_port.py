"""The port's training pieces on the CPU, without JAX: the kernels' autograd
Function (each kernel's plain version standing in for it), the layout
cache after optimizer steps, the trainer's checkpoints, resume and guards,
``params_io`` and ``remat``.

Tolerances: the Function's gradients are the plain version's, recomputed on
the same inputs, so they agree to f32 rounding (1e-6 of each tensor's
largest gradient); runs that repeat the same CPU arithmetic are compared
exactly."""

import itertools

import numpy as np
import pytest
import torch

from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models import renderer as RM
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.ops import epipolar_attention as EA
from cross_attention_renderer_torch.ops import fused_mlp as FM
from cross_attention_renderer_torch.ops import fused_render as FR
from cross_attention_renderer_torch.ops import gather_epilogue as GE
from cross_attention_renderer_torch.ops import sorted_gather as SG
from cross_attention_renderer_torch.ops._autograd import kernel_call
from cross_attention_renderer_torch.train import trainer as T
from cross_attention_renderer_torch.utils import params_io
from torch_grad_cases import max_rel_err, outputs_and_grads

TINY = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
            vit_heads=2, resnet_layers=(1, 1, 1))
GRAD_TOL = 1e-6


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The module's training steps in one intra-op thread: the tier-1 run
    puts six test workers on the machine's cores, and a backward pass
    whose thread pool spans them all ran up to 50x slower there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _captured(name, **model_kw):
    """The arguments of the first call of ``renderer.<name>`` in one
    forward of a small CPU model with ``model_kw``."""
    fn, seen = getattr(RM, name), []

    def recorder(*args):
        seen.append(args)
        return fn(*args)

    model = CrossAttentionRenderer(device='cpu', seed=2, **TINY, **model_kw)
    scene = make_scene(2, n_view=model.n_view, H=32, W=32, n_rays=8,
                       device='cpu')
    RM_fn = getattr(RM, name)
    setattr(RM, name, recorder)
    try:
        with torch.no_grad():
            model(scene)
    finally:
        setattr(RM, name, RM_fn)
    return seen[0]


def _gather_args(out_dtype):
    g = torch.Generator().manual_seed(5)
    table = torch.randn(40, 16, generator=g)
    idx = torch.randint(0, 40, (24, 4), generator=g, dtype=torch.int32)
    idx[:3] = idx[:3, :1]       # repeated rows: their gradients add up
    w = torch.rand(24, 4, generator=g)
    return (table, idx, w, out_dtype)


def _attention_args():
    g = torch.Generator().manual_seed(4)
    return tuple(torch.randn(1, 2, 5, 6, d, generator=g)
                 for d in (16, 16, 12))


# (kernel, plain version, how its arguments are made)
KERNELS = {
    'K1': (EA.epipolar_attention_reference, _attention_args),
    'K2': (GE.fused_exchange_epilogue_reference,
           lambda: _captured('fused_exchange_epilogue')),
    'K3': (GE.fused_exchange_epilogue_multi_reference,
           lambda: _captured('fused_exchange_epilogue_multi', n_view=3)),
    'K4': (FR.fused_render_core_reference,
           lambda: _captured('fused_render_core', fused_render=True)),
    'K5': (SG.plain_gather, lambda: _gather_args(torch.bfloat16)),
    'K6': (SG.plain_gather, lambda: _gather_args(torch.float32)),
    'K7': (SG.plain_gather, lambda: _gather_args(torch.float32)),
    'K8': (SG.plain_gather, lambda: _gather_args(torch.float32)),
    'K9': (FM.fused_mlp2_reference,
           lambda: _captured('fused_mlp2', fused_mlp=True,
                             fused_epilogue=False)),
}


@pytest.mark.parametrize('key', sorted(KERNELS))
def test_kernel_function_gradients_equal_plain_autograd(key):
    """kernel_call with the plain version standing in for the kernel: the
    same outputs and, for every floating input (at_wt's cotangent
    included), the gradients of plain autograd. The stand-in runs once a
    forward and never in the backward."""
    plain, make_args = KERNELS[key]
    args = make_args()
    calls = []

    def launch(*a):
        calls.append(1)
        return plain(*a)

    outs, grads = outputs_and_grads(
        lambda *a: kernel_call(launch, plain, *a), args)
    want_outs, want_grads = outputs_and_grads(plain, args)
    assert len(calls) == 1
    assert len(outs) == len(want_outs) and len(grads) == len(want_grads)
    for got, want in zip(outs, want_outs):
        assert torch.equal(got, want)
    for i, (got, want) in enumerate(zip(grads, want_grads)):
        assert (got is None) == (want is None), i
        if want is not None:
            assert max_rel_err(got, want) <= GRAD_TOL, (key, i)
    assert any(g is not None and bool(g.abs().max() > 0) for g in grads)


def test_kernel_call_skips_the_function_without_gradients():
    args = _attention_args()
    out = kernel_call(EA.epipolar_attention_reference,
                      EA.epipolar_attention_reference, *args)
    assert all(o.grad_fn is None for o in out)


@pytest.mark.parametrize('impl', ['foreach', 'fused'])
def test_layout_cache_is_fresh_after_an_adam_step(impl):
    """K2's prepared weights are rebuilt after torch.optim.Adam's step,
    whose fused form bumps no version counter."""
    model = CrossAttentionRenderer(device='cpu', seed=3, **TINY)
    params = model._epilogue_weights()
    before = GE.prepared_weights(params, 2, 'cpu')
    assert GE.prepared_weights(params, 2, 'cpu') is before
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    torch.optim.Adam(model.parameters(), lr=1e-2, **{impl: True}).step()
    after = GE.prepared_weights(params, 2, 'cpu')
    want = GE.layout_stages([p.detach() for p in params], 2)
    assert after is not before
    for got, w, old in zip(after, want, before):
        assert torch.equal(got, w) and not torch.equal(got, old)


def _model(seed=0, **kw):
    return CrossAttentionRenderer(device='cpu', seed=seed, **TINY, **kw)


def _stream(batch=1):
    scene = make_scene(0, batch=batch, H=32, W=32, n_rays=16, device='cpu')
    return itertools.repeat(scene)


def test_fit_requires_lpips_fn():
    with pytest.raises(ValueError, match='lpips_fn'):
        T.fit(_model(), T.TrainConfig(lpips=True), _stream(), max_steps=1)


def test_fit_resumes_the_trajectory(tmp_path):
    """4 straight steps equal 2 steps, a checkpoint, then a fresh model
    resumed from it for 2 more (constant data: fit does not fast-forward
    its iterator, as the reference's loader restarts too)."""
    cfg = T.TrainConfig(lr=1e-3, steps_til_summary=10 ** 6,
                        iters_til_checkpoint=10 ** 6)
    ref = []
    T.fit(_model(), cfg, _stream(), 4,
          log_fn=lambda i, m: ref.append(float(m['total_loss'])))
    first, second = [], []
    state = T.fit(_model(), cfg, _stream(), 2,
                  log_fn=lambda i, m: first.append(float(m['total_loss'])))
    T.save_checkpoint(tmp_path, state, 'current')
    state2 = T.fit(_model(seed=9), cfg, _stream(), 4, ckpt_dir=tmp_path,
                   log_fn=lambda i, m: second.append(
                       float(m['total_loss'])))
    assert state2.step == 4
    assert first + second == ref
    assert (tmp_path / 'final.pt').exists()


def test_fit_checkpoint_cadence_and_val_fn(tmp_path):
    cfg = T.TrainConfig(steps_til_summary=2, iters_til_checkpoint=3)
    seen = []
    T.fit(_model(), cfg, _stream(), 4, ckpt_dir=tmp_path,
          val_fn=lambda state, i: seen.append((state.step, i)))
    assert seen == [(2, 1), (4, 3)]
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ['current.pt', 'final.pt', 'step_000003.pt']


def test_checkpoint_roundtrip(tmp_path):
    cfg = T.TrainConfig()
    model = _model()
    state = T.create_train_state(model, cfg)
    state, _ = T.make_train_step(model, cfg)(state, next(_stream()))
    T.save_checkpoint(tmp_path, state, 'current')
    sd = {k: v.clone() for k, v in model.state_dict().items()}

    fresh = T.create_train_state(_model(seed=7), cfg)
    T.restore_checkpoint(tmp_path, fresh, 'current')
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # as the reference: the optimizer state is not restored by default
    assert fresh.step == 0 and not fresh.optimizer.adam.state

    full = T.restore_checkpoint(tmp_path, T.create_train_state(
        _model(seed=7), cfg), 'current', restore_optimizer=True)
    assert full.step == 1
    want = state.optimizer.state_dict()['state']
    got = full.optimizer.state_dict()['state']
    assert want.keys() == got.keys()
    for k in want:
        for name in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(got[k][name], want[k][name])


def test_train_model_clone_shares_parameters(monkeypatch):
    model = _model()
    monkeypatch.delenv('CAR_TRAIN_KERNELS', raising=False)
    clone = T._train_model(model)
    assert clone is not model
    assert (clone.fused_attention, clone.fused_epilogue) == (False, False)
    assert (model.fused_attention, model.fused_epilogue) == (None, None)
    assert all(a is b for a, b in zip(clone.parameters(),
                                      model.parameters()))
    monkeypatch.setenv('CAR_TRAIN_KERNELS', '1')
    assert T._train_model(model) is model
    monkeypatch.delenv('CAR_TRAIN_KERNELS')
    explicit = _model(fused_epilogue=True)
    assert T._train_model(explicit) is explicit


def test_clip_scales_as_optax():
    """Below the clip the gradients pass; above it they become
    (g / norm) * clip; grad_norm is taken before the clip."""
    for clip, scale in ((10.0, 1.0), (0.5, 0.5 / 5.0)):
        p = torch.nn.Parameter(torch.zeros(2))
        opt = T.make_optimizer([p], T.TrainConfig(lr=0.0, clip_norm=clip))
        p.grad = torch.tensor([3.0, 4.0])
        norm = opt.step()
        assert float(norm) == 5.0
        assert torch.allclose(p.grad, torch.tensor([3.0, 4.0]) * scale)


def test_params_io_roundtrip(tmp_path):
    model = _model(seed=4)
    path = tmp_path / 'p.npz'
    params_io.save_params(str(path), model)
    loaded = params_io.load_params(str(path))
    sd = model.state_dict()
    assert loaded.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(loaded[k], v), k
    other = _model(seed=5)
    other.load_state_dict(loaded)
    assert all(torch.equal(a, b) for a, b in zip(other.parameters(),
                                                 model.parameters()))


def test_remat_gradients_match():
    """Recomputed ViT blocks give the same gradients."""
    scene = make_scene(0, H=32, W=32, n_rays=16, device='cpu')
    grads = []
    for remat in (False, True):
        model = _model(remat=remat)
        loss = (model(scene)['rgb'] - scene['query']['rgb']).abs().mean()
        loss.backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
