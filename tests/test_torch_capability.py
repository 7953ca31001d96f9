"""The port's capability tools, learning-rate schedule and package exports
against the JAX package's, on the CPU.

* ``warmup_cosine_decay_schedule`` against optax's at every step of three
  shapes (a 1-step warmup, the tool's min(300, steps // 10), a decay that
  ends before the run): within 1e-7 relative of optax evaluated in 64-bit
  mode (the same formula: they agree to the last bit), and within 4 f32
  ulps of the peak of optax in its default f32 (whose ``1 + cos`` cancels
  near the end of the decay, 8e-3 relative at a 4,000-step run's last
  step; 2.4 ulps measured).
* ``capability_run.run``: three steps of the ``tiny`` config from JAX's
  weights (``random_flax_params``, ``params_from_jax``), a warmup of 2,
  the same ``batch_scene`` draws (both tools' ``BATCH``, ``N_RAYS`` and
  world size ``H`` = ``W`` cut to 2, 32 and 32), against the JAX tool's
  loop run in 64-bit mode (see ``jax_run``: JAX's f32 CPU gradients are
  the less accurate side): losses and gradient norms within
  test_torch_train.py's ``STEP_RTOL`` (1e-4), the held-out PSNR within
  0.01 dB; the first step leaves every parameter as it was (lr(0) = 0);
  the saved file holds the best parameters.
* ``fit`` resumed from a checkpoint takes the schedule at the counts an
  uninterrupted run takes it, with the same losses.
* ``eval_pruned``'s seven renderers on the first 256 rays of one unseen
  boxes world (cut to 32x32) at the ``tiny`` config, from JAX's weights
  and JAX's pyramid, against the JAX tool's, with test_torch_fast_eval.py's tolerances
  (``torch_fast_cases.LEVER_RTOL``): dense, uniform and pruned 1e-4,
  narrow and q8 2.5e-4, narrow+pruned 2.5e-4 (narrow's), all three 1e-3;
  each beside an absolute 1e-4.
* ``write_png`` reads back equal through imageio; ``clone(npoints=n)``
  renders as a model built with ``npoints=n`` on the same weights,
  exactly; every name of the JAX subpackages' ``__all__`` resolves in the
  port's counterpart.
"""

import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.train import evaluation as JE
from cross_attention_renderer_tpu.train import trainer as JT
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.tools import capability_run as CR
from cross_attention_renderer_torch.tools import eval_pruned as EP
from cross_attention_renderer_torch.train import trainer as T
from cross_attention_renderer_torch.utils.image import write_png
from cross_attention_renderer_torch.utils.params_io import load_params
from torch_fast_cases import LEVER_RTOL
from torch_parity import assert_close, random_flax_params

JCR = importlib.import_module('tools.capability_run')
STEP_RTOL = 1e-4        # test_torch_train.py's
PSNR_TOL = 0.01         # dB
SCHEDULE_RTOL = 1e-7
F32_ULPS = 4 * 2.0 ** -24
BATCH, N_RAYS, WORLDS, HW = 2, 32, 6, 32
LR = 2.5e-4
MODE_RTOL = {'dense': 1e-4, 'uniform_fine': 1e-4,
             'pruned': LEVER_RTOL['pruned'], 'narrow': LEVER_RTOL['narrow'],
             'q8': LEVER_RTOL['q8'], 'narrow+pruned': LEVER_RTOL['narrow'],
             'all(n+p+q8)': LEVER_RTOL['fast']}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tool_constants_match_jax():
    assert (CR.H, CR.W, CR.BATCH, CR.N_RAYS) == (JCR.H, JCR.W, JCR.BATCH,
                                                 JCR.N_RAYS)
    assert CR.CONFIGS == JCR.CONFIGS
    assert CR.HELD_OUT == 100003


# (warmup, decay, steps evaluated)
SCHEDULES = {'warmup_1': (1, 40, 45),
             'tool_4000': (min(300, 4000 // 10), 4000, 4010),
             'decay_before_end': (10, 60, 100)}


@pytest.mark.parametrize('name', sorted(SCHEDULES))
def test_schedule_matches_optax(name):
    warmup, decay, n = SCHEDULES[name]
    got = CR.warmup_cosine_decay_schedule(0.0, LR, warmup, decay)
    got = np.array([got(i) for i in range(n)])
    ref = optax.warmup_cosine_decay_schedule(0.0, LR, warmup_steps=warmup,
                                             decay_steps=decay)
    with jax.enable_x64(True):
        want64 = np.array([float(ref(i)) for i in range(n)])
    want32 = np.array([float(ref(i)) for i in range(n)])
    np.testing.assert_allclose(got, want64, rtol=SCHEDULE_RTOL, atol=0)
    np.testing.assert_allclose(got, want32, rtol=0, atol=F32_ULPS * LR)
    assert got[0] == 0.0 and got[warmup] == LR
    if name == 'decay_before_end':
        assert (got[decay:] == 0.0).all()


def test_tool_schedule_shape():
    """min(300, max(1, steps // 10)) warmup steps, decay to the run's
    end."""
    for steps, warmup in ((3, 1), (1500, 150), (6000, 300)):
        s = CR.lr_schedule(steps, LR)
        assert s(warmup) == LR and s(warmup - 1) < LR
        assert s(steps) == 0.0


# ---------------------------------------------------------------------------
# Three tool steps against the JAX tool's loop.
# ---------------------------------------------------------------------------

def _tiny_jax_model():
    return JaxRenderer(n_view=2, **JCR.CONFIGS['tiny'], dtype=jnp.float32)


def _to_flax(state: dict, template: dict) -> dict:
    """The port's parameters as a Flax tree shaped like ``template``
    (``params_from_jax`` inverted through a tree of element indices)."""
    leaves, tree = jax.tree.flatten(template)
    sizes = [np.asarray(x).size for x in leaves]
    starts = np.cumsum([0] + sizes)
    index = params_from_jax(jax.tree.unflatten(tree, [
        np.arange(a, a + n, dtype=np.float64).reshape(np.shape(x))
        for a, n, x in zip(starts, sizes, leaves)]))
    flat = np.zeros(starts[-1], np.float64)
    for k, v in state.items():
        flat[index[k].numpy().reshape(-1).astype(np.int64)] = (
            v.double().numpy().reshape(-1))
    return jax.tree.unflatten(tree, [
        flat[a:a + n].reshape(np.shape(x))
        for a, n, x in zip(starts, sizes, leaves)])


def _f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)),
                        tree)


@pytest.fixture(scope='module')
def jax_run():
    """The JAX tool's protocol (``main``) for 3 steps, its batch cut to
    BATCH x N_RAYS, its worlds to HW x HW, and a warmup of 2: weights drawn by
    ``random_flax_params`` from the shapes of its first batch (in place of
    its ``create_train_state``, which compiles ``model.init``), then its
    train steps and held-out render in 64-bit mode (the model, weights,
    scenes, Adam and the schedule in f64): the reference the port's f32
    run is held to. JAX's f32 CPU gradients are the less accurate side:
    at the tool's own initial weights (Flax's initialisers) they are off
    its f64 gradients by up to 1.2e-2 of a tensor's largest entry in the
    DPT fusion (``layer2_rn``, ``refinenet2.rcu1``,
    ``refinenet3.out_conv``), where the port's f32 gradients are within
    1.6e-6, and Adam's first steps (lr * sign(g) an element) carry such
    differences into the third step's loss and gradient norm. Returns
    (the f32 weights, [(loss, grad_norm, psnr)])."""
    mp = pytest.MonkeyPatch()
    for name, value in (('BATCH', BATCH), ('N_RAYS', N_RAYS), ('H', HW),
                        ('W', HW)):
        mp.setattr(JCR, name, value)
    try:
        rng = np.random.default_rng(0)
        worlds = [JCR.load_world(s, 'plane') for s in range(WORLDS)]
        held_out = JCR.load_world(100003, 'plane')
        gt = np.asarray(held_out['query']['rgb'], np.float32)
        params = random_flax_params(_tiny_jax_model(), 0,
                                    JCR.batch_scene(worlds, rng))
        rows = []
        with jax.enable_x64(True):
            model = JaxRenderer(n_view=2, **JCR.CONFIGS['tiny'],
                                dtype=jnp.float64)
            cfg = JT.TrainConfig(lr=optax.warmup_cosine_decay_schedule(
                0.0, LR, warmup_steps=2, decay_steps=3))
            state = JT.TrainState.create(apply_fn=model.apply,
                                         params=_f64(params),
                                         tx=JT.make_optimizer(cfg))
            step = JT.make_train_step(model, cfg)
            render = jax.jit(lambda p, s: model.apply(p, s)['rgb'])
            held_out = _f64(held_out)
            batches = []
            for _ in range(3):
                batches.append(_f64(JCR.batch_scene(worlds, rng)))
                state, m = step(state, batches[-1])
                pred = np.asarray(render(state.params, held_out),
                                  np.float32)
                rows.append((float(m['total_loss']), float(m['grad_norm']),
                             JCR.psnr(pred, gt)))

            def grad_norm_at(port_params, i):
                """JAX's f64 gradient norm of step i's batch at the
                port's parameters (the same compiled step)."""
                with jax.enable_x64(True):
                    s = JT.TrainState.create(
                        apply_fn=model.apply,
                        params=_f64(_to_flax(port_params, params)),
                        tx=JT.make_optimizer(cfg))
                    return float(step(s, batches[i])[1]['grad_norm'])
    finally:
        mp.undo()
    return params, rows, grad_norm_at


def _port_tools(monkeypatch, params):
    for name, value in (('BATCH', BATCH), ('N_RAYS', N_RAYS), ('H', HW),
                        ('W', HW)):
        monkeypatch.setattr(CR, name, value)

    def build_model(config, dtype, device):
        assert (config, dtype) == ('tiny', 'f32')
        m = CrossAttentionRenderer(n_view=2, **CR.CONFIGS['tiny'],
                                   device=device)
        m.load_state_dict(params_from_jax(params), strict=True)
        return m

    monkeypatch.setattr(CR, 'build_model', build_model)


def test_capability_run_tracks_jax(jax_run, monkeypatch, tmp_path):
    """Three steps against JAX's; the first step (lr(0) = 0) leaves every
    parameter as it was; --save writes the best parameters and --out the
    strip.

    Steps 1 and 2 start from the same weights on both sides. Step 2's
    update (lr(1), Adam's first nonzero one, lr * m / sqrt(v) an element)
    moves every element by about lr whatever its gradient's size, so the
    few elements whose gradient lies within f32 rounding of 0 (4 of 2.9M,
    in the ResNet stem's weight-standardised convolutions) move by up to
    a step in directions the rounding picks: the third step's gradient
    norm is then 0.4% apart from JAX's f64 run (JAX's own f32 run: 0.04%),
    while JAX's f64 gradient at the port's own weights equals the port's
    (5e-7). So step 3's loss is held to JAX's run and its gradient norm to
    JAX's at the port's weights, both within STEP_RTOL."""
    params, want, grad_norm_at = jax_run
    _port_tools(monkeypatch, params)
    monkeypatch.setattr(CR, 'lr_schedule', lambda steps, lr: (
        CR.warmup_cosine_decay_schedule(0.0, lr, 2, 3)))
    after = {}
    make_step = CR.make_train_step

    def recording_step(model, cfg):
        step = make_step(model, cfg)

        def wrapped(state, scene):
            state, metrics = step(state, scene)
            if state.step in (1, 2):
                after[state.step] = CR.snapshot(model)
            return state, metrics
        return wrapped

    monkeypatch.setattr(CR, 'make_train_step', recording_step)
    out = CR.run('tiny', 'plane', WORLDS, steps=3, eval_every=1, lr=LR,
                 dtype='f32', device='cpu', save=str(tmp_path / 'p.npz'),
                 out=str(tmp_path / 'demo.png'), log=lambda *a: None)
    curve = out['curve']
    assert [r['step'] for r in curve] == [1, 2, 3]
    np.testing.assert_allclose([r['loss'] for r in curve],
                               [w[0] for w in want], rtol=STEP_RTOL)
    np.testing.assert_allclose(
        [r['grad_norm'] for r in curve],
        [want[0][1], want[1][1], grad_norm_at(after[2], 2)],
        rtol=STEP_RTOL)
    np.testing.assert_allclose([r['psnr'] for r in out['curve']],
                               [w[2] for w in want], atol=PSNR_TOL, rtol=0)
    assert np.isfinite(out['pred']).all()

    init = params_from_jax(params)
    assert after[1].keys() == init.keys()
    for k, v in after[1].items():
        assert torch.equal(v, init[k]), k
    assert out['best_psnr'] == max(r['psnr'] for r in out['curve'])
    best = out['model'].state_dict()
    saved = load_params(str(tmp_path / 'p.npz'))
    assert all(torch.equal(saved[k], best[k]) for k in best)
    assert (tmp_path / 'demo.png').stat().st_size > 0


def test_resumed_fit_takes_the_schedule_at_the_same_counts(tmp_path):
    """4 straight steps against 2 steps, a checkpoint, then a fresh model
    resumed from it: the same losses, the schedule read at the same
    update counts."""
    small = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
                 vit_heads=2, resnet_layers=(1, 1, 1))
    scene = make_scene(0, H=32, W=32, n_rays=16, device='cpu')
    calls = []

    def schedule(count):
        calls.append(count)
        return 1e-3 * (count + 1) / 4

    cfg = T.TrainConfig(lr=schedule, steps_til_summary=2,
                        iters_til_checkpoint=10 ** 6)

    def fit(steps, seed, ckpt_dir=None, log=None):
        return T.fit(CrossAttentionRenderer(device='cpu', seed=seed,
                                            **small), cfg,
                     itertools.repeat(scene), steps, ckpt_dir=ckpt_dir,
                     log_fn=lambda i, m: log.append(float(m['total_loss'])))

    ref = []
    fit(4, 0, log=ref)
    assert calls == [0, 1, 2, 3]
    calls.clear()
    first, second = [], []
    fit(2, 0, tmp_path, first)
    state = fit(4, 5, tmp_path, second)
    assert state.step == 4 and state.optimizer.count == 4
    assert calls == [0, 1, 2, 3]
    assert first + second == ref


# ---------------------------------------------------------------------------
# eval_pruned's renderers against the JAX tool's.
# ---------------------------------------------------------------------------

def test_eval_pruned_modes_match_jax(monkeypatch):
    """The seven modes on the first 256 rays of a 32x32 unseen world."""
    for tool in (JCR, CR):
        monkeypatch.setattr(tool, 'H', HW)
        monkeypatch.setattr(tool, 'W', HW)
    pruned, narrow, chunks = (8, 8), (16, 16, 64), 4
    jmodel = _tiny_jax_model()
    jscene = jax.tree.map(jnp.asarray, JCR.load_world(200000, 'boxes'))
    params = random_flax_params(jmodel, 1, jscene)
    jz = jax.jit(lambda p, s: jmodel.apply(p, s, method='encode'))(
        params, jscene)
    uv_j = jscene['query']['uv'][:, :, :256]
    jax_modes = {
        'dense': JE.make_scan_renderer(jmodel, chunks),
        'uniform_fine': JE.make_scan_renderer(
            jmodel.clone(npoints=pruned[1]), chunks),
        'pruned': JE.make_pruned_renderer(jmodel, chunks, *pruned),
        'narrow': JE.make_fast_renderer(jmodel, chunks, narrow=narrow),
        'q8': JE.make_fast_renderer(jmodel, chunks, q8=True),
        'narrow+pruned': JE.make_fast_renderer(jmodel, chunks,
                                               pruned=pruned, narrow=narrow),
        'all(n+p+q8)': JE.make_fast_renderer(jmodel, chunks, pruned=pruned,
                                             narrow=narrow, q8=True)}

    model = CrossAttentionRenderer(n_view=2, **CR.CONFIGS['tiny'],
                                   device='cpu').eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    scene = CR.to_scene(CR.load_world(200000, 'boxes'), 'cpu')
    z = tuple(torch.from_numpy(np.array(x)) for x in jz)
    uv = scene['query']['uv'][:, :, :256]
    renders = EP.renderers(model, chunks, pruned, narrow)
    assert list(renders) == list(jax_modes)
    for name, render in renders.items():
        rgb, _ = render(scene, z, uv)
        rgb_j, _ = jax_modes[name](params, jscene, jz, uv_j)
        assert_close(name, rgb, rgb_j, atol=1e-4, rtol=MODE_RTOL[name])


# ---------------------------------------------------------------------------
# Round trips and exports.
# ---------------------------------------------------------------------------

def test_write_png_reads_back(tmp_path):
    imageio = pytest.importorskip('imageio.v2')
    img = np.random.default_rng(0).integers(0, 256, (17, 33, 3),
                                            dtype=np.uint8)
    write_png(tmp_path / 'a.png', img)
    np.testing.assert_array_equal(imageio.imread(tmp_path / 'a.png'), img)
    with pytest.raises(ValueError, match='uint8'):
        write_png(tmp_path / 'b.png', img.astype(np.float32))


def test_clone_npoints_renders_as_a_built_model():
    kw = dict(CR.CONFIGS['tiny'], npoints=16)
    model = CrossAttentionRenderer(device='cpu', **kw).eval()
    built = CrossAttentionRenderer(device='cpu', **dict(kw, npoints=8),
                                   seed=3).eval()
    built.load_state_dict(model.state_dict())
    clone = model.clone(npoints=8)
    assert (clone.n_samples, model.n_samples) == (8, 16)
    assert all(a is b for a, b in zip(clone.parameters(),
                                      model.parameters()))
    scene = make_scene(2, H=32, W=32, n_rays=24, device='cpu')
    with torch.inference_mode():
        got, want = clone(scene), built(scene)
    assert got['at_wt'].shape[-1] == 8
    for k in ('rgb', 'at_wt', 'depth_ray'):
        assert torch.equal(got[k], want[k]), k


SUBPACKAGES = ('geometry', 'models', 'train', 'ops', 'ops.experimental',
               'losses', 'encoders', 'data', 'utils', 'pose', 'parallel')


@pytest.mark.parametrize('sub', SUBPACKAGES)
def test_exports_match_jax(sub):
    jax_pkg = importlib.import_module(f'cross_attention_renderer_tpu.{sub}')
    port = importlib.import_module(f'cross_attention_renderer_torch.{sub}')
    missing = [n for n in jax_pkg.__all__ if not hasattr(port, n)]
    assert not missing, missing
    assert set(jax_pkg.__all__) <= set(port.__all__)
