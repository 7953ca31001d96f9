"""The port's parallel layer against the JAX package's, on the CPU.

* The tensor-parallel rules: for every parameter of the TINY tree and of
  the flagship tree (its shapes from ``jax.eval_shape``), JAX's
  ``param_spec`` and the port's agree through ``convert.py``'s key map and
  layouts: an array holding, at every element, the model rank that owns
  it under JAX's spec, converted as ``params_from_jax`` converts the
  parameter, is owned the same way under the port's spec (rank r's slice
  holds r alone), and a parameter JAX replicates the port replicates.
  ``shard_tensor``'s slices, concatenated over the ranks, are the whole
  parameter.
* The single-process passthrough (JAX tests/test_multihost.py:27-45): no
  process group, the 1x1x1 mesh, every helper the identity.
* Four gloo processes, DP 2 x TP 2 (``tools/multihost_smoke.py`` through
  ``torch_parallel_cases.py``; TINY, global batch 8, lr 1e-3, two steps,
  the same random weights as JAX's through ``params_from_jax``): the four
  ranks print the same MHOK line; it equals the port's single-process
  step on the global batch (losses rtol 1e-5, ``phi.lin_out`` atol 1e-5:
  JAX tests/test_train.py:109-127's mesh-vs-single tolerances) and JAX's
  single-device step (loss0 rtol 1e-5, loss1 and the checksum rtol 2e-4,
  tests/test_multihost.py:119).
* The sharded resume, in the same processes: 2 steps, a checkpoint, a
  resumed run to step 4, against an uninterrupted 4-step run (rtol 1e-6:
  the same arithmetic); the restored state holds the rank's slices of
  the whole checkpoint (JAX tests/test_train.py:168-210).
* Two gloo processes at rays = 2: ``make_sharded_renderer``'s gathered
  image against the port's ``make_chunk_renderer`` of all rays (1e-6) and
  against JAX's chunk renderer on the same weights (1e-4 + 1e-4 max(1,
  |JAX|), tests/test_torch_renderer.py's tolerance).
* ``cli.train`` in 2 processes with ``--tensor_parallel 2`` on a 2-scene
  corpus (tests/test_torch_cli.py's), 2 steps: both ranks log the same
  losses, only the primary writes checkpoints, and the val summary
  renders on both ranks (through the fused exchange, on the gathered
  weights) and is written by the primary.
* The fused kernels under tensor parallelism. Two gloo processes at
  model = 2 render through K2, K4 and K9 (their plain versions here) on
  the sliced exchange weights gathered over the model group: each image
  equals one process's (1e-5) and JAX's fused render (1e-4 + 1e-4
  max(1, |JAX|)). Four processes, DP 2 x TP 2, take one
  ``CAR_TRAIN_KERNELS=1`` step: its loss and gradient norm equal one
  process's (1e-5), and each sliced exchange weight's gradient equals
  its slice of the one-process gradient (1e-5 of its largest entry);
  the same step with the gather's backward summed over the model group
  (a reduce-scatter) fails that comparison.

The fourteen rank processes start together when the module's first test
needs them, each in one intra-op thread with a 180 s timeout.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.parallel import mesh as JM
from cross_attention_renderer_tpu.train import evaluation as JE
from cross_attention_renderer_tpu.train import trainer as JT
from cross_attention_renderer_torch import parallel as PP
from cross_attention_renderer_torch.convert import (
    convert_leaf, params_from_jax)
from cross_attention_renderer_torch.data import realestate as PR
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.parallel import mesh as M
from cross_attention_renderer_torch.tools import make_corpus as PM
from cross_attention_renderer_torch.tools import multihost_smoke as MH
from cross_attention_renderer_torch.train import evaluation as E
from cross_attention_renderer_torch.train import trainer as T
from torch_parallel_cases import (EXCHANGE_SLICED, FRAME_HW, FUSED_ROUTES,
                                  RENDER_HW, TINY)
from torch_parity import assert_close, random_flax_params

ROOT = Path(__file__).resolve().parents[1]
MODEL = dict(n_view=2, npoints=8, **TINY)
TIMEOUT = 180
STEP_RTOL = 1e-5
LIN_OUT_ATOL = 1e-5
JAX_LOSS0_RTOL = 1e-5
JAX_RTOL = 2e-4
RESUME_RTOL = 1e-6
SHARDED_ATOL = 1e-6
RENDER_TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def jax_params():
    model = JaxRenderer(**MODEL)
    return random_flax_params(model, 0, jax_scene(0, batch=1, n_view=2,
                                                  H=64, W=64, n_rays=16))


@pytest.fixture(scope='module')
def runs(tmp_path_factory, jax_params):
    """Starts every multi-process case at once: {case: (out dir,
    [Popen a rank])}; the ranks are killed at the module's end."""
    out = tmp_path_factory.mktemp('parallel')
    torch.save(params_from_jax(jax_params), out / 'weights.pt')
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, 'IMG_H', FRAME_HW[0])
        mp.setattr(PR, 'IMG_W', FRAME_HW[1])
        mp.setattr(PR, 'CROP', FRAME_HW[0])
        mp.setattr(PM, 'H', FRAME_HW[0])
        mp.setattr(PM, 'W', FRAME_HW[1])
        PM.main(['--root', str(out / 'corpus'), '--scenes', '2',
                 '--defects', '0', '--seed_base', '1'])
    env = dict(os.environ, PYTHONPATH=f'{ROOT}:{ROOT / "tests"}',
               OMP_NUM_THREADS='1')
    procs = {}
    for case, world in (('train', 4), ('render', 2), ('cli', 2),
                        ('fused', 2), ('kernels', 4)):
        port = _free_port()
        procs[case] = (out, [subprocess.Popen(
            [sys.executable, str(ROOT / 'tests' / 'torch_parallel_cases.py'),
             case, str(rank), str(world), str(port), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=ROOT, env=env) for rank in range(world)])
    yield procs
    for _, ps in procs.values():
        for p in ps:
            p.kill()
            p.wait()


def _outputs(runs, case) -> list[str]:
    """Each rank's output, once all have exited 0."""
    _, procs = runs[case]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=TIMEOUT)
        assert p.returncode == 0, out[-4000:]
        outs.append(out)
    return outs


def _line(out: str, key: str) -> str:
    return next(l for l in out.splitlines() if l.startswith(key + ' '))[
        len(key) + 1:]


# --- four ranks: DP 2 x TP 2 -------------------------------------------------

def _global_scenes():
    return [make_scene(s, batch=MH.GLOBAL_BATCH, n_view=2, H=64, W=64,
                       n_rays=16, device='cpu') for s in (0, 1)]


def _one_process(jax_params, scenes):
    """The port's single-process steps on ``scenes`` from JAX's weights:
    (each step's metrics, the model)."""
    model = CrossAttentionRenderer(device='cpu', **MODEL)
    model.load_state_dict(params_from_jax(jax_params))
    cfg = T.TrainConfig(lr=MH.LR)
    state = T.create_train_state(model, cfg)
    step = T.make_train_step(model, cfg)
    return [{k: float(v) for k, v in step(state, s)[1].items()}
            for s in scenes], model


def test_dp_tp_ranks_agree_with_jax(runs, jax_params):
    """First of the module's tests: the ranks start, and JAX's steps
    compile while they run."""
    model = JaxRenderer(**MODEL)
    cfg = JT.TrainConfig(lr=MH.LR)
    state = JT.TrainState.create(apply_fn=model.apply, params=jax_params,
                                 tx=JT.make_optimizer(cfg))
    step = JT.make_train_step(model, cfg)
    losses = []
    for s in (0, 1):
        state, m = step(state, jax_scene(s, batch=MH.GLOBAL_BATCH, n_view=2,
                                         H=64, W=64, n_rays=16))
        losses.append(float(m['total_loss']))
    k = np.asarray(state.params['params']['phi']['lin_out']['kernel'])
    checksum = float(np.sum(k.astype(np.float32) ** 2))
    got = [float(x) for x in _line(_outputs(runs, 'train')[0],
                                   'MHOK').split()]
    np.testing.assert_allclose(got[0], losses[0], rtol=JAX_LOSS0_RTOL)
    np.testing.assert_allclose(got[1:], [losses[1], checksum], rtol=JAX_RTOL)


def test_dp_tp_ranks_agree_with_one_process(runs, jax_params):
    """The losses, the checksum and the gradient norms (the clip's global
    norm of the whole gradient, the sliced parts summed over the model
    group) against one process's steps on the global batch."""
    outputs = _outputs(runs, 'train')
    lines = [_line(o, 'MHOK') for o in outputs]
    assert len(set(lines)) == 1, lines
    got = [float(x) for x in lines[0].split()]
    metrics, model = _one_process(jax_params, _global_scenes())
    checksum = float((model.phi.lin_out.weight.detach() ** 2).sum())
    np.testing.assert_allclose(
        got, [m['total_loss'] for m in metrics] + [checksum], rtol=STEP_RTOL)
    norms = [json.loads(_line(o, 'NORMS')) for o in outputs]
    assert all(n == norms[0] for n in norms)
    np.testing.assert_allclose(norms[0], [m['grad_norm'] for m in metrics],
                               rtol=STEP_RTOL)


def test_dp_tp_lin_out_equals_one_process(runs, jax_params):
    """phi.lin_out after two steps of the four ranks, element by element:
    the resume case's checkpoint holds the whole state after 2 steps on one
    repeated scene, against one process's 2 steps on that scene."""
    out, _ = runs['train']
    _outputs(runs, 'train')
    whole = torch.load(out / 'ckpt' / 'current.pt', weights_only=True)
    scene = _global_scenes()[0]
    _, model = _one_process(jax_params, [scene, scene])
    assert whole['step'] == 2
    np.testing.assert_allclose(whole['params']['phi.lin_out.weight'].numpy(),
                               model.phi.lin_out.weight.detach().numpy(),
                               atol=LIN_OUT_ATOL)


def test_sharded_resume_continues_trajectory(runs):
    results = [json.loads(_line(o, 'RESUME'))
               for o in _outputs(runs, 'train')]
    for r in results:
        assert r['step'] == 4 and r['restored_step'] == 2
        assert r['restored_slices'] and r['sliced'] > 0
        np.testing.assert_allclose(r['losses'], r['ref'], rtol=RESUME_RTOL)
    assert all(r['losses'] == results[0]['losses'] for r in results)


# --- two ranks: the ray-sharded render ---------------------------------------

def test_sharded_render_equals_the_chunk_render(runs, jax_params):
    out, _ = runs['render']
    _outputs(runs, 'render')
    ranks = [np.load(out / f'render{r}.npz') for r in range(2)]
    for k in ('rgb', 'valid'):
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
    rgb, valid = ranks[0]['rgb'], ranks[0]['valid']
    n = RENDER_HW * RENDER_HW
    assert rgb.shape == (1, 1, n, 3) and valid.shape == (1, n, 1)

    model = CrossAttentionRenderer(device='cpu', **MODEL)
    model.load_state_dict(params_from_jax(jax_params))
    scene = make_scene(6, H=RENDER_HW, W=RENDER_HW, n_rays=n,
                       full_image=True, device='cpu')
    encode, render_chunk = E.make_chunk_renderer(model)
    want_rgb, want_valid = render_chunk(scene, encode(scene),
                                        scene['query']['uv'])
    np.testing.assert_allclose(rgb, want_rgb.numpy(), atol=SHARDED_ATOL)
    np.testing.assert_allclose(valid, want_valid.numpy(), atol=SHARDED_ATOL)

    jscene = jax_scene(6, H=RENDER_HW, W=RENDER_HW, n_rays=n,
                       full_image=True)
    jmodel = JaxRenderer(fused_epilogue=True, fused_attention=False, **MODEL)
    jencode, jrender = JE.make_chunk_renderer(jmodel, jax_params)
    jrgb, jvalid = jrender(jscene, jencode(jscene), jscene['query']['uv'])
    assert_close('rgb', rgb, np.asarray(jrgb), atol=RENDER_TOL,
                 rtol=RENDER_TOL)
    assert_close('valid', valid, np.asarray(jvalid), atol=RENDER_TOL,
                 rtol=RENDER_TOL)


# --- the fused kernels under tensor parallelism -----------------------------

@pytest.fixture(scope='module')
def fused_want(jax_params):
    """One process's chunk render of the 32x32 image on each fused route,
    and JAX's fused render of it."""
    n = RENDER_HW * RENDER_HW
    scene = make_scene(6, H=RENDER_HW, W=RENDER_HW, n_rays=n,
                       full_image=True, device='cpu')
    want = {}
    for route, kw in FUSED_ROUTES.items():
        model = CrossAttentionRenderer(device='cpu', **MODEL, **kw)
        model.load_state_dict(params_from_jax(jax_params))
        encode, render_chunk = E.make_chunk_renderer(model)
        want[route] = render_chunk(scene, encode(scene),
                                   scene['query']['uv'])
    jscene = jax_scene(6, H=RENDER_HW, W=RENDER_HW, n_rays=n,
                       full_image=True)
    jmodel = JaxRenderer(fused_epilogue=True, fused_attention=False, **MODEL)
    jencode, jrender = JE.make_chunk_renderer(jmodel, jax_params)
    jrgb, jvalid = jrender(jscene, jencode(jscene), jscene['query']['uv'])
    return want, (np.asarray(jrgb), np.asarray(jvalid))


@pytest.mark.parametrize('route', sorted(FUSED_ROUTES))
def test_fused_kernels_render_under_tensor_parallelism(runs, fused_want,
                                                       route):
    out, _ = runs['fused']
    _outputs(runs, 'fused')
    ranks = [np.load(out / f'fused{r}.npz') for r in range(2)]
    want, (jrgb, jvalid) = fused_want
    for k in ('rgb', 'valid'):
        got = ranks[0][f'{route}_{k}']
        np.testing.assert_array_equal(got, ranks[1][f'{route}_{k}'])
        one = want[route][0 if k == 'rgb' else 1].numpy()
        np.testing.assert_allclose(got, one, atol=1e-5)
        assert_close(k, got, jrgb if k == 'rgb' else jvalid,
                     atol=RENDER_TOL, rtol=RENDER_TOL)


def _kernel_route_one_process(jax_params, monkeypatch):
    """One process's CAR_TRAIN_KERNELS=1 step on the global batch: (loss,
    gradient norm, {name: gradient} of the exchange's sliced weights)."""
    monkeypatch.setenv('CAR_TRAIN_KERNELS', '1')
    model = CrossAttentionRenderer(device='cpu', **MODEL)
    model.load_state_dict(params_from_jax(jax_params))
    cfg = T.TrainConfig(lr=MH.LR)
    _, m = T.make_train_step(model, cfg)(T.create_train_state(model, cfg),
                                         _global_scenes()[0])
    params = dict(model.named_parameters())
    return (float(m['total_loss']), float(m['grad_norm']),
            {n: params[n].grad for n in EXCHANGE_SLICED})


def test_kernel_route_dp_tp_step_equals_one_process(runs, jax_params,
                                                    monkeypatch):
    out, _ = runs['kernels']
    _outputs(runs, 'kernels')
    loss, norm, grads = _kernel_route_one_process(jax_params, monkeypatch)
    specs = PP.param_shardings(CrossAttentionRenderer(device='cpu', **MODEL))

    def slice_matches(got, name, r, prefix):
        want = M.shard_tensor(grads[name], specs[name], _Rank(r, 2))
        tol = 1e-5 * float(want.abs().max())
        return (got[prefix + name].shape == tuple(want.shape)
                and float(np.abs(got[prefix + name] - want.numpy()).max())
                <= tol)

    for r in range(4):
        got = np.load(out / f'kernels{r}.npz')
        mr = int(got['model_rank'])
        np.testing.assert_allclose(float(got['loss']), loss, rtol=1e-5)
        np.testing.assert_allclose(float(got['grad_norm']), norm,
                                   rtol=1e-5)
        for name in EXCHANGE_SLICED:
            assert specs[name], name
            assert slice_matches(got, name, mr, ''), (r, name)
        # a summed backward counts each rank's whole gradient model times
        assert not all(slice_matches(got, name, mr, 'summed_')
                       for name in EXCHANGE_SLICED)


# --- two ranks: the CLI ------------------------------------------------------

def test_train_cli_tensor_parallel(runs):
    out, _ = runs['cli']
    outputs = _outputs(runs, 'cli')
    logs = [json.loads(_line(o, 'CLI')) for o in outputs]
    assert [r['step'] for r in logs[0]] == [0, 1]
    assert logs[0] == logs[1]
    assert all(np.isfinite(r['total_loss']) for r in logs[0])
    written = [sorted(p.name for p in (out / f'rank{r}' / 'tp' /
                                       'checkpoints').glob('*.pt'))
               for r in range(2)]
    assert written == [['current.pt', 'final.pt'], []], written
    # the val summary: both ranks render it on the fused route (each
    # holds a slice of the model), the primary alone prints and writes it
    assert not any('val summary failed' in o for o in outputs)
    if importlib.util.find_spec('tensorboardX') is not None:
        assert 'val_psnr=' in outputs[0] and 'val_psnr=' not in outputs[1]
        assert list((out / 'rank0' / 'tp' / 'summaries').glob('events*'))
        assert not (out / 'rank1' / 'tp' / 'summaries').exists()


# --- the rules ---------------------------------------------------------------

def _owner_array(shape, spec, m) -> np.ndarray:
    """At every element, the rank of ``m`` that owns it under the JAX
    ``spec`` (0 everywhere where it is replicated)."""
    a = np.zeros(shape, np.int8)
    for dim, axis in enumerate(spec):
        if axis == 'model':
            idx = np.arange(shape[dim]) // (shape[dim] // m)
            a += idx.reshape([-1 if d == dim else 1
                              for d in range(len(shape))]).astype(np.int8)
    return a


class _Rank:
    """The model coordinate ``r`` of ``m`` as a mesh's interface reads it."""

    def __init__(self, r, m):
        self.r, self.m = r, m

    def size(self, mesh_dim=None):
        return self.m if mesh_dim == 1 else 1

    def get_local_rank(self, axis):
        return self.r if axis == 'model' else 0


@pytest.mark.parametrize('config', ['tiny', 'flagship'])
def test_rules_match_jax(config):
    kw = MODEL if config == 'tiny' else dict(n_view=2)
    scene = jax_scene(0, batch=1, n_view=2, H=64, W=64, n_rays=16)
    shapes = jax.eval_shape(JaxRenderer(**kw).init, jax.random.PRNGKey(0),
                            scene)['params']
    m = 2
    sharded = 0
    for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        path = tuple(k.key for k in kp)
        jspec = JM.param_spec('params/' + '/'.join(path), np.empty(
            (1,) * len(leaf.shape)))
        key, owner = convert_leaf(path, _owner_array(leaf.shape, jspec, m))
        spec = PP.param_spec(key, owner)
        assert ('model' in jspec) == ('model' in spec), (key, jspec, spec)
        if 'model' not in spec:
            continue
        sharded += 1
        assert len([a for a in spec if a == 'model']) == 1, (key, spec)
        for r in range(m):
            part = M.shard_tensor(torch.from_numpy(owner), spec, _Rank(r, m))
            assert (part.numpy() == r).all(), (key, spec, r)
    # a ViT block's q/k/v (weights, biases), out, fc1 (weight, bias) and
    # fc2; the 7 RCUs' conv1 (weight, bias) and conv2; the exchange's two
    # pairs; phi's three blocks
    blocks = 2 if config == 'tiny' else 12
    assert sharded == blocks * 10 + 7 * 3 + 6 + 3 * 3


def test_shard_slices_concatenate_to_the_parameter():
    model = CrossAttentionRenderer(device='cpu', **MODEL)
    specs = PP.param_shardings(model)
    assert any(specs.values())
    for name, p in model.named_parameters():
        spec = specs[name]
        parts = [M.shard_tensor(p.detach(), spec, _Rank(r, 2))
                 for r in range(2)]
        if not spec:
            assert all(q is p.detach() or torch.equal(q, p) for q in parts)
            continue
        dim = spec.index('model')
        assert torch.equal(torch.cat(parts, dim), p.detach()), name
    with pytest.raises(ValueError, match='does not divide'):
        M.shard_tensor(torch.zeros(3, 4), ('model', None), _Rank(0, 2))


def test_single_process_passthrough():
    """Every helper degrades to the single-process behaviour."""
    PP.initialize()                       # no-op without a coordinator
    assert PP.is_primary()
    assert PP.process_batch_slice(12) == (0, 12)
    mesh = PP.make_global_mesh(device_type='cpu')
    assert tuple(mesh.shape) == (1, 1, 1)
    assert mesh.mesh_dim_names == ('data', 'model', 'rays')
    assert PP.process_batch_slice(12, mesh) == (0, 12)
    with pytest.raises(AssertionError):
        PP.make_mesh(model=2, device_type='cpu')

    scene = make_scene(0, batch=4, n_view=2, H=64, W=64, n_rays=16,
                       device='cpu')
    g = PP.global_scene(scene, mesh)
    assert torch.equal(g['context']['rgb'], scene['context']['rgb'])
    assert PP.scene_shardings(scene, mesh)['context']['rgb'] == (
        'data', None, None, None, None)
    assert PP.replicated(scene)['query']['uv'] == ()

    # a 1x1x1 mesh step is the plain step
    cfg = T.TrainConfig(lr=1e-3)
    got, want = [], []
    for out, mesh_ in ((got, mesh), (want, None)):
        model = CrossAttentionRenderer(device='cpu', **MODEL)
        state = T.create_train_state(model, cfg)
        if mesh_ is not None:
            state = T.shard_state(state, mesh_)
        step = T.make_train_step(model, cfg, mesh_)
        for _ in range(2):
            state, metrics = step(state, scene)
            out.append(float(metrics['total_loss']))
    assert got == want
    with pytest.raises(ValueError, match='shard_state'):
        T.make_train_step(model, cfg, mesh)(state, scene)
