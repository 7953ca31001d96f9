"""Training runtime: the train step over a mesh of ranks, checkpoints and
the curriculum loop.

Port of ``cross_attention_renderer_tpu/train/trainer.py``. The optimizer is
the reference's: Adam (lr 5e-5, betas (0.99, 0.999), train_realestate10k.py:
39,93) after a global-norm clip at 1.0 (training.py:130-134), as the JAX
package's ``optax.chain(clip_by_global_norm, adam)``. Checkpoints follow the
reference's "current + milestone" cadence (training.py:82-84,118-120,
233-246) through ``torch.save``.

The model is an ordinary ``nn.Module`` holding its parameters, so the loss
function and the train step close over it, where the JAX ones take a
parameter tree. Entry points run where the model's parameters are (the
card, by default, as everywhere in the port) and move each scene there.

With a mesh (``parallel/``) each rank is one process: :func:`shard_state`
slices the tensor-parallel parameters and Adam's moments to the rank's
``model`` coordinate (the layers then run as Megatron pairs,
``layers.py``), the step averages the gradients and the reported losses
over the ``data`` axis, and the clip's global norm adds the sliced
gradients' squares over ``model``. Checkpoints hold the whole state,
written by the primary rank; each rank slices what it restores.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn

from cross_attention_renderer_torch.losses.lf_loss import LFLoss, total_loss
from cross_attention_renderer_torch.parallel.distributed import (
    all_gather_cat, all_reduce_sum, global_scene, is_primary)
from cross_attention_renderer_torch.parallel.mesh import (
    axis_size, param_shardings, shard_tensor, sharded_dim)
from cross_attention_renderer_torch.utils.profiling import span

Tensor = torch.Tensor


@dataclasses.dataclass
class TrainConfig:
    # a float, or a schedule of the update count, lr(count) (an optax
    # schedule's role: the JAX TrainConfig takes either)
    lr: float | Callable[[int], float] = 5e-5
    beta1: float = 0.99           # train_realestate10k.py:93
    beta2: float = 0.999
    clip_norm: float = 1.0        # training.py:130-132
    depth: bool = False
    lpips: bool = False
    l2_weight: float = 1e-3
    steps_til_summary: int = 1000  # train_realestate10k.py cadence
    epochs_til_checkpoint: int = 1
    iters_til_checkpoint: int = 10000


class ClippedAdam:
    """``optax.chain(clip_by_global_norm(clip), adam(lr, b1, b2))`` over
    torch parameters.

    :meth:`step` takes the global norm of the gradients, scales them as
    optax does (unchanged below ``clip_norm``, else ``(g / norm) *
    clip_norm``; ``clip_grad_norm_`` adds 1e-6 to the norm, which optax
    does not), then takes an Adam step (eps 1e-8 outside the square root,
    as optax's). Parameters without a gradient are skipped, as a zero
    gradient leaves them unchanged under optax. No host synchronisation.

    A callable ``cfg.lr`` is a schedule: each step first sets every
    parameter group's rate to ``lr(count)``, ``count`` being the updates
    already taken (optax's ``scale_by_schedule`` count), so the first
    update takes ``lr(0)``. The count is a Python int, saved with the
    optimizer's state.

    Under tensor parallelism (:func:`shard_state` sets ``model_group`` and
    ``sharded``, one flag a parameter) the norm adds the squares of the
    sliced gradients over the model group and counts the replicated ones
    once: optax's ``global_norm`` of the whole gradient.

    Spans (on only under a profiler): the norm and the scaling under
    ``car.train.clip``, the Adam update under ``car.train.adam``."""

    def __init__(self, params: Iterable[nn.Parameter], cfg: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = float(cfg.clip_norm)
        self.schedule = cfg.lr if callable(cfg.lr) else None
        self.count = 0
        self.model_group = None
        self.sharded = [False] * len(self.params)
        self.adam = torch.optim.Adam(
            self.params, lr=0.0 if self.schedule else float(cfg.lr),
            betas=(cfg.beta1, cfg.beta2), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> Tensor:
        """Clips and applies the gradients; returns their global norm
        before the clip (0-dim f32, on the parameters' device)."""
        with span('car.train.clip'):
            grads = [p.grad for p in self.params if p.grad is not None]
            norms = torch.stack([n.float()
                                 for n in torch._foreach_norm(grads)])
            if self.model_group is None:
                norm = torch.linalg.vector_norm(norms)
            else:
                sliced = torch.tensor(
                    [s for p, s in zip(self.params, self.sharded)
                     if p.grad is not None], device=norms.device)
                sq = norms.square()
                zero = torch.zeros_like(sq)
                norm = torch.sqrt(
                    torch.where(sliced, zero, sq).sum()
                    + all_reduce_sum(torch.where(sliced, sq, zero).sum(),
                                     self.model_group))
            below = norm < self.clip_norm
            one = torch.ones_like(norm)
            torch._foreach_div_(grads, torch.where(below, one, norm))
            torch._foreach_mul_(grads, torch.where(below, one,
                                                   one * self.clip_norm))
        with span('car.train.adam'):
            if self.schedule is not None:
                lr = float(self.schedule(self.count))
                for group in self.adam.param_groups:
                    group['lr'] = lr
            self.adam.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return dict(self.adam.state_dict(), count=self.count)

    def load_state_dict(self, state: dict) -> None:
        state = dict(state)
        self.count = int(state.pop('count', 0))
        self.adam.load_state_dict(state)


def make_optimizer(params: Iterable[nn.Parameter],
                   cfg: TrainConfig) -> ClippedAdam:
    """The clip + Adam of ``cfg`` over ``params``."""
    return ClippedAdam(params, cfg)


@dataclasses.dataclass
class TrainState:
    """The model (its parameters), the optimizer, the step count and the
    mesh :func:`shard_state` placed them on (None: one process)."""
    model: nn.Module
    optimizer: ClippedAdam
    step: int = 0
    mesh: Optional[object] = None


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """Step 0 of ``model``, whose parameters are already initialised (the
    port's models draw them from a seed when built)."""
    return TrainState(model, make_optimizer(model.parameters(), cfg))


def _train_model(model: nn.Module) -> nn.Module:
    """The model the train step runs: a clone with ``fused_attention`` and
    ``fused_epilogue`` False (the plain attention, the unfused exchange)
    when both are ``None``, unless ``CAR_TRAIN_KERNELS=1`` opts in to the
    kernels; otherwise the model itself.

    This is the JAX package's policy (trainer.py:68-86): the kernels'
    gradients recompute the plain forward in the backward anyway, so under
    training they only add a kernel forward. The clone is a shallow copy:
    it shares every parameter and submodule with ``model``."""
    if os.environ.get('CAR_TRAIN_KERNELS', '0') == '1':
        return model
    if (getattr(model, 'fused_attention', None) is None
            and getattr(model, 'fused_epilogue', None) is None):
        clone = copy.copy(model)
        clone.fused_attention = False
        clone.fused_epilogue = False
        return clone
    return model


def model_device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def to_device(tree, device):
    """Every tensor of a nested dict on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def make_loss_fn(model: nn.Module, cfg: TrainConfig,
                 lpips_fn: Optional[Callable] = None,
                 loss_schedules: Optional[dict] = None):
    """``loss_fn(scene, step=0) -> (total, {name: loss})`` of the train
    model (:func:`_train_model`). ``loss_schedules``: optional
    {loss name: fn(step) -> weight}, evaluated at the step (the per-loss
    schedule hooks of training.py:96-107)."""
    model = _train_model(model)
    loss = LFLoss(l2_weight=cfg.l2_weight, depth=cfg.depth,
                  lpips_fn=lpips_fn if cfg.lpips else None)

    def loss_fn(scene: dict, step: int = 0):
        out = model(scene)
        losses = loss(out, scene['query'])
        if loss_schedules:
            losses = {k: (v * loss_schedules[k](step)
                          if k in loss_schedules else v)
                      for k, v in losses.items()}
        return total_loss(losses), losses

    return loss_fn


def make_train_step(model: nn.Module, cfg: TrainConfig, mesh=None,
                    lpips_fn: Optional[Callable] = None,
                    loss_schedules: Optional[dict] = None):
    """``step(state, scene) -> (state, metrics)``: one optimizer step of
    ``state`` (updated in place) on ``scene``. Metrics, 0-dim tensors on
    the card: ``total_loss``, ``grad_norm`` (before the clip) and each
    loss's mean.

    With a mesh, ``state`` comes from :func:`shard_state` on that mesh and
    ``scene`` holds this rank's rows (``parallel.process_batch_slice``);
    the gradients and the reported losses are averaged over the ``data``
    axis, so every rank's step is the step on the global batch. The
    replicated parameters' gradients, which every rank of a model group
    computes whole, are first averaged over that group too: the card's
    atomic adds round them differently on each rank, and the copies must
    not drift apart. On the kernel route (``CAR_TRAIN_KERNELS=1``) at
    ``model`` > 1 the fused exchange reads the sliced weights gathered
    over the model group, and each rank keeps its slice of their gradient
    (``layers.gather_from_group``).

    Spans (on only under a profiler): the step under ``car.train.step``,
    the loss under ``car.train.forward``, the backward pass under
    ``car.train.backward`` (the kernels autograd's thread launches while
    it is open are its), the optimizer's under :class:`ClippedAdam`'s."""
    loss_fn = make_loss_fn(model, cfg, lpips_fn, loss_schedules)
    device = model_device(model)
    data_group = None if mesh is None else mesh.get_group('data')
    model_group = (None if mesh is None or axis_size(mesh, 'model') == 1
                   else mesh.get_group('model'))

    def step(state: TrainState, scene: dict) -> tuple[TrainState, dict]:
        if state.mesh is not mesh:
            raise ValueError('the step was built for another mesh than the '
                             'state\'s: shard_state(state, mesh) first')
        with span('car.train.step'):
            if mesh is not None:
                scene = global_scene(scene, mesh)
            state.optimizer.zero_grad()
            with span('car.train.forward'):
                tot, losses = loss_fn(to_device(scene, device), state.step)
            with span('car.train.backward'):
                tot.backward()
            opt = state.optimizer
            if model_group is not None:
                _average_gradients([p for p, s in zip(opt.params,
                                                      opt.sharded)
                                    if not s], model_group)
            if data_group is not None:
                _average_gradients(opt.params, data_group)
            gnorm = opt.step()
            state.step += 1
            means = {'total_loss': tot.detach()}
            means.update({k: v.detach().mean() for k, v in losses.items()})
            if data_group is not None:
                summed = all_reduce_sum(
                    torch.stack([v.float() for v in means.values()]),
                    data_group)
                means = dict(zip(means, (summed / dist.get_world_size(
                    data_group)).unbind()))
            metrics = {'total_loss': means.pop('total_loss'),
                       'grad_norm': gnorm}
            metrics.update(means)
            return state, metrics

    return step


def _average_gradients(params: list, group) -> None:
    """Every gradient replaced by its mean over ``group``, in one
    all-reduce of the gradients laid end to end."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    torch._foreach_copy_(grads, [t.view_as(g) for t, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def shard_state(state: TrainState, mesh) -> TrainState:
    """Places ``state`` on ``mesh``: each rank keeps its ``model``
    coordinate's slices (``parallel.param_spec``) of the parameters and of
    Adam's moments, and each layer of a Megatron pair takes its role
    (``layers.py``). Every rank holds the same whole state before (the
    same seed, or the same checkpoint). With ``model`` = 1 nothing is
    sliced. Returns ``state``, changed in place."""
    if state.mesh is mesh:
        return state
    if state.mesh is not None:
        raise ValueError('the state is already sharded on another mesh')
    state.mesh = mesh
    if axis_size(mesh, 'model') == 1:
        return state
    group = mesh.get_group('model')
    model, opt = state.model, state.optimizer
    specs = param_shardings(model)
    moments = opt.adam.state
    sliced = set()
    for name, p in model.named_parameters():
        if sharded_dim(specs[name]) is None:
            continue
        sliced.add(id(p))
        with torch.no_grad():
            p.data = shard_tensor(p.data, specs[name], mesh)
        for k, v in moments.get(p, {}).items():
            if k in ('exp_avg', 'exp_avg_sq'):
                moments[p][k] = shard_tensor(v, specs[name], mesh)
    for name, mod in model.named_modules():
        if not hasattr(mod, 'tp'):
            continue
        weight = 'kernel' if hasattr(mod, 'kernel') else 'weight'
        dim = sharded_dim(specs[f'{name}.{weight}'])
        if dim is None:
            continue
        # Dense and Conv weights are (out, in, ...), a SplitDense kernel
        # (in, out): the output dimension sliced is a column-parallel layer
        mode = 'column' if dim == (1 if weight == 'kernel' else 0) else 'row'
        bias = getattr(mod, 'bias', None)
        if bias is not None and (id(bias) in sliced) != (mode == 'column'):
            raise ValueError(f'{name}: the bias of a {mode}-parallel layer '
                             'must be sliced as its output features are')
        mod.tp = (mode, group)
    opt.model_group = group
    opt.sharded = [id(p) in sliced for p in opt.params]
    return state


# ---------------------------------------------------------------------------
# Checkpoints: "current + milestone" cadence like training.py.
# ---------------------------------------------------------------------------

def checkpoint_path(ckpt_dir: str | Path, name: str) -> Path:
    return Path(ckpt_dir) / f'{name}.pt'


def _sliced(state: TrainState) -> bool:
    return state.mesh is not None and axis_size(state.mesh, 'model') > 1


def _map_sliced(state: TrainState, params: dict, opt: Optional[dict],
                fn: Callable) -> tuple[dict, Optional[dict]]:
    """A state dict of the model and one of its optimizer with
    ``fn(tensor, spec)`` in place of every tensor of a tensor-parallel
    parameter and of its Adam moments."""
    specs = param_shardings(state.model)
    name_of = {id(p): n for n, p in state.model.named_parameters()}
    names = [name_of[id(p)] for p in state.optimizer.params]

    def f(name, v):
        spec = specs.get(name, ())
        return v if sharded_dim(spec) is None else fn(v, spec)

    params = {k: f(k, v) for k, v in params.items()}
    if opt is not None:
        opt = dict(opt, state={
            i: {k: f(names[i], v) if k in ('exp_avg', 'exp_avg_sq') else v
                for k, v in st.items()}
            for i, st in opt['state'].items()})
    return params, opt


def save_checkpoint(ckpt_dir: str | Path, state: TrainState,
                    name: str = 'current') -> Path:
    """Parameters, optimizer state and step to ``<ckpt_dir>/<name>.pt``,
    written to a temporary file first so that a preempted save leaves the
    previous checkpoint whole. On a mesh every rank calls it: the
    tensor-parallel slices are gathered over ``model``, the primary rank
    writes the whole state and the others wait for it."""
    params = state.model.state_dict()
    opt = state.optimizer.state_dict()
    if _sliced(state):
        group = state.mesh.get_group('model')
        params, opt = _map_sliced(state, params, opt, lambda v, spec: (
            all_gather_cat(v, group, sharded_dim(spec))))
    path = checkpoint_path(ckpt_dir, name)
    meshed = state.mesh is not None and dist.is_initialized()
    if is_primary() or not meshed:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + '.tmp')
        torch.save({'params': params, 'optimizer': opt, 'step': state.step},
                   tmp)
        os.replace(tmp, path)
    if meshed:
        dist.barrier()
    return path


def restore_checkpoint(ckpt_dir: str | Path, state: TrainState,
                       name: str = 'current',
                       restore_optimizer: bool = False) -> TrainState:
    """Warm start. As the reference (train_realestate10k.py:100-101 keeps
    it commented out), only the parameters are restored by default and the
    step stays where ``state`` has it; ``restore_optimizer`` restores the
    optimizer state and the step too. A sharded ``state`` takes its rank's
    slices of the whole checkpoint."""
    ckpt = torch.load(checkpoint_path(ckpt_dir, name),
                      map_location=model_device(state.model),
                      weights_only=True)
    params = ckpt['params']
    opt = ckpt['optimizer'] if restore_optimizer else None
    if _sliced(state):
        params, opt = _map_sliced(state, params, opt, lambda v, spec: (
            shard_tensor(v, spec, state.mesh)))
    state.model.load_state_dict(params)
    if restore_optimizer:
        state.optimizer.load_state_dict(opt)
        state.step = int(ckpt['step'])
    return state


# ---------------------------------------------------------------------------
# Curriculum training loop (reference training.training/train,
# training.py:32-248).
# ---------------------------------------------------------------------------

def fit(model: nn.Module, cfg: TrainConfig, data_iter: Iterator[dict],
        max_steps: int, ckpt_dir: Optional[str] = None, mesh=None,
        state: Optional[TrainState] = None,
        log_fn: Optional[Callable[[int, dict], None]] = None,
        val_fn: Optional[Callable[[TrainState, int], None]] = None,
        lpips_fn: Optional[Callable] = None,
        loss_schedules: Optional[dict] = None,
        resume: bool = True) -> TrainState:
    """One curriculum stage: ``max_steps`` steps over ``data_iter``.

    ``lpips_fn`` is required when ``cfg.lpips`` is set: the stage-2
    fine-tune (reference README.md:56-58, loss_functions.py:102-118) must
    not train without its perceptual term.

    When ``resume`` and ``<ckpt_dir>/current.pt`` exists, training goes on
    from it (parameters, optimizer and step). A checkpoint ``current`` is
    written every ``steps_til_summary`` steps (then ``val_fn(state, i)``
    runs), ``step_{n:06d}`` every ``iters_til_checkpoint`` and ``final``
    at the end.

    With a mesh every rank runs ``fit`` on its rows of each batch: the
    state is sharded (:func:`shard_state`) and then restored, each rank
    taking its slices of the whole checkpoint."""
    if cfg.lpips and lpips_fn is None:
        raise ValueError(
            'cfg.lpips=True but no lpips_fn was provided; construct one '
            'with losses.lpips.load_lpips() (stage-2 fine-tune must not '
            'silently train without the LPIPS term)')
    first = next(data_iter)
    if state is None:
        state = create_train_state(model, cfg)
        if mesh is not None:
            state = shard_state(state, mesh)
        if (resume and ckpt_dir
                and checkpoint_path(ckpt_dir, 'current').exists()):
            state = restore_checkpoint(ckpt_dir, state, 'current',
                                       restore_optimizer=True)
            print(f'resumed from {ckpt_dir}/current at step {state.step}',
                  flush=True)
    elif mesh is not None:
        state = shard_state(state, mesh)
    step_fn = make_train_step(state.model, cfg, mesh, lpips_fn=lpips_fn,
                              loss_schedules=loss_schedules)

    scene = first
    for i in range(state.step, max_steps):
        state, metrics = step_fn(state, scene)
        if i + 1 < max_steps:
            scene = next(data_iter)
        if log_fn is not None:
            log_fn(i, metrics)
        if ckpt_dir and (i + 1) % cfg.iters_til_checkpoint == 0:
            save_checkpoint(ckpt_dir, state, f'step_{i + 1:06d}')
        if ckpt_dir and (i + 1) % cfg.steps_til_summary == 0:
            save_checkpoint(ckpt_dir, state, 'current')
            if val_fn is not None:
                val_fn(state, i)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, state, 'final')
    device = model_device(state.model)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return state
