"""Training runtime: the train step, checkpoints and the curriculum loop.

Port of ``cross_attention_renderer_tpu/train/trainer.py`` without the mesh
(one card; data and tensor parallelism are later work). The optimizer is
the reference's: Adam (lr 5e-5, betas (0.99, 0.999), train_realestate10k.py:
39,93) after a global-norm clip at 1.0 (training.py:130-134), as the JAX
package's ``optax.chain(clip_by_global_norm, adam)``. Checkpoints follow the
reference's "current + milestone" cadence (training.py:82-84,118-120,
233-246) through ``torch.save``.

The model is an ordinary ``nn.Module`` holding its parameters, so the loss
function and the train step close over it, where the JAX ones take a
parameter tree. Entry points run where the model's parameters are (the
card, by default, as everywhere in the port) and move each scene there.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from pathlib import Path
from typing import Callable, Iterable, Iterator, Optional

import torch
from torch import nn

from cross_attention_renderer_torch.losses.lf_loss import LFLoss, total_loss

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
    optimizer's state."""

    def __init__(self, params: Iterable[nn.Parameter], cfg: TrainConfig):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = float(cfg.clip_norm)
        self.schedule = cfg.lr if callable(cfg.lr) else None
        self.count = 0
        self.adam = torch.optim.Adam(
            self.params, lr=0.0 if self.schedule else float(cfg.lr),
            betas=(cfg.beta1, cfg.beta2), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> Tensor:
        """Clips and applies the gradients; returns their global norm
        before the clip (0-dim f32, on the parameters' device)."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [n.float() for n in torch._foreach_norm(grads)]))
        below = norm < self.clip_norm
        one = torch.ones_like(norm)
        torch._foreach_div_(grads, torch.where(below, one, norm))
        torch._foreach_mul_(grads, torch.where(below, one,
                                               one * self.clip_norm))
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
    """The model (its parameters), the optimizer and the step count."""
    model: nn.Module
    optimizer: ClippedAdam
    step: int = 0


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


def make_train_step(model: nn.Module, cfg: TrainConfig,
                    lpips_fn: Optional[Callable] = None,
                    loss_schedules: Optional[dict] = None):
    """``step(state, scene) -> (state, metrics)``: one optimizer step of
    ``state`` (updated in place) on ``scene``. Metrics, 0-dim tensors on
    the card: ``total_loss``, ``grad_norm`` (before the clip) and each
    loss's mean."""
    loss_fn = make_loss_fn(model, cfg, lpips_fn, loss_schedules)
    device = model_device(model)

    def step(state: TrainState, scene: dict) -> tuple[TrainState, dict]:
        state.optimizer.zero_grad()
        tot, losses = loss_fn(to_device(scene, device), state.step)
        tot.backward()
        gnorm = state.optimizer.step()
        state.step += 1
        metrics = {'total_loss': tot.detach(), 'grad_norm': gnorm}
        metrics.update({k: v.detach().mean() for k, v in losses.items()})
        return state, metrics

    return step


# ---------------------------------------------------------------------------
# Checkpoints: "current + milestone" cadence like training.py.
# ---------------------------------------------------------------------------

def checkpoint_path(ckpt_dir: str | Path, name: str) -> Path:
    return Path(ckpt_dir) / f'{name}.pt'


def save_checkpoint(ckpt_dir: str | Path, state: TrainState,
                    name: str = 'current') -> Path:
    """Parameters, optimizer state and step to ``<ckpt_dir>/<name>.pt``,
    written to a temporary file first so that a preempted save leaves the
    previous checkpoint whole."""
    path = checkpoint_path(ckpt_dir, name)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + '.tmp')
    torch.save({'params': state.model.state_dict(),
                'optimizer': state.optimizer.state_dict(),
                'step': state.step}, tmp)
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str | Path, state: TrainState,
                       name: str = 'current',
                       restore_optimizer: bool = False) -> TrainState:
    """Warm start. As the reference (train_realestate10k.py:100-101 keeps
    it commented out), only the parameters are restored by default and the
    step stays where ``state`` has it; ``restore_optimizer`` restores the
    optimizer state and the step too."""
    ckpt = torch.load(checkpoint_path(ckpt_dir, name),
                      map_location=model_device(state.model),
                      weights_only=True)
    state.model.load_state_dict(ckpt['params'])
    if restore_optimizer:
        state.optimizer.load_state_dict(ckpt['optimizer'])
        state.step = int(ckpt['step'])
    return state


# ---------------------------------------------------------------------------
# Curriculum training loop (reference training.training/train,
# training.py:32-248).
# ---------------------------------------------------------------------------

def fit(model: nn.Module, cfg: TrainConfig, data_iter: Iterator[dict],
        max_steps: int, ckpt_dir: Optional[str] = None,
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
    at the end."""
    if cfg.lpips and lpips_fn is None:
        raise ValueError(
            'cfg.lpips=True but no lpips_fn was provided; construct one '
            'with losses.lpips.load_lpips() (stage-2 fine-tune must not '
            'silently train without the LPIPS term)')
    first = next(data_iter)
    if state is None:
        state = create_train_state(model, cfg)
        if (resume and ckpt_dir
                and checkpoint_path(ckpt_dir, 'current').exists()):
            state = restore_checkpoint(ckpt_dir, state, 'current',
                                       restore_optimizer=True)
            print(f'resumed from {ckpt_dir}/current at step {state.step}',
                  flush=True)
    step_fn = make_train_step(state.model, cfg, lpips_fn=lpips_fn,
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
