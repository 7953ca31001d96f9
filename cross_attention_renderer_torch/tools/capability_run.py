"""Capability run on one NVIDIA card: learn to render novel views of
held-out synthetic worlds.

  python -m cross_attention_renderer_torch.tools.capability_run \\
      [--steps 4000] [--worlds 128] [--eval-every 500] [--lr 2.5e-4] \\
      [--dtype f32|bf16] [--config medium|tiny] [--world plane|boxes] \\
      [--save PATH.npz] [--out PATH.png] [--device cuda|cpu]

The port of the JAX repository's ``tools/capability_run.py``, with its
protocol: the ``medium`` (12.1M parameters) or ``tiny`` (2.9M) config
trains at V=2 on ``--worlds`` multi-view-consistent synthetic worlds
(``data/synthetic.py``: a textured plane, or the plane with floating
textured boxes), batch 8 of 256 query rays a step drawn with numpy from
seed 0, ``TrainConfig`` with a linear warmup from 0 to ``--lr`` over
min(300, steps / 10) steps, then a cosine decay to 0 at ``--steps`` (lr
5e-4 diverges near step 2k on this workload even with a plain cosine
decay; the warmup with a 2.5e-4 peak is stable). Training takes the
trainer's default route: the plain attention and the unfused exchange, no
kernel. Every ``--eval-every`` steps the full 64x64 query image of an
unseen world (seed 100003) at an unseen pose renders in one forward of the
model, through K1 (twice) and K2 on the card, and its PSNR is logged
beside the step's loss, gradient norm and steps/s. The best parameters are
kept, saved with ``--save`` (a flat ``.npz``, ``utils/params_io.py``) for
``eval_pruned`` and ``make_fast_eval_demo``, and the best render is
written beside the ground truth to ``--out`` as a PNG
(``utils/image.py:write_png``).
"""

from __future__ import annotations

import argparse
import math
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from cross_attention_renderer_torch.data.synthetic import (make_boxes_scene,
                                                           make_plane_scene)
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.train.trainer import (
    TrainConfig, create_train_state, make_train_step)
from cross_attention_renderer_torch.utils.image import write_png
from cross_attention_renderer_torch.utils.params_io import save_params

H = W = 64
BATCH = 8
N_RAYS = 256
HELD_OUT = 100003

# Shared with eval_pruned and make_fast_eval_demo. 'medium' is the 12.1M
# demo config; 'tiny' trains on a CPU in minutes, for fast-eval quality
# checks.
CONFIGS = {
    'medium': dict(npoints=32, fusion_features=128, vit_width=256,
                   vit_depth=4, vit_heads=8, resnet_layers=(2, 2, 2)),
    'tiny': dict(npoints=16, fusion_features=32, vit_width=64,
                 vit_depth=2, vit_heads=2, resnet_layers=(1, 1, 1)),
}
DTYPES = {'f32': torch.float32, 'bf16': torch.bfloat16}
DEFAULT_OUT = str(Path(__file__).resolve().parents[1] / 'build'
                  / 'capability_demo.png')


def load_world(seed: int, kind: str = 'plane') -> dict:
    """One world's full-image scene (every query pixel a ray), as numpy
    arrays on the host."""
    maker = make_boxes_scene if kind == 'boxes' else make_plane_scene
    s = maker(seed, n_view=2, H=H, W=W, device='cpu')
    return {grp: {k: v.numpy() for k, v in s[grp].items()} for grp in s}


def to_scene(arrays: dict, device) -> dict:
    """A scene of numpy arrays as tensors on ``device``."""
    return {grp: {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                  for k, v in arrays[grp].items()} for grp in arrays}


def batch_scene(worlds: list, rng: np.random.Generator,
                device='cpu') -> dict:
    """A training batch: ``BATCH`` worlds drawn with ``rng``, then
    ``N_RAYS`` query rays of each (the JAX tool's draws, in its order)."""
    picks = rng.integers(0, len(worlds), BATCH)
    out = {'context': {}, 'query': {}}
    for grp in ('context', 'query'):
        for k in worlds[0][grp]:
            out[grp][k] = np.concatenate(
                [worlds[p][grp][k] for p in picks], axis=0)
    sel = rng.integers(0, H * W, (BATCH, N_RAYS))
    uv = np.stack([out['query']['uv'][b, 0, sel[b]] for b in range(BATCH)])
    gt = np.stack([out['query']['rgb'][b, 0, sel[b]] for b in range(BATCH)])
    out['query']['uv'] = uv[:, None]
    out['query']['rgb'] = gt[:, None]
    return to_scene(out, device)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax 0.2's ``warmup_cosine_decay_schedule`` (exponent 1) on the
    host: from ``init_value`` linearly to ``peak_value`` over
    ``warmup_steps``, then a cosine to ``end_value`` at ``decay_steps``
    (warmup included), held there after."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f'decay_steps {decay_steps} must exceed '
                         f'warmup_steps {warmup_steps}')
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = float(decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(float(count - warmup_steps), cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def lr_schedule(steps: int, lr: float) -> Callable[[int], float]:
    """The tool's learning rate over a run of ``steps``."""
    warmup = min(300, max(1, steps // 10))
    return warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                        decay_steps=max(steps, warmup + 1))


def build_model(config: str, dtype: str, device) -> CrossAttentionRenderer:
    """The config's V=2 renderer, parameters from seed 0."""
    return CrossAttentionRenderer(n_view=2, **CONFIGS[config],
                                  dtype=DTYPES[dtype], device=device)


def psnr(pred, gt) -> float:
    """PSNR of RGB in [-1, 1] (a peak-to-peak range of 2)."""
    mse = float(np.mean((np.asarray(pred, np.float32)
                         - np.asarray(gt, np.float32)) ** 2))
    return 10.0 * np.log10(4.0 / max(mse, 1e-10))


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip((img + 1.0) * 127.5, 0, 255).astype(np.uint8)


def snapshot(model) -> dict:
    """Detached host copies of the parameters: the optimizer updates the
    model's tensors in place."""
    return {k: v.detach().to('cpu', copy=True)
            for k, v in model.state_dict().items()}


def run(config: str = 'medium', world: str = 'plane', worlds: int = 128,
        steps: int = 4000, eval_every: int = 500, lr: float = 2.5e-4,
        dtype: str = 'f32', device='cuda', save: Optional[str] = None,
        out: Optional[str] = DEFAULT_OUT, log=print) -> dict:
    """Trains and evaluates as the module docstring says. Returns
    ``curve`` (a row an eval: step, loss, grad_norm, psnr, steps_per_s),
    ``step0_psnr``, ``best_psnr``, ``final_psnr`` (the best parameters'
    render, which ``pred`` holds, (1, 1, H * W, 3) f32), ``gt``,
    ``params_m``, ``steps_per_s`` (the run's, evals included), ``peak_gb``
    (on the card) and ``model``, which then holds the best parameters."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    pool = [load_world(s, world) for s in range(worlds)]
    held_out = to_scene(load_world(HELD_OUT, world), dev)
    gt = held_out['query']['rgb'].float().cpu().numpy()

    model = build_model(config, dtype, dev)
    cfg = TrainConfig(lr=lr_schedule(steps, lr))
    batch_scene(pool, rng)     # the JAX tool spends this draw on its init
    state = create_train_state(model, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    log(f'params: {n_params / 1e6:.1f}M')
    step = make_train_step(model, cfg)

    def eval_psnr():
        with torch.inference_mode():
            pred = model(held_out)['rgb'].float().cpu().numpy()
        return psnr(pred, gt), pred

    p0, _ = eval_psnr()
    log(f'step 0: {p0:.1f} dB (held-out world + pose)')
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)

    curve = []
    t0 = time.perf_counter()
    best, best_params = -math.inf, None
    for i in range(1, steps + 1):
        state, metrics = step(state, batch_scene(pool, rng, dev))
        if i % eval_every == 0:
            p, _ = eval_psnr()
            if p > best:
                best, best_params = p, snapshot(model)
            rate = i / (time.perf_counter() - t0)
            row = {'step': i, 'loss': float(metrics['total_loss']),
                   'grad_norm': float(metrics['grad_norm']), 'psnr': p,
                   'steps_per_s': rate}
            curve.append(row)
            log(f'step {i}: loss {row["loss"]:.4f}  gnorm '
                f'{row["grad_norm"]:.3e}  eval {p:.1f} dB  ({rate:.1f} '
                'steps/s)')
    rate = steps / (time.perf_counter() - t0)
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
               if dev.type == 'cuda' else None)

    p, _ = eval_psnr()
    if p > best:
        best, best_params = p, snapshot(model)
    model.load_state_dict(best_params)
    p, pred = eval_psnr()      # the demo, from the best parameters
    log(f'final(best): {p:.1f} dB')

    if save:
        save_params(save, model)
        log(f'saved best params to {save}')
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        write_png(out, to_uint8(np.concatenate(
            [gt.reshape(H, W, 3), pred.reshape(H, W, 3)], axis=1)))
        log(f'wrote {out}')
    return {'curve': curve, 'step0_psnr': p0, 'best_psnr': best,
            'final_psnr': p, 'pred': pred, 'gt': gt,
            'params_m': n_params / 1e6, 'steps_per_s': rate,
            'peak_gb': peak_gb, 'model': model}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=4000)
    ap.add_argument('--worlds', type=int, default=128)
    ap.add_argument('--eval-every', type=int, default=500)
    ap.add_argument('--lr', type=float, default=2.5e-4)
    ap.add_argument('--dtype', default='f32', choices=['f32', 'bf16'],
                    help='compute type (parameters and Adam stay f32)')
    ap.add_argument('--out', default=DEFAULT_OUT,
                    help='the ground truth | best render strip (PNG)')
    ap.add_argument('--save', default=None, metavar='PATH.npz',
                    help='save the best parameters (flat npz) for '
                         'eval_pruned and make_fast_eval_demo')
    ap.add_argument('--config', default='medium', choices=list(CONFIGS),
                    help='medium = the 12.1M demo config; tiny = a '
                         'CPU-trainable config for fast-eval checks')
    ap.add_argument('--world', default='plane', choices=['plane', 'boxes'],
                    help='boxes adds floating occluders (depth structure '
                         'that makes the sampling strategy matter)')
    ap.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    args = ap.parse_args(argv)
    return run(args.config, args.world, args.worlds, args.steps,
               args.eval_every, args.lr, args.dtype, args.device, args.save,
               args.out)


if __name__ == '__main__':
    main()
