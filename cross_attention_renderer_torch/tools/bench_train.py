"""Training-step time of the port on one NVIDIA card: the flagship
stage-1 step.

  python -m cross_attention_renderer_torch.tools.bench_train [--steps N]

The counterpart of the JAX repository's ``tools/bench_train.py``: the
flagship V=2 model (122M DPT-hybrid, 64 samples, bf16 compute, f32
parameters from seed 0), batch 12 of synthetic 256x256 scenes, 192 query
rays each (the reference's batch_size and query_sparsity,
train_realestate10k.py; the JAX CLI's defaults, cli/train.py:31,37),
``TrainConfig()`` (Adam 5e-5 after a global-norm clip at 1.0). For each
route of ``train/trainer.py``:

* ``default``: the train model clones the renderer with both kernel flags
  off (plain attention, unfused exchange), the JAX package's policy;
* ``kernels``: ``CAR_TRAIN_KERNELS=1``, the renderer itself: K2 and K1
  (twice) forward, their gradients from the plain versions.

One warm-up step, then N steps (default 10) between CUDA events. Prints a
line a route (ms a step, steps/s, peak ``torch.cuda.max_memory_allocated``)
and the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

BATCH = 12
RAYS = 192
HW = 256
ROUTES = ('default', 'kernels')


@contextlib.contextmanager
def route_env(route: str):
    """``CAR_TRAIN_KERNELS`` set for ``route`` while a step is built."""
    if route not in ROUTES:
        raise ValueError(f'route must be one of {ROUTES}, got {route!r}')
    old = os.environ.get('CAR_TRAIN_KERNELS')
    os.environ['CAR_TRAIN_KERNELS'] = '1' if route == 'kernels' else '0'
    try:
        yield
    finally:
        if old is None:
            del os.environ['CAR_TRAIN_KERNELS']
        else:
            os.environ['CAR_TRAIN_KERNELS'] = old


def make_route_step(model, cfg, route: str):
    """``trainer.make_train_step`` of ``model`` on ``route``."""
    from cross_attention_renderer_torch.train.trainer import make_train_step
    with route_env(route):
        return make_train_step(model, cfg)


def time_steps(step, state, scene, n: int) -> dict:
    """Times ``n`` calls of ``step(state, scene)`` after one warm-up:
    ms a step and steps/s between CUDA events, and the peak memory
    allocated over the warm-up and the timed steps, in GB."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics = step(state, scene)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        state, metrics = step(state, scene)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / n
    return {'ms_per_step': ms, 'steps_per_s': 1e3 / ms,
            'peak_gb': torch.cuda.max_memory_allocated() / 1e9,
            'total_loss': float(metrics['total_loss'])}


def flagship_train_model(device):
    """The flagship V=2 model in bf16, parameters from seed 0."""
    import torch
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    return CrossAttentionRenderer(n_view=2, dtype=torch.bfloat16, seed=0,
                                  device=device)


def measure(route: str, n: int = 10) -> dict:
    """The flagship stage-1 step on ``route``, from fresh seed-0
    parameters: :func:`time_steps`' numbers."""
    import torch
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, create_train_state)
    dev = torch.device('cuda')
    model = flagship_train_model(dev)
    scene = make_scene(0, batch=BATCH, n_view=2, H=HW, W=HW, n_rays=RAYS,
                       device=dev)
    cfg = TrainConfig()
    step = make_route_step(model, cfg, route)
    out = time_steps(step, create_train_state(model, cfg), scene, n)
    del model, step
    torch.cuda.empty_cache()
    return out


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--steps', type=int, default=10)
    opt = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('bench_train: no CUDA device', file=sys.stderr)
        return 1
    card = card_line()
    results = {}
    for route in ROUTES:
        results[route] = measure(route, opt.steps)
        r = results[route]
        print(f'{route}: {r["ms_per_step"]:.2f} ms a step, '
              f'{r["steps_per_s"]:.3f} steps/s, peak {r["peak_gb"]:.2f} GB '
              f'(batch {BATCH}, {RAYS} rays, {HW}x{HW}, V=2, bf16)',
              flush=True)
    print(json.dumps({'train_step': results}))
    print(card)
    return 0


if __name__ == '__main__':
    sys.exit(main())
