"""What the port's card benchmarks share (``bench_train_roofline``,
``profile_sorted``, ``trace_render``, ``bench_traj``, ``bench_v3``,
``bench_block``, ``bench_blocks``, ``bench_sorted_stream``,
``bench_ondisk``): the ``--device`` flag (``cuda`` by default; without a
card a tool stops with a message, as the probes do), the card's name and
power limit, the flagship model and scene, and timing with CUDA events
(the host's clock on the CPU, where a tool runs only at the tiny sizes
the tests give it)."""

from __future__ import annotations

import argparse
import time
from typing import Callable

import torch

from cross_attention_renderer_torch.utils.profiling import cuda_ms

H = W = 256
RAY_BLOCK = 8192


def add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                   help='cuda (default) runs the kernels on the card; cpu '
                        'runs their plain versions (tiny sizes only)')


def device(tool: str, name: str = 'cuda') -> torch.device:
    """The device ``tool`` runs on; stops with a message where it is the
    card and none is visible."""
    if name == 'cuda' and not torch.cuda.is_available():
        raise SystemExit(f'{tool}: needs an NVIDIA card (--device cuda); '
                         'none is visible')
    return torch.device(name)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    from cross_attention_renderer_torch.tools.bench_train import (
        card_line as line)
    return line()


def print_card(dev: torch.device) -> None:
    if dev.type == 'cuda':
        print(card_line(), flush=True)


def sync(dev: torch.device) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def mean_ms(fn: Callable[[], object], iters: int, dev: torch.device
            ) -> float:
    """Mean ms of ``fn`` over ``iters`` calls after one warm-up: between two
    CUDA events on the card (``utils/profiling.py:cuda_ms``), on the host's
    clock on the CPU."""
    if dev.type == 'cuda':
        return cuda_ms(fn, iters)
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def flagship(n_view: int, dev: torch.device, dtype=torch.bfloat16, **kw):
    """The 122M flagship renderer at ``n_view`` views, seed-0 parameters
    (``kw`` overrides the constructor's defaults: the tests' tiny
    widths)."""
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    return CrossAttentionRenderer(n_view=n_view, dtype=dtype, seed=0,
                                  device=dev, **kw).eval()


def full_scene(n_view: int, dev: torch.device, hw: int = H):
    """``make_scene(0)`` with the full hw x hw query image (bench.py's)."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    return make_scene(0, batch=1, n_view=n_view, H=hw, W=hw, n_rays=hw * hw,
                      full_image=True, device=dev)


def with_uv(scene: dict, uv) -> dict:
    """``scene`` with its query rays replaced by ``uv``."""
    s = dict(scene)
    s['query'] = dict(scene['query'], uv=uv)
    return s
