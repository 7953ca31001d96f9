#!/usr/bin/env python3
"""Headline benchmark of the PyTorch/CUDA port: rendered rays/s on one
NVIDIA card at 256x256, 2 context views.

  python3 bench_torch.py

The protocol of ``bench.py`` (the reference eval loop,
eval_realestate10k.py:131-199): the flagship 122M-parameter model
(``CrossAttentionRenderer(n_view=2, dtype=torch.bfloat16)``, 64 epipolar
samples, random weights from seed 0) on the synthetic scene
``make_scene(0)``; the encoder latent computed once, then the full
65,536-ray image rendered by ``make_scan_renderer`` in 8 blocks of 8,192
rays; one warm-up image, then 4 timed images between
``torch.cuda.synchronize()`` calls. Prints the card's name and power limit
and the encode time, then, as its last line, ``bench.py``'s JSON:

  {"metric": ..., "value": N, "unit": "rays/sec/chip", "vs_baseline": N}

``vs_baseline`` is against the same 47,000 rays/s constant as ``bench.py``:
its estimate for the reference PyTorch model on one GPU, not a TPU figure.
Exits 1, printing no result, without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

BASELINE_RAYS_PER_SEC = 47_000.0    # bench.py's reference GPU estimate
H = W = 256
RAY_BLOCK = 8192
N_BLOCKS = (H * W) // RAY_BLOCK
N_TIMED = 4


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def measure(model=None, scene=None) -> dict:
    """The benchmark on the card: returns bench.py's four keys and
    ``encode_ms`` (CUDA-event time of one encode after a warm-up). The
    flagship model and scene are built unless given."""
    import torch
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from cross_attention_renderer_torch.train.evaluation import (
        make_scan_renderer)
    dev = torch.device('cuda')
    if scene is None:
        scene = make_scene(0, batch=1, n_view=2, H=H, W=W, n_rays=H * W,
                           full_image=True, device=dev)
    if model is None:
        model = CrossAttentionRenderer(n_view=2, dtype=torch.bfloat16,
                                       device=dev).eval()
    render_image = make_scan_renderer(model, N_BLOCKS)
    uv_full = scene['query']['uv']
    with torch.inference_mode():
        z = model.encode(scene)             # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        z = model.encode(scene)
        end.record()
        torch.cuda.synchronize()
        encode_ms = start.elapsed_time(end)
        render_image(scene, z, uv_full)     # warm-up image
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_TIMED):
            rgb, _ = render_image(scene, z, uv_full)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    checksum = float(rgb.float().sum())
    if checksum != checksum:
        raise RuntimeError('bench_torch: the image holds NaN')
    rays_per_sec = N_TIMED * H * W / (t1 - t0)
    return {'metric': 'rendered_rays_per_sec_chip_256px_2view',
            'value': round(rays_per_sec, 1), 'unit': 'rays/sec/chip',
            'vs_baseline': round(rays_per_sec / BASELINE_RAYS_PER_SEC, 2),
            'encode_ms': encode_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('bench_torch: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    print(f'card: {card_line()} | {torch.cuda.get_device_name(0)}',
          flush=True)
    result = measure()
    print(f'encode: {result.pop("encode_ms"):.3f} ms', flush=True)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
