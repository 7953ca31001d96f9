#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, each of which must pass (else the script exits non-zero and prints
no result):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles both CUDA kernels from ``cross_attention_renderer_torch/
     csrc`` with one ``nvcc`` each, all at once;
  3. main path: the flagship renderer (122M DPT-hybrid, bf16 compute, f32
     parameters from a seeded initialiser; the decoder's output layer is
     drawn at 1/64 of its scale, since an untrained decoder has no image
     range to check against) encodes two 256x256 views and
     renders the full 65,536-ray image in 8 blocks of 8,192 rays, with the
     kernels' launch counters set to 0 just before and read just after
     (16 attention launches and 8 epilogue launches per image); the image
     must be finite with RGB in [-1, 1.5] and some valid rays; then the
     encode and whole-image times and a profile of one image;
  4. kernel checks: each kernel against its plain PyTorch version, on the
     inputs of the main path's first ray block, with the tolerance stated
     below, and the times of both beside the least time the card could
     take (``bound_ms``);
  5. small-input agreement: a narrow model renders a small scene with the
     kernels in bf16 on the card and with the plain versions in f32 on the
     CPU; the images must agree within the stated tolerance.
Then it prints the ``kernels`` JSON line, the card line and, last, the
result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

H = W = 256
RAY_BLOCK = 8192
N_BLOCKS = (H * W) // RAY_BLOCK
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
BF16_TENSOR_FLOPS = 989e12      # dense bf16 tensor cores, published
F32_FLOPS = 67e12               # f32 outside the tensor cores, published
# Tolerances, as fractions of max(1, max |plain|): the kernel and its plain
# version read the same bf16 inputs and accumulate in f32 but round
# intermediates at different places.
K1_TOL = {'out': 2 ** -7, 'at_wt': 2 ** -8}
K2_TOL = 2 ** -5
SMALL_TOL = 0.1     # bf16 card render vs f32 CPU render of the same model
# The decoder has no output squashing: at its initial scale random weights
# put RGB near +-40. Its last layer is drawn this much smaller so that the
# random image lies in an image's range and the range check below means
# something.
RGB_LAYER_SCALE = 1.0 / 64


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def scale(want) -> float:
    return max(1.0, float(want.float().abs().max()))


def attention_bound(q, k, v):
    """(bound_ms, bound_by) of one epipolar_attention call on these inputs."""
    B, V, R, P, D = q.shape
    C = v.shape[-1]
    nbytes = (q.numel() + k.numel() + v.numel() + B * R * C
              + B * V * R * P) * q.element_size()
    flops = B * R * V * P * (2 * D + 2 * C + 5)     # dots, sums, softmax
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else \
        'operations'


def epilogue_bound(tables, cells, aux_self, params):
    """(bound_ms, bound_by) of one fused_exchange_epilogue call: the table
    rows this call's cells reference, the cells, aux and weights read once,
    the outputs written once; the tensor-core products of every sample."""
    import torch
    M = aux_self.shape[0]
    w1, w2, k2 = params[0], params[2], params[8]
    F, H1, O, K = w1.shape[0] - 3, w1.shape[1], w2.shape[1], k2.shape[1]
    row_bytes = sum(int(torch.unique(c).numel()) * t.shape[-1]
                    * t.element_size() for t, c in zip(tables, cells))
    nbytes = (row_bytes + sum(c.numel() * 4 for c in cells)
              + 2 * aux_self.numel() * aux_self.element_size()
              + sum(p.numel() * 2 for p in params) + M * (O + K) * 2)
    macs = M * (2 * (F * H1 + H1 * O) + 2 * O * O + 2 * O * K + K * K)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * macs / BF16_TENSOR_FLOPS
    return max(t_bytes, t_ops) * 1e3, 'bytes' if t_bytes >= t_ops else \
        'operations'


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    if not (root / 'cross_attention_renderer_torch').is_dir():
        print('chip_smoke: run from a checkout of the repository',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))

    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models import renderer as RM
    from cross_attention_renderer_torch.ops import _build
    from cross_attention_renderer_torch.ops import epipolar_attention as EA
    from cross_attention_renderer_torch.ops import gather_epilogue as GE
    from cross_attention_renderer_torch.train.evaluation import (
        make_scan_renderer)

    # -- 1. device ---------------------------------------------------------
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device('cuda')
    log(f'device: {torch.cuda.get_device_name(0)} | {card} | torch '
        f'{torch.__version__} cuda {torch.version.cuda}')

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    for name, out in _build.build().items():
        print(f'--- nvcc {name}\n{out}', file=sys.stderr)
    log(f'build: {time.perf_counter() - t0:.1f} s')

    # -- 3. main path ------------------------------------------------------
    model = RM.CrossAttentionRenderer(npoints=64, dtype=torch.bfloat16,
                                      seed=0, device=dev).eval()
    with torch.no_grad():
        model.phi.lin_out.weight.mul_(RGB_LAYER_SCALE)
    scene = make_scene(0, H=H, W=W, n_rays=H * W,
                       full_image=True, device=dev)
    uv_full = scene['query']['uv']
    render_image = make_scan_renderer(model, N_BLOCKS)

    captured = {}       # the first ray block's kernel inputs, for phase 4

    def capture(name, fn):
        def wrapper(*args):
            if name not in captured:
                captured[name] = args
            return fn(*args)
        return wrapper

    RM.epipolar_attention = capture('attention', EA.epipolar_attention)
    RM.fused_exchange_epilogue = capture('epilogue',
                                         GE.fused_exchange_epilogue)
    EA.epipolar_attention.launches = 0
    GE.fused_exchange_epilogue.launches = 0
    with torch.inference_mode():
        z = model.encode(scene)
        rgb, valid = render_image(scene, z, uv_full)
    torch.cuda.synchronize()
    launches = {'epipolar_attention': EA.epipolar_attention.launches,
                'fused_exchange_epilogue':
                    GE.fused_exchange_epilogue.launches}
    RM.epipolar_attention = EA.epipolar_attention
    RM.fused_exchange_epilogue = GE.fused_exchange_epilogue
    log(f'main path launches per image: {launches}')
    if launches != {'epipolar_attention': 2 * N_BLOCKS,
                    'fused_exchange_epilogue': N_BLOCKS}:
        raise RuntimeError(f'unexpected kernel launches {launches}')
    rgb_f = rgb.float()
    valid_frac = float(valid.float().mean())
    if rgb.shape != (1, 1, H * W, 3) or not bool(torch.isfinite(rgb_f).all()):
        raise RuntimeError('image is not finite or has the wrong shape')
    lo, hi = float(rgb_f.min()), float(rgb_f.max())
    if lo < -1.0 or hi > 1.5 or valid_frac <= 0.0:
        raise RuntimeError(f'rgb range [{lo}, {hi}], valid {valid_frac}')
    log(f'image: rgb in [{lo:.4f}, {hi:.4f}], valid fraction {valid_frac:.4f}')

    with torch.inference_mode():
        encode_ms = cuda_ms(lambda: model.encode(scene), 5)
        t0 = time.perf_counter()
        n_img = 3
        for _ in range(n_img):
            rgb, _ = render_image(scene, z, uv_full)
        torch.cuda.synchronize()
        image_s = (time.perf_counter() - t0) / n_img
    log(f'encode: {encode_ms:.3f} ms | image: {image_s * 1e3:.1f} ms | '
        f'{H * W / image_s:.1f} rays/s (65,536 rays, 8 blocks, bf16)')

    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_image(scene, z, uv_full)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if getattr(e, 'device_type', None) is not None
              and str(e.device_type).endswith('CUDA')]
    dev_us = sum(e.self_device_time_total for e in events)
    log(f'profile of one image: wall {wall_ms:.1f} ms, device busy '
        f'{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}%)')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f'  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  '
            f'{e.key[:90]}')

    # -- 4. kernel checks on the first block's inputs ----------------------
    kernels = []
    torch.set_grad_enabled(False)
    q, k, v = captured['attention']
    out, wt = EA.epipolar_attention(q, k, v)
    out_ref, wt_ref = EA.epipolar_attention_reference(q, k, v)
    err_out, err_wt = max_err(out, out_ref), max_err(wt, wt_ref)
    log(f'K1 epipolar_attention {tuple(q.shape)} x {tuple(v.shape)}: '
        f'max err out {err_out:.3e} (tol {K1_TOL["out"] * scale(out_ref):.3e})'
        f', at_wt {err_wt:.3e} (tol {K1_TOL["at_wt"]:.3e})')
    if (err_out > K1_TOL['out'] * scale(out_ref)
            or err_wt > K1_TOL['at_wt']):
        raise RuntimeError('K1 disagrees with its plain version')
    bound, bound_by = attention_bound(q, k, v)
    kernels.append({
        'name': 'epipolar_attention', 'route': 'cuda',
        'source': 'cross_attention_renderer_torch/csrc/epipolar_attention.cu',
        'replaces': 'cross_attention_renderer_tpu/ops/epipolar_attention.py:118',
        'launches': launches['epipolar_attention'],
        'max_abs_err': max(err_out, err_wt),
        'ms': cuda_ms(lambda: EA.epipolar_attention(q, k, v), 20),
        'plain_ms': cuda_ms(
            lambda: EA.epipolar_attention_reference(q, k, v), 5),
        'bound_ms': bound, 'bound_by': bound_by, 'library_ms': None})

    args = captured['epilogue']
    jl, kv = GE.fused_exchange_epilogue(*args)
    jl_ref, kv_ref = GE.fused_exchange_epilogue_reference(*args)
    err_jl, err_kv = max_err(jl, jl_ref), max_err(kv, kv_ref)
    log(f'K2 fused_exchange_epilogue M={args[2].shape[0]}: max err jl '
        f'{err_jl:.3e} (tol {K2_TOL * scale(jl_ref):.3e}), kv {err_kv:.3e} '
        f'(tol {K2_TOL * scale(kv_ref):.3e})')
    if (err_jl > K2_TOL * scale(jl_ref) or err_kv > K2_TOL * scale(kv_ref)):
        raise RuntimeError('K2 disagrees with its plain version')
    del jl_ref, kv_ref
    bound, bound_by = epilogue_bound(args[0], args[1], args[2], args[4])
    kernels.append({
        'name': 'fused_exchange_epilogue', 'route': 'cuda',
        'source': 'cross_attention_renderer_torch/csrc/gather_epilogue.cu',
        'replaces': 'cross_attention_renderer_tpu/ops/gather_epilogue.py:220',
        'launches': launches['fused_exchange_epilogue'],
        'max_abs_err': max(err_jl, err_kv),
        'ms': cuda_ms(lambda: GE.fused_exchange_epilogue(*args), 10),
        'plain_ms': cuda_ms(
            lambda: GE.fused_exchange_epilogue_reference(*args), 3),
        'bound_ms': bound, 'bound_by': bound_by, 'library_ms': None})
    for kern in kernels:
        log(f'{kern["name"]}: {kern["ms"]:.3f} ms, plain '
            f'{kern["plain_ms"]:.3f} ms, bound {kern["bound_ms"]:.3f} ms '
            f'({kern["bound_by"]})')
    captured.clear()

    # -- 5. small input: card bf16 kernels vs CPU f32 plain versions -------
    small = dict(npoints=16, fusion_features=32, vit_width=64, vit_depth=2,
                 vit_heads=2, resnet_layers=(1, 1, 1))
    ref = RM.CrossAttentionRenderer(seed=1, device='cpu', **small)
    card_model = RM.CrossAttentionRenderer(dtype=torch.bfloat16, seed=1,
                                           device=dev, **small)
    s_cpu = make_scene(1, H=64, W=64, n_rays=512, device='cpu')
    s_dev = make_scene(1, H=64, W=64, n_rays=512, device=dev)
    with torch.inference_mode():
        want = ref(s_cpu)['rgb']
        got = card_model(s_dev)['rgb'].float().cpu()
    err = max_err(got, want)
    log(f'small input: bf16 card render vs f32 CPU render, max err '
        f'{err:.3e} (tol {SMALL_TOL * scale(want):.3e})')
    if not bool(torch.isfinite(got).all()) or err > SMALL_TOL * scale(want):
        raise RuntimeError('small-input render disagrees with the reference')

    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
