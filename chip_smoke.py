#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

  python3 chip_smoke.py

Phases, each of which must pass (else the script exits non-zero and prints
no result):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles every CUDA kernel from ``cross_attention_renderer_torch/
     csrc`` with one ``nvcc`` each, all at once;
  3. V=2 main path: the flagship renderer (122M DPT-hybrid, bf16 compute, f32
     parameters from a seeded initialiser; the decoder's output layer is
     drawn at 1/64 of its scale, since an untrained decoder has no image
     range to check against) encodes two 256x256 views and renders the full
     65,536-ray image in 8 blocks of 8,192 rays, with the kernels' launch
     counters set to 0 just before and read just after (16 attention
     launches and 8 epilogue launches per image); the image must be finite
     with RGB in [-1, 1.5] and some valid rays; then the encode and
     whole-image times and a profile of one image;
  4. V=2 kernel checks: each kernel against its plain PyTorch version, on
     the inputs of the main path's first ray block, with the tolerance stated
     below, and the times of both beside the least time the card could take
     (``bound_ms``);
  5. V=2 small-input agreement: a narrow model renders a small scene with
     the kernels in bf16 on the card and with the plain versions in f32 on
     the CPU; the images must agree within the stated tolerance;
  5b. V=2 fused render (K4): the same model and scene as phase 3 with
     ``fused_render=True`` (8 fused render core launches, and no attention
     or epilogue launch, per image); the same image checks; K4 against its
     plain version on the first block's inputs; the image, and the first
     block's attention weights and depth, against phase 3's staged render
     within the stated tolerance; then the small-input agreement;
  6. V=3 default path (Path A): the same as phase 3 for three views at 48
     samples (16 attention and 8 multi-stream epilogue launches per image),
     then K3, and K1 at V*P = 144, against their plain versions;
  7. V=3 reference-compatible path (Path B, ``reference_exchange_compat``
     with the fused MLP): the same image checks (16 attention and 72 fused
     MLP launches per image, 9 a block), then K9 against its plain version;
  8. V=3 small-input agreement for both V=3 paths, as phase 5.
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
# intermediates at different places (the plain versions round every
# product's output to bf16, the kernels keep f32 until the next product's
# input, and K3 sums the streams in f32 before it rounds once).
K1_TOL = {'out': 2 ** -7, 'at_wt': 2 ** -8}
K2_TOL = K3_TOL = K9_TOL = 2 ** -5
K4_TOL = {'z': 2 ** -5, 'at_wt': 2 ** -8}
# The fused render against the staged one (K2 + 2 x K1) of the same model:
# both run in bf16, but the staged path rounds the joint latent, key, query
# embeddings and both rounds' outputs to bf16 between kernels and its query
# MLPs round after each product and again after the bias, where K4 keeps
# f32 until each product's input. A few bf16 steps of each output.
FUSED_VS_STAGED_TOL = {'rgb': 2 ** -4, 'at_wt': 2 ** -7, 'depth_ray': 2 ** -4}
SMALL_TOL = 0.1     # bf16 card render vs f32 CPU render of the same model
# The decoder has no output squashing: at its initial scale random weights
# put RGB near +-40. Its last layer is drawn this much smaller so that the
# random image lies in an image's range and the range check below means
# something.
RGB_LAYER_SCALE = 1.0 / 64
SMALL = dict(npoints=16, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))
PATH_B = dict(reference_exchange_compat=True, fused_mlp=True)


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


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                       else 'operations')


def attention_bound(q, k, v):
    """(bound_ms, bound_by) of one epipolar_attention call on these inputs."""
    B, V, R, P, D = q.shape
    C = v.shape[-1]
    nbytes = (q.numel() + k.numel() + v.numel() + B * R * C
              + B * V * R * P) * q.element_size()
    flops = B * R * V * P * (2 * D + 2 * C + 5)     # dots, sums, softmax
    return bound(nbytes, flops, F32_FLOPS)


def exchange_work(tables, cells, aux_list, params):
    """(bytes read, multiply-adds) of the exchange epilogue with S =
    len(aux_list) streams: the table rows the cells reference, the cells,
    aux and the ten epilogue weights read once; the tensor-core products of
    every sample."""
    import torch
    S, M = len(aux_list), aux_list[0].shape[0]
    w1, w2, k2 = params[0], params[2], params[8]
    F, H1, O, K = w1.shape[0] - 3, w1.shape[1], w2.shape[1], k2.shape[1]
    row_bytes = sum(int(torch.unique(c).numel()) * t.shape[-1]
                    * t.element_size() for t, c in zip(tables, cells))
    nbytes = (row_bytes + sum(c.numel() * 4 for c in cells)
              + sum(a.numel() * a.element_size() for a in aux_list)
              + sum(p.numel() * 2 for p in params[:10]))
    macs = M * (S * (F * H1 + H1 * O) + S * O * O + S * O * K + K * K)
    return nbytes, macs


def epilogue_bound(tables, cells, aux_list, params):
    """(bound_ms, bound_by) of one exchange epilogue call: its reads and
    products, and its (M, O) and (M, K) outputs written once."""
    nbytes, macs = exchange_work(tables, cells, aux_list, params)
    M, O, K = aux_list[0].shape[0], params[2].shape[1], params[8].shape[1]
    return bound(nbytes + M * (O + K) * 2, 2 * macs, BF16_TENSOR_FLOPS)


def render_core_bound(tables, cells, aux_self, aux_cross, lc, params, B, R,
                      P, repeat):
    """(bound_ms, bound_by) of one fused_render_core call: the exchange's
    reads and products; the local coordinates and query weights read once,
    the (B, R, O) output and (B, 2, R, P) weights written once; per sample
    the query MLP, the repeat MLP's local-coordinate half and its second
    layer, and each round's q . k and value sum; per ray encode_latent and
    the repeat MLP's z_embed half (the same for every sample of a ray). All
    at the bf16 tensor-core rate, which makes it a lower bound."""
    nbytes, macs = exchange_work(tables, cells, (aux_self, aux_cross),
                                 params)
    M, O, K = aux_self.shape[0], params[2].shape[1], params[8].shape[1]
    rounds = 2 if repeat else 1
    query = params[10:14] + (params[14:] if repeat else ())
    nbytes += (lc.numel() * 2 + sum(p.numel() * 2 for p in query)
               + (B * R * O + M) * 2)
    macs += M * rounds * (16 * K + K * K + K + O)
    if repeat:
        macs += B * R * (O * K + K * K)
    return bound(nbytes, 2 * macs, BF16_TENSOR_FLOPS)


def mlp_bound(x1, x2, w1a, w1b, b1, w2, b2):
    """(bound_ms, bound_by) of one fused_mlp2 call: x1, x2, the weights and
    the output moved once; the products of every row."""
    M, K1 = x1.shape
    H, O = w1a.shape[1], w2.shape[1]
    nbytes = (x1.numel() + x2.numel() + M * O) * 2 + 2 * (
        w1a.numel() + w1b.numel() + w2.numel()) + 4 * (H + O)
    return bound(nbytes, 2 * M * (K1 * H + 3 * H + H * O), BF16_TENSOR_FLOPS)


def drive(label, model, scene, RM, counted, expected):
    """Renders the full image through ``make_scan_renderer`` with the launch
    counters of ``counted`` ({name in the renderer module: kernel wrapper})
    set to 0 just before and read just after, and checks the image. Then
    times encode and the whole image and profiles one image. Returns the
    first ray block's arguments of every counted kernel that launched, the
    launches and the image."""
    import torch
    from cross_attention_renderer_torch.train.evaluation import (
        make_scan_renderer)
    uv_full = scene['query']['uv']
    render_image = make_scan_renderer(model, N_BLOCKS)
    captured = {}

    def capture(name, fn):
        def wrapper(*args):
            if name not in captured:
                captured[name] = args
            return fn(*args)
        return wrapper

    for name, fn in counted.items():
        setattr(RM, name, capture(name, fn))
        fn.launches = 0
    with torch.inference_mode():
        z = model.encode(scene)
        rgb, valid = render_image(scene, z, uv_full)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counted.items()}
    for name, fn in counted.items():
        setattr(RM, name, fn)
    log(f'{label} launches per image: {launches}')
    if launches != expected:
        raise RuntimeError(f'{label}: unexpected kernel launches {launches}, '
                           f'expected {expected}')
    rgb_f = rgb.float()
    valid_frac = float(valid.float().mean())
    if rgb.shape != (1, 1, H * W, 3) or not bool(torch.isfinite(rgb_f).all()):
        raise RuntimeError(f'{label}: image is not finite or has the wrong '
                           'shape')
    lo, hi = float(rgb_f.min()), float(rgb_f.max())
    if lo < -1.0 or hi > 1.5 or valid_frac <= 0.0:
        raise RuntimeError(f'{label}: rgb range [{lo}, {hi}], valid '
                           f'{valid_frac}')
    log(f'{label} image: rgb in [{lo:.4f}, {hi:.4f}], valid fraction '
        f'{valid_frac:.4f}')

    V = scene['context']['rgb'].shape[1]
    with torch.inference_mode():
        encode_ms = cuda_ms(lambda: model.encode(scene), 5)
        t0 = time.perf_counter()
        n_img = 3
        for _ in range(n_img):
            render_image(scene, z, uv_full)
        torch.cuda.synchronize()
        image_s = (time.perf_counter() - t0) / n_img
    log(f'{label} encode: {encode_ms:.3f} ms | image: {image_s * 1e3:.1f} ms '
        f'| {H * W / image_s:.1f} rays/s ({H * W:,} rays, {N_BLOCKS} blocks, '
        f'V={V}, '
        f'{model.n_samples} samples, bf16)')

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
    log(f'{label} profile of one image: wall {wall_ms:.1f} ms, device busy '
        f'{dev_us / 1e3:.1f} ms ({100 * dev_us / 1e3 / wall_ms:.1f}%)')
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f'  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  '
            f'{e.key[:90]}')
    return captured, launches, rgb


def first_block(model, scene):
    """The model's rgb, at_wt and depth_ray on the image's first ray block,
    as f32."""
    import torch
    s = dict(scene)
    s['query'] = dict(scene['query'],
                      uv=scene['query']['uv'][:, :, :RAY_BLOCK])
    with torch.inference_mode():
        out = model(s)
    return {k: out[k].float() for k in ('rgb', 'at_wt', 'depth_ray')}


def check_render_core(FR, args):
    """K4 against its plain version on ``args``; returns its numbers."""
    z, wt = FR.fused_render_core(*args)
    z_ref, wt_ref = FR.fused_render_core_reference(*args)
    err_z, err_wt = max_err(z, z_ref), max_err(wt, wt_ref)
    log(f'K4 fused_render_core (B, R, P) = {tuple(args[6:9])}, repeat '
        f'{args[9]}: max err z {err_z:.3e} (tol '
        f'{K4_TOL["z"] * scale(z_ref):.3e}), at_wt {err_wt:.3e} (tol '
        f'{K4_TOL["at_wt"]:.3e})')
    if err_z > K4_TOL['z'] * scale(z_ref) or err_wt > K4_TOL['at_wt']:
        raise RuntimeError('K4 disagrees with its plain version')
    del z, wt, z_ref, wt_ref
    bound_ms, bound_by = render_core_bound(*args)
    return {'max_abs_err': max(err_z, err_wt),
            'ms': cuda_ms(lambda: FR.fused_render_core(*args), 10),
            'plain_ms': cuda_ms(
                lambda: FR.fused_render_core_reference(*args), 3),
            'bound_ms': bound_ms, 'bound_by': bound_by}


def check_fused_vs_staged(rgb_fused, rgb_staged, block_fused, block_staged):
    """The fused render's image and first block against the staged
    render's, within FUSED_VS_STAGED_TOL of max(1, max |staged|)."""
    pairs = [('rgb', 'rgb', rgb_fused, rgb_staged)] + [
        (k, f'first block {k}', block_fused[k], block_staged[k])
        for k in ('at_wt', 'depth_ray')]
    for key, name, got, want in pairs:
        tol = FUSED_VS_STAGED_TOL[key]
        err = max_err(got, want)
        log(f'fused vs staged render, {name}: max err {err:.3e} (tol '
            f'{tol * scale(want):.3e})')
        if err > tol * scale(want):
            raise RuntimeError(f'the fused render disagrees with the staged '
                               f'render ({name})')


def check_attention(label, EA, q, k, v):
    """K1 against its plain version on (q, k, v); returns its numbers."""
    out, wt = EA.epipolar_attention(q, k, v)
    out_ref, wt_ref = EA.epipolar_attention_reference(q, k, v)
    err_out, err_wt = max_err(out, out_ref), max_err(wt, wt_ref)
    log(f'K1 epipolar_attention {label} {tuple(q.shape)} x '
        f'{tuple(v.shape)}: max err out {err_out:.3e} (tol '
        f'{K1_TOL["out"] * scale(out_ref):.3e}), at_wt {err_wt:.3e} (tol '
        f'{K1_TOL["at_wt"]:.3e})')
    if (err_out > K1_TOL['out'] * scale(out_ref)
            or err_wt > K1_TOL['at_wt']):
        raise RuntimeError(f'K1 disagrees with its plain version ({label})')
    bound_ms, bound_by = attention_bound(q, k, v)
    return {'max_abs_err': max(err_out, err_wt),
            'ms': cuda_ms(lambda: EA.epipolar_attention(q, k, v), 20),
            'plain_ms': cuda_ms(
                lambda: EA.epipolar_attention_reference(q, k, v), 5),
            'bound_ms': bound_ms, 'bound_by': bound_by}


def check_epilogue(name, kernel, plain, args, aux_list, params, tol):
    """An exchange epilogue (K2 or K3) against its plain version."""
    jl, kv = kernel(*args)
    jl_ref, kv_ref = plain(*args)
    err_jl, err_kv = max_err(jl, jl_ref), max_err(kv, kv_ref)
    log(f'{name} M={aux_list[0].shape[0]}: max err jl {err_jl:.3e} (tol '
        f'{tol * scale(jl_ref):.3e}), kv {err_kv:.3e} (tol '
        f'{tol * scale(kv_ref):.3e})')
    if err_jl > tol * scale(jl_ref) or err_kv > tol * scale(kv_ref):
        raise RuntimeError(f'{name} disagrees with its plain version')
    del jl, kv, jl_ref, kv_ref
    bound_ms, bound_by = epilogue_bound(args[0], args[1], aux_list, params)
    return {'max_abs_err': max(err_jl, err_kv),
            'ms': cuda_ms(lambda: kernel(*args), 10),
            'plain_ms': cuda_ms(lambda: plain(*args), 3),
            'bound_ms': bound_ms, 'bound_by': bound_by}


def small_agreement(label, RM, make_scene, dev, **kw):
    """A narrow model's bf16 render on the card against its f32 render on
    the CPU, through the same entry point."""
    import torch
    n_view = kw.get('n_view', 2)
    ref = RM.CrossAttentionRenderer(seed=1, device='cpu', **SMALL, **kw)
    card_model = RM.CrossAttentionRenderer(dtype=torch.bfloat16, seed=1,
                                           device=dev, **SMALL, **kw)
    s_cpu = make_scene(1, n_view=n_view, H=64, W=64, n_rays=512,
                       device='cpu')
    s_dev = make_scene(1, n_view=n_view, H=64, W=64, n_rays=512, device=dev)
    with torch.inference_mode():
        want = ref(s_cpu)['rgb']
        got = card_model(s_dev)['rgb'].float().cpu()
    err = max_err(got, want)
    log(f'small input {label}: bf16 card render vs f32 CPU render, max err '
        f'{err:.3e} (tol {SMALL_TOL * scale(want):.3e})')
    if not bool(torch.isfinite(got).all()) or err > SMALL_TOL * scale(want):
        raise RuntimeError(f'small-input render ({label}) disagrees with the '
                           'reference')


def flagship(RM, dev, **kw):
    """The 122M model in bf16 from seed 0, decoder output layer scaled."""
    import torch
    model = RM.CrossAttentionRenderer(dtype=torch.bfloat16, seed=0,
                                      device=dev, **kw).eval()
    with torch.no_grad():
        model.phi.lin_out.weight.mul_(RGB_LAYER_SCALE)
    return model


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
    from cross_attention_renderer_torch.ops import fused_mlp as FM
    from cross_attention_renderer_torch.ops import fused_render as FR
    from cross_attention_renderer_torch.ops import gather_epilogue as GE

    t_start = time.perf_counter()
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

    attention = ('epipolar_attention', EA.epipolar_attention)
    epilogue = ('fused_exchange_epilogue', GE.fused_exchange_epilogue)
    epilogue_multi = ('fused_exchange_epilogue_multi',
                      GE.fused_exchange_epilogue_multi)
    mlp = ('fused_mlp2', FM.fused_mlp2)
    render_core = ('fused_render_core', FR.fused_render_core)
    by_path = {}        # launches per image of every kernel on every path

    # -- 3. V=2 main path --------------------------------------------------
    model = flagship(RM, dev, npoints=64)
    scene = make_scene(0, H=H, W=W, n_rays=H * W, full_image=True,
                       device=dev)
    captured, launches, rgb_staged = drive(
        'V=2', model, scene, RM, dict([attention, epilogue]),
        {'epipolar_attention': 2 * N_BLOCKS,
         'fused_exchange_epilogue': N_BLOCKS})
    by_path['v2'] = launches
    block_staged = first_block(model, scene)

    # -- 4. V=2 kernel checks on the first block's inputs ------------------
    torch.set_grad_enabled(False)
    k1 = check_attention('V=2', EA, *captured['epipolar_attention'])
    args = captured['fused_exchange_epilogue']
    k2 = check_epilogue('K2 fused_exchange_epilogue',
                        GE.fused_exchange_epilogue,
                        GE.fused_exchange_epilogue_reference, args,
                        args[2:4], args[4], K2_TOL)
    del model, captured, args
    torch.cuda.empty_cache()

    # -- 5. V=2 small input ------------------------------------------------
    small_agreement('V=2', RM, make_scene, dev)

    # -- 5b. V=2 fused render (K4) -----------------------------------------
    model = flagship(RM, dev, npoints=64, fused_render=True)
    captured, launches, rgb_fused = drive(
        'V=2 fused render', model, scene, RM,
        dict([render_core, attention, epilogue]),
        {'fused_render_core': N_BLOCKS, 'epipolar_attention': 0,
         'fused_exchange_epilogue': 0})
    by_path['v2_fused_render'] = launches
    check_fused_vs_staged(rgb_fused, rgb_staged, first_block(model, scene),
                          block_staged)
    k4 = check_render_core(FR, captured['fused_render_core'])
    del model, scene, captured, rgb_fused, rgb_staged, block_staged
    torch.cuda.empty_cache()
    small_agreement('V=2 fused render', RM, make_scene, dev,
                    fused_render=True)

    # -- 6. V=3 default path (Path A): K1 and K3 ---------------------------
    model = flagship(RM, dev, n_view=3)
    scene = make_scene(0, n_view=3, H=H, W=W, n_rays=H * W,
                       full_image=True, device=dev)
    captured, launches, _ = drive(
        'V=3 (Path A)', model, scene, RM, dict([attention, epilogue_multi]),
        {'epipolar_attention': 2 * N_BLOCKS,
         'fused_exchange_epilogue_multi': N_BLOCKS})
    by_path['v3'] = launches
    k1['at_v3'] = check_attention('V=3', EA, *captured['epipolar_attention'])
    args = captured['fused_exchange_epilogue_multi']
    k3 = check_epilogue('K3 fused_exchange_epilogue_multi',
                        GE.fused_exchange_epilogue_multi,
                        GE.fused_exchange_epilogue_multi_reference, args,
                        args[2], args[3], K3_TOL)
    del model, captured, args
    torch.cuda.empty_cache()

    # -- 7. V=3 reference-compatible path (Path B): K1 and K9 --------------
    model = flagship(RM, dev, n_view=3, **PATH_B)
    per_block = 3 * 3       # 3 self and 6 cross fuse calls per block
    captured, launches, _ = drive(
        'V=3 compat (Path B)', model, scene, RM, dict([attention, mlp]),
        {'epipolar_attention': 2 * N_BLOCKS,
         'fused_mlp2': per_block * N_BLOCKS})
    by_path['v3_compat'] = launches
    args = captured['fused_mlp2']
    out = FM.fused_mlp2(*args)
    ref = FM.fused_mlp2_reference(*args)
    err9 = max_err(out, ref)
    log(f'K9 fused_mlp2 {tuple(args[0].shape)}: max err {err9:.3e} (tol '
        f'{K9_TOL * scale(ref):.3e})')
    if err9 > K9_TOL * scale(ref):
        raise RuntimeError('K9 disagrees with its plain version')
    del out, ref
    x1, x2, w1a, w1b, b1, w2, b2 = args
    dt = x1.dtype
    w1a_, w1b_, w2_ = (w.to(dt) for w in (w1a, w1b, w2))

    def two_matmuls():      # the same function as two torch.matmul calls
        h = torch.relu(x1 @ w1a_ + x2 @ w1b_ + b1.to(dt))
        return h @ w2_ + b2.to(dt)

    bound_ms, bound_by = mlp_bound(*args)
    k9 = {'max_abs_err': err9,
          'ms': cuda_ms(lambda: FM.fused_mlp2(*args), 20),
          'plain_ms': cuda_ms(lambda: FM.fused_mlp2_reference(*args), 10),
          'bound_ms': bound_ms, 'bound_by': bound_by}
    log(f'note: the torch.matmul chain relu(x1 @ W1a + x2 @ W1b + b1) @ W2 '
        f'+ b2 on K9\'s inputs: {cuda_ms(two_matmuls, 10):.3f} ms')
    del model, scene, captured, args, x1, x2
    torch.cuda.empty_cache()

    # -- 8. V=3 small inputs -----------------------------------------------
    small_agreement('V=3 (Path A)', RM, make_scene, dev, n_view=3)
    small_agreement('V=3 compat (Path B)', RM, make_scene, dev, n_view=3,
                    **PATH_B)

    kernels = []
    for (name, _), numbers, source, replaces in (
            (attention, k1, 'epipolar_attention.cu',
             'ops/epipolar_attention.py:118'),
            (epilogue, k2, 'gather_epilogue.cu', 'ops/gather_epilogue.py:220'),
            (epilogue_multi, k3, 'gather_epilogue_multi.cu',
             'ops/gather_epilogue.py:421'),
            (mlp, k9, 'fused_mlp.cu', 'ops/experimental/fused_mlp.py:77'),
            (render_core, k4, 'fused_render.cu', 'ops/fused_render.py:349')):
        paths = {p: n[name] for p, n in by_path.items() if n.get(name)}
        kernels.append({
            'name': name, 'route': 'cuda',
            'source': f'cross_attention_renderer_torch/csrc/{source}',
            'replaces': f'cross_attention_renderer_tpu/{replaces}',
            'launches': sum(paths.values()), 'launches_by_path': paths,
            **numbers, 'library_ms': None})
    for kern in kernels:
        log(f'{kern["name"]}: {kern["ms"]:.3f} ms, plain '
            f'{kern["plain_ms"]:.3f} ms, bound {kern["bound_ms"]:.3f} ms '
            f'({kern["bound_by"]}), launches per image '
            f'{kern["launches_by_path"]}')
    log(f'chip_smoke: {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
