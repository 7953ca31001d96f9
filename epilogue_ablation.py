#!/usr/bin/env python3
"""Where the exchange core's time goes (K2, K3, K9, K4), on one NVIDIA card.

  python3 epilogue_ablation.py

Run from the root of a checkout. It builds variants of the exchange core
(``csrc/exchange_core.cuh``), each with one part of the work taken out, and
times K2, K3, K9 and K4 on the first ray block of the flagship V=2, V=3,
V=3 compat and V=2 fused renders (the inputs ``chip_smoke.py`` holds them
to), beside the kernel as it is:

  no_gather - the cell rows (K9: the input rows) are not read (comb is
              zeros): the products, their weight stream and, for K4, the
              per-ray tail alone;
  no_copy   - as no_gather, and the weight stages are not copied (the
              producer only signals them): the consumers' own time;
  global    - the 'global' plan (comb and the f rows in device memory,
              read as wgmma's register operand) where the kernel would
              take another: what that plan costs;
  and K4 as it is without its second attention round (round1_only). Then
  K4 at fusion_features 384 ('resident' plan) and K9 at 512 ('smem' with
  two stage slots a ring), as they are against the 'global' variant, on
  the first 4,096 rays of models with the ViT cut to 2 blocks
  (chip_smoke's wide-latent inputs).

A variant's outputs are wrong by design; only its time is read. Prints the
card line, one line per timing and a JSON object last. Needs a card and
``nvcc``; builds into ``cross_attention_renderer_torch/build/ablation/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path.cwd()
CSRC = ROOT / 'cross_attention_renderer_torch' / 'csrc'
OUT = ROOT / 'cross_attention_renderer_torch' / 'build' / 'ablation'
LIBS = ('gather_epilogue', 'gather_epilogue_multi', 'fused_mlp',
        'fused_render')

NO_GATHER = ('    if (row >= 0 && kF32) {', '    if (row < -1 && kF32) {')
NO_GATHER_BF16 = ('    } else if (row >= 0) {\n      const bf16* src',
                  '    } else if (row < -1) {\n      const bf16* src')
NO_ROWS = ('      if (r < n_live)\n        val = load8<kF32, true>(',
           '      if (r < -1)\n        val = load8<kF32, true>(')
NO_COPY = ('    mbar_expect_tx(full + 8 * idx, bytes);\n'
           '    bulk_copy(slots + idx * kLargeStage, p.stages + off, bytes,\n'
           '              full + 8 * idx);',
           '    mbar_arrive(full + 8 * idx);')
FORCE_GLOBAL = [('  if (!fits(a.nkb_tiles)) {', '  if (true) {'),
                ('  if (a.plan == kResident && (kMode == kMlp ||',
                 '  if (a.plan == kResident && (true ||')]
VARIANTS = {'no_gather': [NO_GATHER, NO_GATHER_BF16, NO_ROWS],
            'no_copy': [NO_GATHER, NO_GATHER_BF16, NO_ROWS, NO_COPY],
            'global': FORCE_GLOBAL}


def build_variant(_build, name, patches):
    """Copies csrc with ``patches`` applied to exchange_core.cuh into
    OUT/name and starts one nvcc per library; returns the processes."""
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for f in CSRC.iterdir():
        text = f.read_text()
        if f.name == 'exchange_core.cuh':
            for old, new in patches:
                if old not in text:
                    raise RuntimeError(f'{name}: exchange_core.cuh has '
                                       'changed')
                text = text.replace(old, new)
        (d / f.name).write_text(text)
    return [(lib, d / f'lib{lib}.so', subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, '-o',
         str(d / f'lib{lib}.so'), str(d / f'{lib}.cu')],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for lib in LIBS]


def first_block_args(CS, RM, dev, name, **kw):
    """The arguments of the first call of RM.<name> on the flagship's first
    ray block."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    model = CS.flagship(RM, dev, **kw)
    scene = make_scene(0, n_view=kw.get('n_view', 2), H=CS.H, W=CS.W,
                       n_rays=CS.H * CS.W, full_image=True, device=dev)
    got, orig = [], getattr(RM, name)

    def record(*args):
        if not got:
            got.append(args)
        return orig(*args)
    setattr(RM, name, record)
    try:
        CS.first_block(model, scene)
    finally:
        setattr(RM, name, orig)
    return got[0]


def timed(CS, GE, _build, libs, fn, args, variant):
    """ms of ``fn(*args)`` with the libraries of ``variant``; checks the
    plan the launch took."""
    real = GE.core_plan
    if variant == 'global':     # the wrappers size the scratch for it
        GE.core_plan = lambda *a: real(*a, force='global')
    _build._loaded.update(libs[variant])
    try:
        ms = CS.cuda_ms(lambda: fn(*args), 10)
    finally:
        GE.core_plan = real
        _build._loaded.update(libs['full'])
    if variant == 'global' and fn.last_plan != 'global':
        raise RuntimeError(f'the global variant launched {fn.last_plan!r}')
    return ms


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('epilogue_ablation: no CUDA device', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from cross_attention_renderer_torch.models import renderer as RM
    from cross_attention_renderer_torch.ops import _build
    from cross_attention_renderer_torch.ops import fused_mlp as FM
    from cross_attention_renderer_torch.ops import fused_render as FR
    from cross_attention_renderer_torch.ops import gather_epilogue as GE

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    _build.build()
    procs = {name: build_variant(_build, name, patches)
             for name, patches in VARIANTS.items()}
    libs = {}
    for name, built in procs.items():
        for lib, path, proc in built:
            log = proc.communicate()[0]
            if proc.returncode:
                raise RuntimeError(f'nvcc failed for {name}/{lib}:\n{log}')
        libs[name] = {lib: ctypes.CDLL(str(path)) for lib, path, _ in built}
    libs['full'] = {lib: _build.load(lib) for lib in LIBS}

    dev = torch.device('cuda')
    torch.set_grad_enabled(False)
    results = {}
    for label, name, fn, kw in (
            ('K2', 'fused_exchange_epilogue', GE.fused_exchange_epilogue,
             dict(npoints=64)),
            ('K3', 'fused_exchange_epilogue_multi',
             GE.fused_exchange_epilogue_multi, dict(n_view=3)),
            ('K9', 'fused_mlp2', FM.fused_mlp2,
             dict(n_view=3, reference_exchange_compat=True, fused_mlp=True)),
            ('K4', 'fused_render_core', FR.fused_render_core,
             dict(npoints=64, fused_render=True))):
        args = first_block_args(CS, RM, dev, name, **kw)
        # full, each variant, full again: the spread of the two fulls is the
        # noise of the call
        for variant in ('full', *VARIANTS, 'full'):
            ms = timed(CS, GE, _build, libs, fn, args, variant)
            results.setdefault(label, {}).setdefault(variant, []).append(ms)
            print(f'{label} {variant}: {ms:.3f} ms', flush=True)
        if label == 'K4':
            # without round 2: what the repeat MLP and second attention
            # round cost
            ms = CS.cuda_ms(lambda: fn(*args[:-1], False), 10)
            results[label]['round1_only'] = [ms]
            print(f'{label} round1_only: {ms:.3f} ms', flush=True)
        del args
        torch.cuda.empty_cache()
    from cross_attention_renderer_torch.data.synthetic import make_scene
    for label, name, fn, ff, kw in (
            ('K4', 'fused_render_core', FR.fused_render_core, 384,
             dict(npoints=64, fused_render=True)),
            ('K9', 'fused_mlp2', FM.fused_mlp2, 512,
             dict(n_view=3, reference_exchange_compat=True, fused_mlp=True))):
        model = CS.flagship(RM, dev, fusion_features=ff, vit_depth=2, **kw)
        scene = make_scene(0, n_view=kw.get('n_view', 2), H=CS.H, W=CS.W,
                           n_rays=CS.WIDE_RAYS, device=dev)
        args = CS.first_call(model, scene, RM, name)
        key = f'{label} ff={ff}'
        # as it is, global, global, as it is
        for variant in ('full', 'global', 'global', 'full'):
            ms = timed(CS, GE, _build, libs, fn, args, variant)
            plan = fn.last_plan
            results.setdefault(key, {}).setdefault(variant, []).append(ms)
            print(f'{key} {variant} (plan {plan!r}, '
                  f'{fn.last_launch[1]} stage slots): {ms:.3f} ms',
                  flush=True)
        del model, scene, args
        torch.cuda.empty_cache()
    print(json.dumps({'card': card, 'ms': results}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
