"""Device time of one rendered image on a path, and of the kernels in it,
for comparing two trees of the package on one card.

  python3 cross_attention_renderer_torch/tools/image_time.py \\
      [--root DIR] [--patch evict_last] [--paths v2_sorted,v3_onehot]

Imports ``cross_attention_renderer_torch`` from DIR (by default the
checkout that holds this script), so the same script times an older
commit's package unpacked beside this one: run it once a tree, in turns
(old, new, new, old), in one call on the card. ``--patch evict_last``
swaps in a copy of this tree's ``csrc/bilinear_gather.cu`` whose table
loads carry an L2 ``evict_last`` policy (``tools/gather_study.py``
builds it), to ask whether the marks those loads leave, which outlast a
launch, help or hurt the next ray block of a render.

Each path renders the flagship 256x256 image (``make_scene(0)``, 8 blocks
of 8,192 rays, the 122M model in bf16 from seed 0) once to warm up, then
twice under ``torch.profiler``: the card's busy time an image (the sum of
its kernels' device time), the bilinear gather's (K5-K8), the exchange
core's (K2, K3, K4, K9) and K1's share of it, with their launches. The
paths (``PATHS``; by default all): the two that run the gather, the
flagship's V=2 (``v2``), fused render (``v2_fused``), V=3 (``v3``) and
V=3 compat (``v3_compat``), and the paths whose core takes its
'resident' plan: the DPT model at V = 4, 5, 6 (K3 at S = V; ``v5_f32``
in f32, ``v5_q8`` on int8 tables through ``make_fast_renderer``), the
ResNet34 one at V=5 (``resnet_v5``) and the U-Net one at V=2 (K2), its
fused render (K4) and V=3 (K3). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

H = W = 256
N_BLOCKS = 8
PATHS = {
    'v2_sorted': dict(npoints=64, sorted_stream=True),
    'v3_onehot': dict(n_view=3, reference_exchange_compat=True,
                      fused_mlp=True, gather='onehot'),
    'v2': dict(npoints=64),
    'v2_fused': dict(npoints=64, fused_render=True),
    'v3': dict(n_view=3),
    'v3_compat': dict(n_view=3, reference_exchange_compat=True,
                      fused_mlp=True),
    'v4': dict(n_view=4),
    'v5': dict(n_view=5),
    'v6': dict(n_view=6),
    'v5_f32': dict(n_view=5, dtype='float32'),
    'v5_q8': dict(n_view=5, q8=True),
    'resnet_v5': dict(model='resnet', n_view=5),
    'unet_v2': dict(model='unet', npoints=64),
    'unet_v2_fused': dict(model='unet', npoints=64, fused_render=True),
    'unet_v3': dict(model='unet', n_view=3),
}
# (name, what the kernel's name holds in the profiler's events)
KERNELS = (('gather', 'bilinear_gather'), ('core', 'exchange_core_kernel'),
           ('attention', 'epipolar_attention_kernel'))


def path_model(RM, name: str, device, **overrides):
    """The 122M model of path ``name`` from seed 0 (bf16 unless the path
    says f32; ``overrides``: other constructor arguments, such as narrower
    widths), and whether it renders on int8 tables."""
    import torch
    kw = dict(PATHS[name], **overrides)
    q8 = kw.pop('q8', False)
    dtype = getattr(torch, kw.pop('dtype', 'bfloat16'))
    model = RM.CrossAttentionRenderer(dtype=dtype, seed=0, device=device,
                                      **kw)
    return model.eval(), q8


def image_device_ms(model, scene, make_renderer, images: int = 2):
    """[(busy ms, then for each of ``KERNELS`` its ms and launches)] of
    ``images`` profiled images after one warm-up image, rendered by
    ``make_renderer(model, N_BLOCKS)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    uv = scene['query']['uv']
    render = make_renderer(model, N_BLOCKS)
    out = []
    with torch.inference_mode():
        z = model.encode(scene)
        render(scene, z, uv)
        torch.cuda.synchronize()
        for _ in range(images):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                render(scene, z, uv)
                torch.cuda.synchronize()
            events = [e for e in prof.key_averages()
                      if str(getattr(e, 'device_type', '')).endswith('CUDA')]
            row = [sum(e.self_device_time_total for e in events) / 1e3]
            for _, key in KERNELS:
                hit = [e for e in events if key in e.key]
                row += [sum(e.self_device_time_total for e in hit) / 1e3,
                        sum(e.count for e in hit)]
            out.append(tuple(row))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument('--patch', choices=('evict_last',), default=None)
    ap.add_argument('--paths', default=','.join(PATHS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print('image_time: no CUDA device', file=sys.stderr)
        return 1
    root = str(Path(args.root).resolve())
    sys.path.insert(0, root)
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models import renderer as RM
    from cross_attention_renderer_torch.ops import _build
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer, make_scan_renderer)
    if not _build.PKG_DIR.is_relative_to(root):
        raise SystemExit(f'image_time: the package came from {_build.PKG_DIR}'
                         f', not from {root}')
    _build.build()
    if args.patch:
        from cross_attention_renderer_torch.tools import gather_study as GS
        lib = GS.build_variants({'evict_last': [GS.BILINEAR_EVICT_LAST]},
                                'bilinear_gather')['evict_last']
        _build.use('bilinear_gather', lib)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    result = {'root': root, 'patch': args.patch, 'card': card}
    for name in args.paths.split(','):
        model, q8 = path_model(RM, name, 'cuda')
        scene = make_scene(0, n_view=model.n_view, H=H, W=W, n_rays=H * W,
                           full_image=True, device='cuda')
        result[name] = image_device_ms(
            model, scene, (lambda m, n: make_fast_renderer(m, n, q8=True))
            if q8 else make_scan_renderer)
        del model, scene
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
