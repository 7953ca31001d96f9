"""Evaluation CLI: full-image PSNR / SSIM (/ LPIPS when weights present).

Port of ``cross_attention_renderer_tpu/cli/eval.py``, the replacement for
the reference's ``experiment_scripts/eval_realestate10k.py`` /
``eval_acid.py``: deterministic Vis sampling (context {0, 128}), the
encoder latent computed once per scene, the image rendered in
``--n_chunks`` ray blocks, running-mean metrics. Usage:

  python -m cross_attention_renderer_torch.cli.eval \\
      --img_root corpus/frames --pose_root corpus/poses.mat --max_scenes 2

On the card by default (``--device cpu`` for the CPU).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from cross_attention_renderer_torch.cli.common import (
    base_parser, build_model, fast_eval_kwargs, restore_params, scene_batch,
    to_uint8)
from cross_attention_renderer_torch.data.realestate import RealEstate10kVis
from cross_attention_renderer_torch.train.evaluation import (
    evaluate_scene, make_image_renderer)
from cross_attention_renderer_torch.train.trainer import (
    TrainConfig, create_train_state)
from cross_attention_renderer_torch.utils.image import imageio_v2


def main(argv=None) -> dict:
    """Evaluates the scenes; returns {'means': running means of the last
    scene, 'scenes': each scene's metrics (numbers) and 'seconds'}."""
    p = base_parser('Evaluate on the RealEstate10K/ACID test split')
    p.add_argument('--max_scenes', type=int, default=0)
    p.add_argument('--n_chunks', type=int, default=8)
    p.add_argument('--save_images', action='store_true')
    opt = p.parse_args(argv)

    if opt.co3d_root:
        # 3-view CO3D protocol: deterministic fewview_dev sampling, full
        # query frames (ref eval protocol via dataset/co3d.yaml).
        from cross_attention_renderer_torch.data.co3d import CO3Dv2Dataset
        dataset = CO3Dv2Dataset(opt.co3d_root, category=opt.co3d_category,
                                subset='fewview_dev',
                                num_input_views=opt.views,
                                query_sparsity=None)
    else:
        dataset = RealEstate10kVis(opt.img_root, opt.pose_root,
                                   num_ctxt_views=opt.views)
    imageio = imageio_v2('--save_images') if opt.save_images else None
    model = build_model(opt).eval()
    if opt.checkpoint_path:
        restore_params(create_train_state(model, TrainConfig()),
                       opt.checkpoint_path)
        print(f'loaded {opt.checkpoint_path}')

    lpips_fn = None
    try:
        from cross_attention_renderer_torch.losses.lpips import load_lpips
        lpips_fn = load_lpips(device=opt.device)
        print('LPIPS enabled')
    except Exception as e:
        print(f'LPIPS disabled ({e})')

    renderer = make_image_renderer(model, opt.n_chunks,
                                   **fast_eval_kwargs(opt))
    out_dir = Path(opt.logging_root) / opt.experiment_name
    out_dir.mkdir(parents=True, exist_ok=True)

    n = len(dataset) if not opt.max_scenes else min(opt.max_scenes,
                                                    len(dataset))
    sums: dict = {}
    scenes, means = [], {}
    for i in range(n):
        scene = scene_batch(dataset[i], opt.device)
        H, W = scene['context']['rgb'].shape[2:4]
        t0 = time.time()
        m = evaluate_scene(model, scene, H, W, n_chunks=opt.n_chunks,
                           lpips_fn=lpips_fn, renderer=renderer)
        elapsed = time.time() - t0
        if imageio is not None:
            imageio.imwrite(out_dir / f'{i:04d}_pred.png',
                            to_uint8(m['pred']))
        numbers = {k: float(np.asarray(m[k]))
                   for k in ('mse', 'psnr', 'ssim', 'lpips') if k in m}
        for k, v in numbers.items():
            sums.setdefault(k, []).append(v)
        means = {k: float(np.mean(v)) for k, v in sums.items()}
        scenes.append(dict(numbers, seconds=elapsed))
        line = ' '.join(f'{k}={v:.4f}' for k, v in means.items())
        print(f'[{i + 1}/{n}] elapsed={elapsed:.2f}s running means: {line}',
              flush=True)
    return {'means': means, 'scenes': scenes}


if __name__ == '__main__':
    main()
