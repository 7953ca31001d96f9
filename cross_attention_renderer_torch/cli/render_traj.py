"""Trajectory video rendering CLI.

Port of ``cross_attention_renderer_tpu/cli/render_traj.py``, the
replacement for the reference's ``render_realestate10k_traj.py`` /
``render_acid_traj.py``: loads the up-to-128-frame ground-truth camera
trajectory, computes the encoder latent once, renders each pose in ray
blocks and writes an mp4 (or PNG frames) plus per-frame PSNR/SSIM. The
video needs the imageio package. Usage:

  python -m cross_attention_renderer_torch.cli.render_traj \\
      --scene_path corpus/frames/scene0000 --pose_dir corpus/poses.mat
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cross_attention_renderer_torch.cli.common import (
    FrameWriter, base_parser, build_model, fast_eval_kwargs, restore_params,
    to_uint8)
from cross_attention_renderer_torch.data.realestate import trajectory_scene
from cross_attention_renderer_torch.train.evaluation import (
    make_image_renderer)
from cross_attention_renderer_torch.train.trainer import (
    TrainConfig, create_train_state)
from cross_attention_renderer_torch.utils.metrics import eval_image_metrics


def main(argv=None) -> dict:
    """Renders the trajectory; returns {'psnr': [...], 'ssim': [...],
    'path': where the video went}."""
    p = base_parser('Render a camera trajectory video')
    p.add_argument('--scene_path', type=str, required=True)
    p.add_argument('--pose_dir', type=str, required=True)
    p.add_argument('--ray_chunk', type=int, default=8192)
    p.add_argument('--out', type=str, default='traj.mp4')
    opt = p.parse_args(argv)

    traj = trajectory_scene(opt.scene_path, opt.pose_dir, views=opt.views)
    writer = FrameWriter(opt.out, fps=10)
    model = build_model(opt).eval()
    if opt.checkpoint_path:
        restore_params(create_train_state(model, TrainConfig()),
                       opt.checkpoint_path)

    n_frames = traj['query']['cam2world'].shape[1]
    H = W = traj['context']['rgb'].shape[-3]

    def tensor(x):
        return torch.tensor(np.ascontiguousarray(x), device=opt.device)

    context = {k: tensor(v) for k, v in traj['context'].items()}

    def frame_scene(i):
        q = traj['query']
        return {
            'context': context,
            'query': {
                'cam2world': tensor(q['cam2world'][:, i:i + 1]),
                'intrinsics': tensor(q['intrinsics'][:, i:i + 1]),
                'uv': tensor(q['uv'][:, i:i + 1]),
                'rgb': tensor(q['rgb'][:, i:i + 1].reshape(1, 1, -1, 3)),
            },
        }

    n_chunks = max(1, (H * W) // opt.ray_chunk)
    encode, render_image = make_image_renderer(model, n_chunks,
                                               **fast_eval_kwargs(opt))
    z = encode(frame_scene(0))

    psnrs, ssims = [], []
    for i in range(n_frames):
        scene = frame_scene(i)
        t0 = time.time()
        rgb, valid = render_image(scene, z)
        pred01 = (rgb.float().reshape(H, W, 3) + 1) * 0.5
        target01 = (scene['query']['rgb'].float().reshape(H, W, 3) + 1) * 0.5
        mask = valid.float().reshape(H, W, 1)
        m = eval_image_metrics(pred01, target01, mask)
        psnrs.append(float(m['psnr']))
        ssims.append(float(m['ssim']))
        writer.append(to_uint8(m['pred']))
        print(f'frame {i + 1}/{n_frames} {time.time() - t0:.2f}s '
              f'psnr={psnrs[-1]:.2f} ssim={ssims[-1]:.3f}', flush=True)
    writer.close()
    print(f'wrote {writer.path}; mean psnr={np.mean(psnrs):.2f} '
          f'ssim={np.mean(ssims):.3f}')
    return {'psnr': psnrs, 'ssim': ssims, 'path': writer.path}


if __name__ == '__main__':
    main()
