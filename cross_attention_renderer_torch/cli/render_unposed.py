"""Unposed two-image demo CLI.

Port of ``cross_attention_renderer_tpu/cli/render_unposed.py``, the
replacement for the reference's ``render_unposed_traj.py``: two arbitrary
images -> keypoint matching on the card (SuperPoint + SuperGlue when
converted weights are given, npz files of ``pose.superpoint.
convert_weights`` / ``pose.superglue.convert_weights``; otherwise the
weights-free classical Harris + NCC frontend) -> the five-point RANSAC pose
on the host (``pose/essential.py``; no OpenCV) -> the 76-pose interpolated
trajectory -> one encode, then each frame through ``make_image_renderer``
-> mp4 (or PNG frames). Reading the two images and writing the video need
the imageio package; :func:`render_unposed`, which ``main`` drives, takes
arrays and a frame sink and needs neither. Usage:

  python -m cross_attention_renderer_torch.cli.render_unposed \\
      --im1 a.png --im2 b.png --out unposed.mp4
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from cross_attention_renderer_torch.cli.common import (
    FrameWriter, base_parser, build_model, restore_params, to_uint8)
from cross_attention_renderer_torch.pose.superglue import SuperGlue
from cross_attention_renderer_torch.pose.superpoint import SuperPoint
from cross_attention_renderer_torch.pose.unposed import unposed_scene
from cross_attention_renderer_torch.train.evaluation import (
    make_image_renderer)
from cross_attention_renderer_torch.train.trainer import (
    TrainConfig, create_train_state)
from cross_attention_renderer_torch.utils.image import imageio_v2


def load_frontend(superpoint_weights: Optional[str],
                  superglue_weights: Optional[str], device) -> tuple:
    """(SuperPoint, SuperGlue) modules from the two npz files, or (None,
    None) for the classical frontend when neither is given; one alone
    raises SystemExit (the learned frontend is a pipeline)."""
    if superpoint_weights and superglue_weights:
        return (SuperPoint.from_params(dict(np.load(superpoint_weights)),
                                       device=device),
                SuperGlue.from_params(dict(np.load(superglue_weights)),
                                      device=device))
    if superpoint_weights or superglue_weights:
        raise SystemExit(
            'error: --superpoint_weights and --superglue_weights must be '
            'given together (the learned frontend is a pipeline); omit '
            'both for the classical Harris+NCC frontend')
    print('no SuperPoint/SuperGlue weights given -> classical Harris+NCC '
          'frontend (pose/classical.py)', flush=True)
    return None, None


def render_unposed(model, im0: np.ndarray, im1: np.ndarray,
                   sink: Callable, superpoint=None, superglue=None,
                   n_frames: int = 80, sf: float = 1.2,
                   ray_chunk: int = 8192) -> dict:
    """Two RGB images in [0, 1] -> ``sink(rgb, i, n)`` for each of the n
    frames of the unposed trajectory, rgb (H, W, 3) the model's output on
    its device. Matching and rendering run on the model's device, the pose
    solve on the host. Returns the scene dict (numpy) that was
    rendered."""
    device = next(model.parameters()).device
    traj = unposed_scene(superpoint, superglue, im0, im1, n_poses=n_frames,
                         sf=sf, device=device)
    n = traj['query']['cam2world'].shape[1]
    H = W = traj['context']['rgb'].shape[-3]

    def tensor(x):
        return torch.tensor(np.ascontiguousarray(x), device=device)

    context = {k: tensor(v) for k, v in traj['context'].items()}
    q = traj['query']
    uv = tensor(q['uv'][:, :1])

    def frame_scene(i):
        return {'context': context,
                'query': {'cam2world': tensor(q['cam2world'][:, i:i + 1]),
                          'intrinsics': tensor(q['intrinsics'][:, i:i + 1]),
                          'uv': uv}}

    encode, render_image = make_image_renderer(
        model, max(1, (H * W) // ray_chunk))
    z = encode(frame_scene(0))
    for i in range(n):
        rgb, _ = render_image(frame_scene(i), z)
        sink(rgb.reshape(H, W, 3), i, n)
    return traj


def main(argv=None) -> dict:
    """Renders the trajectory to a video; returns {'path': where it went,
    'frames': how many}."""
    p = base_parser('Render a trajectory from an unposed image pair')
    p.add_argument('--im1', type=str, required=True)
    p.add_argument('--im2', type=str, required=True)
    p.add_argument('--superpoint_weights', type=str, default=None,
                   help='converted SuperPoint npz; omit (with '
                        '--superglue_weights) for the classical frontend')
    p.add_argument('--superglue_weights', type=str, default=None)
    p.add_argument('--out', type=str, default='unposed.mp4')
    p.add_argument('--ray_chunk', type=int, default=8192)
    p.add_argument('--sf', type=float, default=1.2,
                   help='translation scale (load_video_superglue.py:481)')
    p.add_argument('--n_frames', type=int, default=80,
                   help='trajectory poses (reference: 80, '
                        'load_video_superglue.py:491)')
    opt = p.parse_args(argv)

    superpoint, superglue = load_frontend(
        opt.superpoint_weights, opt.superglue_weights, opt.device)
    imageio = imageio_v2('reading --im1 / --im2')
    im0 = np.asarray(imageio.imread(opt.im1), np.float32) / 255.0
    im1 = np.asarray(imageio.imread(opt.im2), np.float32) / 255.0

    model = build_model(opt).eval()
    if opt.checkpoint_path:
        restore_params(create_train_state(model, TrainConfig()),
                       opt.checkpoint_path)
    writer = FrameWriter(opt.out, fps=10)

    def sink(rgb, i, n):
        writer.append(to_uint8((rgb.float() + 1) * 0.5))
        print(f'frame {i + 1}/{n}', flush=True)

    render_unposed(model, im0, im1, sink, superpoint, superglue,
                   n_frames=opt.n_frames, sf=opt.sf, ray_chunk=opt.ray_chunk)
    writer.close()
    print(f'wrote {writer.path}')
    return {'path': writer.path, 'frames': writer.count}


if __name__ == '__main__':
    main()
