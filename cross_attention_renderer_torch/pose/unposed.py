"""Unposed two-image pipeline: keypoint matching (on the card) -> RANSAC
essential-matrix pose (host) -> interpolated camera path.

Port of ``cross_attention_renderer_tpu/pose/unposed.py``. The matchers run
in PyTorch on ``device`` and hand numpy back; the pose solve is the port's
own numpy five-point RANSAC (``pose/essential.py``) in place of the JAX
package's OpenCV calls, with their contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from cross_attention_renderer_torch.pose import essential
from cross_attention_renderer_torch.pose.superglue import SuperGlue
from cross_attention_renderer_torch.pose.superpoint import SuperPoint

# Hard-coded unposed-demo intrinsics (load_video_superglue.py:465).
DEMO_INTRINSICS = np.array([[225.0, 0, 128.0, 0], [0, 225.0, 128.0, 0],
                            [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)


@torch.inference_mode()
def match_pair(sp: SuperPoint, sg: SuperGlue, image0: np.ndarray,
               image1: np.ndarray, max_keypoints: int = 1024,
               sinkhorn_iterations: int = 20,
               match_threshold: float = 0.2) -> dict:
    """SuperPoint -> SuperGlue on a grayscale pair (H, W) in [0, 1], with
    the unposed demo's configuration, on the nets' device. Returns the
    matched keypoint arrays (numpy)."""
    imgs = torch.as_tensor(np.stack([image0, image1])[:, None],
                           dtype=torch.float32,
                           device=sp.convPa.weight.device)
    feats = sp(imgs, max_keypoints=max_keypoints)
    data = {f'{k}{i}': feats[k][i:i + 1]
            for k in ('keypoints', 'scores', 'descriptors', 'valid')
            for i in (0, 1)}
    data['image_shape'] = image0.shape[:2]
    out = sg(data, sinkhorn_iterations=sinkhorn_iterations,
             match_threshold=match_threshold)
    k0 = feats['keypoints'][0].cpu().numpy()
    k1 = feats['keypoints'][1].cpu().numpy()
    matches = out['matches0'][0].cpu().numpy()
    conf = out['matching_scores0'][0].cpu().numpy()
    valid = matches > -1
    return {'mkpts0': k0[valid], 'mkpts1': k1[matches[valid]],
            'mconf': conf[valid], 'keypoints0': k0, 'keypoints1': k1,
            'matches': matches}


def estimate_pose(kpts0: np.ndarray, kpts1: np.ndarray, K0: np.ndarray,
                  K1: np.ndarray, thresh: float = 1.0, conf: float = 0.99999,
                  rng: Optional[np.random.Generator] = None
                  ) -> Optional[tuple]:
    """RANSAC essential matrix + cheirality: (R, t, inlier mask) with
    x1 = R x0 + t, or None. Each stacked solution is recovered in turn
    from the mask the previous one left, as OpenCV's in-place mask makes
    the JAX function do. ``rng`` seeds the samples (default: seed 0).

    The JAX function's ``cv2.recoverPose(e, k0, k1, I, 1e9, mask=mask)``
    binds its fifth argument to the R output of the overload that takes
    no distance (it returns four values), which counts only points nearer
    than OpenCV's default of 50; so does this one."""
    if len(kpts0) < 5:
        return None
    f_mean = np.mean([K0[0, 0], K1[1, 1], K0[0, 0], K1[1, 1]])
    norm_thresh = thresh / f_mean
    k0 = (kpts0 - K0[[0, 1], [2, 2]][None]) / K0[[0, 1], [0, 1]][None]
    k1 = (kpts1 - K1[[0, 1], [2, 2]][None]) / K1[[0, 1], [0, 1]][None]
    E, mask = essential.find_essential_mat(k0, k1, norm_thresh, prob=conf,
                                           rng=rng)
    if E is None:
        return None
    best = None
    best_n = 0
    for e in np.split(E, len(E) // 3):
        n, R, t, mask = essential.recover_pose(e, k0, k1, 50.0, mask=mask)
        if n > best_n:
            best_n = n
            best = (R, t[:, 0], mask.ravel() > 0)
    return best


def _rotmat_slerp(r0: np.ndarray, r1: np.ndarray, ts: np.ndarray
                  ) -> np.ndarray:
    """SLERP between two rotation matrices."""
    from scipy.spatial.transform import Rotation, Slerp
    key = Rotation.from_matrix(np.stack([r0, r1]))
    return Slerp([0.0, 1.0], key)(ts).as_matrix()


def make_circle(direction: np.ndarray, n: int, radius: float = 0.03
                ) -> np.ndarray:
    """Spiral translation path around the baseline. Ref:
    load_video_superglue.py:56-80."""
    angles = np.linspace(0, 4 * np.pi, n)
    coord = np.stack([np.cos(angles) * radius, np.sin(angles) * radius,
                      np.linspace(0, 1, n)], axis=-1)
    # seed axis: whichever of x-hat / y-hat is less parallel to `direction`
    # (the reference's x-hat alone NaNs on a baseline along it)
    candidates = np.eye(3)[:2]
    seed = candidates[np.argmin(np.abs(candidates @ direction))]
    axis_1 = seed - (direction * seed).sum() * direction
    axis_1 = axis_1 / np.linalg.norm(axis_1)
    axis_2 = np.cross(axis_1, direction)
    rot = np.stack([axis_1, axis_2, direction], axis=1)
    return (rot @ coord[:, :, None])[:, :, 0]


def rotate_interpolate(poses: np.ndarray, n: int) -> np.ndarray:
    """Slerp rotations + circular-offset translations between two poses;
    drops 2 poses at each end (load_video_superglue.py:83-111)."""
    start, end = poses[0], poses[1]
    direction = end[:3, -1] - start[:3, -1]
    norm = np.linalg.norm(direction)
    trans = make_circle(direction / norm, n, radius=0.05) * norm
    rots = _rotmat_slerp(start[:3, :3], end[:3, :3], np.linspace(0, 1, n))
    out = np.tile(np.eye(4)[None], (n, 1, 1))
    out[:, :3, :3] = rots
    out[:, :3, -1] = trans
    return out[2:-2]


def scene_from_matches(mkpts0: np.ndarray, mkpts1: np.ndarray,
                       im0: np.ndarray, im1: np.ndarray,
                       n_poses: int = 80, sf: float = 1.2) -> dict:
    """Matched keypoints + prepared 256^2 RGB pair -> scene dict (numpy):
    the RANSAC pose, the context cam2worlds (view 0 the identity, view 1
    inv([R|t]) with its translation scaled by 1/sf) and the slerp+circle
    query trajectory (load_video_superglue.py:453-506)."""
    H, W = im0.shape[:2]
    K = DEMO_INTRINSICS[:3, :3]
    ret = estimate_pose(mkpts0, mkpts1, K, K)
    if ret is None:
        raise RuntimeError('pose estimation failed (too few matches)')
    R, t, _ = ret
    pose1 = np.eye(4)
    pose2 = np.eye(4)
    pose2[:3, :3] = R
    pose2[:3, -1] = t
    pose2 = np.linalg.inv(pose2)
    pose2[:3, -1] /= sf

    ctx_c2w = np.stack([pose1, pose2])
    render_poses = rotate_interpolate(ctx_c2w, n_poses)

    ctx_rgb = np.stack([(im0 - 0.5) * 2, (im1 - 0.5) * 2]).astype(np.float32)
    n = render_poses.shape[0]
    i, j = np.meshgrid(np.arange(W), np.arange(H), indexing='xy')
    uv = np.stack([i, j], -1).reshape(-1, 2).astype(np.float32)
    intr = DEMO_INTRINSICS
    return {
        'context': {'rgb': ctx_rgb[None],
                    'cam2world': ctx_c2w[None].astype(np.float32),
                    'intrinsics': np.tile(intr[None, None], (1, 2, 1, 1))},
        'query': {'rgb': np.tile(ctx_rgb[None, :1], (1, n, 1, 1, 1)),
                  'cam2world': render_poses[None].astype(np.float32),
                  'intrinsics': np.tile(intr[None, None], (1, n, 1, 1)),
                  'uv': np.broadcast_to(uv, (1, n) + uv.shape)},
    }


def unposed_scene(sp: Optional[SuperPoint], sg: Optional[SuperGlue],
                  im0: np.ndarray, im1: np.ndarray, n_poses: int = 80,
                  sf: float = 1.2, device='cuda') -> dict:
    """Two RGB images in [0, 1] -> scene dict with the interpolated
    76-pose query trajectory (load_video_superglue.py:419-506). With
    ``sp`` or ``sg`` None, the weights-free classical frontend
    (``pose/classical.py``) matches on ``device`` instead of SuperPoint +
    SuperGlue."""
    from cross_attention_renderer_torch.data.realestate import _resize
    H = W = 256

    def prep(im):
        h, w = im.shape[:2]
        if w > h:
            off = (w - h) // 2
            im = im[:, off:off + h]
        return _resize(im, (H, W))

    im0, im1 = prep(im0), prep(im1)
    gray0 = (im0 @ np.array([0.2125, 0.7154, 0.0721])).astype(np.float32)
    gray1 = (im1 @ np.array([0.2125, 0.7154, 0.0721])).astype(np.float32)

    if sp is None or sg is None:
        from cross_attention_renderer_torch.pose.classical import (
            match_pair_classical)
        m = match_pair_classical(gray0, gray1, device=device)
    else:
        m = match_pair(sp, sg, gray0, gray1)
    return scene_from_matches(m['mkpts0'], m['mkpts1'], im0, im1,
                              n_poses=n_poses, sf=sf)
