"""Inputs for tests/test_torch_pose.py: synthetic two-view correspondences
with a known relative pose (x1 = R x0 + t), in pixels of the unposed
demo's intrinsics."""

import numpy as np
from scipy.spatial.transform import Rotation

K_DEMO = np.array([[225.0, 0, 128], [0, 225.0, 128], [0, 0, 1]])


def rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Angle of Ra^T Rb in degrees."""
    return float(np.degrees(np.arccos(np.clip(
        (np.trace(Ra.T @ Rb) - 1) / 2, -1, 1))))


def _project(pts: np.ndarray, R: np.ndarray, t: np.ndarray) -> tuple:
    p0 = pts @ K_DEMO.T
    p1 = (pts @ R.T + t) @ K_DEMO.T
    return p0[:, :2] / p0[:, 2:], p1[:, :2] / p1[:, 2:]


def wide_pair(seed: int, n: int = 300, noise: float = 0.0,
              outliers: float = 0.0) -> tuple:
    """Points over the whole 256^2 view of camera 0 at depths 2-10, a
    generic rotation of 11.7 degrees and a baseline of 0.62; ``noise`` px
    of Gaussian noise on both views, then the first ``outliers`` share of
    view 1's points replaced by uniform ones. (k0, k1, R, t)."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(0, 256, (n, 2))
    depth = rng.uniform(2, 10, n)
    pts = np.c_[(px - 128) / 225 * depth[:, None], depth]
    R = Rotation.from_rotvec([0.05, 0.2, -0.03]).as_matrix()
    t = np.array([0.6, 0.1, 0.15])
    k0, k1 = _project(pts, R, t)
    k0 = k0 + rng.normal(0, noise, k0.shape)
    k1 = k1 + rng.normal(0, noise, k1.shape)
    n_out = int(outliers * n)
    k1[:n_out] = rng.uniform(0, 256, (n_out, 2))
    return k0, k1, R, t


def narrow_pair() -> tuple:
    """tests/test_pose.py:71-99's input: 200 points in a +-1 x +-1 slab
    at depths 4-8, a rotation of 0.15 rad about y, no noise."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (200, 3))
    pts[:, 2] = rng.uniform(4, 8, 200)
    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.5, 0.05, 0.02])
    return (*_project(pts, R, t), R, t)


def scene_pair() -> tuple:
    """tests/test_pose.py:117-170's input: 300 points, a rotation of 0.12
    rad about y, no noise."""
    rng = np.random.default_rng(5)
    a = 0.12
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    t = np.array([0.4, 0.03, 0.05])
    pts = rng.uniform(-1.5, 1.5, (300, 3))
    pts[:, 2] = rng.uniform(4, 9, 300)
    return (*_project(pts, R, t), R, t)
