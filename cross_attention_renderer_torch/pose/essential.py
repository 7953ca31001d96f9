"""Relative pose from point matches: five-point RANSAC and cheirality, in
numpy on the host.

The port's own replacement for the two OpenCV calls of the JAX package's
``estimate_pose``: ``cv2.findEssentialMat(k0, k1, I, method=cv2.RANSAC,
prob=..., threshold=...)`` (:func:`find_essential_mat`) and
``cv2.recoverPose(E, k0, k1, I, distanceThresh, mask=mask)``
(:func:`recover_pose`), with their contracts:

* the minimal solver is the five-point one: the essential matrices of five
  matches span the null space of a 5x9 system, E = x X + y Y + z Z + W,
  and the ten cubic constraints det(E) = 0 and 2 E E^T E - tr(E E^T) E = 0
  in the 20 monomials of degree <= 3 are eliminated (the 10x10 block of
  cubic monomials) to an action matrix of multiplication by x on the
  quotient basis {x^2, xy, xz, y^2, yz, z^2, x, y, z, 1}, whose real
  eigenvectors are the solutions (Stewenius' formulation), batched over
  all hypotheses;
* RANSAC scores each model by its inliers, the matches whose Sampson
  distance (in f32, as OpenCV stores it) is at most threshold^2, keeps a
  model only when it has more inliers than the best so far (at least 5),
  and after each improvement shrinks the iteration count to
  log(1 - prob) / log(1 - w^5) (w the inlier share) under the cap
  ``max_iters`` = 1000; with exactly five matches every solution is
  returned, stacked (3k, 3), and all five are inliers. No refinement
  follows. The samples come from a seeded ``numpy.random.Generator``;
* pose recovery decomposes E into its four (R, t), triangulates every
  match by the linear (DLT) method for each, counts the matches of the
  mask that lie in front of both cameras and nearer than
  ``distance_thresh``, keeps the first candidate with the most, and
  returns that candidate's mask (the one OpenCV writes back into the
  array it was given).
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

_DBL_MIN = np.finfo(np.float64).tiny
MODEL_POINTS = 5
_BATCH = 64         # hypotheses solved at once

# Monomials in (x, y, z, 1) as sorted index tuples, 3 standing for 1.
_DEG2 = list(itertools.combinations_with_replacement(range(4), 2))
_DEG3 = list(itertools.combinations_with_replacement(range(4), 3))
_T11 = np.zeros((4, 4, len(_DEG2)))     # linear x linear -> quadratic
for _a, _b in itertools.product(range(4), repeat=2):
    _T11[_a, _b, _DEG2.index(tuple(sorted((_a, _b))))] = 1
_T21 = np.zeros((len(_DEG2), 4, len(_DEG3)))   # quadratic x linear -> cubic
for _i, _c in itertools.product(range(len(_DEG2)), range(4)):
    _T21[_i, _c, _DEG3.index(tuple(sorted(_DEG2[_i] + (_c,))))] = 1
_CUBIC = [m for m in _DEG3 if 3 not in m]               # 10, eliminated
_BASIS = ([m for m in _DEG3 if m.count(3) == 1]         # x^2 ... z^2
          + [(0, 3, 3), (1, 3, 3), (2, 3, 3), (3, 3, 3)])   # x, y, z, 1
_CUBIC_COLS = [_DEG3.index(m) for m in _CUBIC]
_BASIS_COLS = [_DEG3.index(m) for m in _BASIS]


def _action_rows() -> tuple:
    """Multiplication by x on the basis: for each basis monomial b, x*b is
    either a cubic (its row is minus the eliminated row of that cubic) or
    another basis monomial (a unit row)."""
    from_cubic, to_basis = [], []
    for row, m in enumerate(_BASIS):
        xm = list(m)
        xm[xm.index(3)] = 0
        xm = tuple(sorted(xm))
        if xm in _CUBIC:
            from_cubic.append((row, _CUBIC.index(xm)))
        else:
            to_basis.append((row, _BASIS.index(xm)))
    return (np.array(from_cubic).T, np.array(to_basis).T)


_FROM_CUBIC, _TO_BASIS = _action_rows()
_IY, _IZ, _I1 = (_BASIS.index(m) for m in ((1, 3, 3), (2, 3, 3), (3, 3, 3)))


def _homogeneous(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.ones(x.shape[:-1] + (1,))], axis=-1)


def five_point(x0: np.ndarray, x1: np.ndarray) -> tuple:
    """Every essential matrix of N five-match samples: x0, x1 (N, 5, 2) in
    normalized coordinates, x1^T E x0 = 0. Returns (E (N, 10, 3, 3), unit
    Frobenius norm, and ok (N, 10) bool, False on padding slots)."""
    N = x0.shape[0]
    h0, h1 = _homogeneous(x0), _homogeneous(x1)
    A = (h1[..., :, None] * h0[..., None, :]).reshape(N, 5, 9)
    null = np.linalg.svd(A, full_matrices=True)[2][:, 5:]     # (N, 4, 9)
    E = null.reshape(N, 4, 3, 3).transpose(0, 2, 3, 1)  # E_ij in x, y, z, 1

    def mul11(p, q):
        return np.einsum('...a,...b,abm->...m', p, q, _T11)

    def mul21(p, q):
        return np.einsum('...i,...c,icm->...m', p, q, _T21)

    det = (mul21(mul11(E[:, 1, 1], E[:, 2, 2])
                 - mul11(E[:, 1, 2], E[:, 2, 1]), E[:, 0, 0])
           - mul21(mul11(E[:, 1, 0], E[:, 2, 2])
                   - mul11(E[:, 1, 2], E[:, 2, 0]), E[:, 0, 1])
           + mul21(mul11(E[:, 1, 0], E[:, 2, 1])
                   - mul11(E[:, 1, 1], E[:, 2, 0]), E[:, 0, 2]))
    EEt = np.einsum('nika,njkb,abm->nijm', E, E, _T11)
    trace = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]
    cons = (2 * np.einsum('nikp,nkjc,pcm->nijm', EEt, E, _T21)
            - np.einsum('np,nijc,pcm->nijm', trace, E, _T21))
    M = np.concatenate([det[:, None], cons.reshape(N, 9, -1)], axis=1)

    lhs, rhs = M[:, :, _CUBIC_COLS], M[:, :, _BASIS_COLS]
    ok = np.isfinite(M).all(axis=(1, 2))
    ok[ok] = np.linalg.cond(lhs[ok]) < 1e12
    lhs = np.where(ok[:, None, None], lhs, np.eye(10))
    G = np.linalg.solve(lhs, rhs)             # cubic_k = -G[k] . basis
    act = np.zeros((N, 10, 10))
    act[:, _FROM_CUBIC[0]] = -G[:, _FROM_CUBIC[1]]
    act[:, _TO_BASIS[0], _TO_BASIS[1]] = 1.0
    act = np.where(ok[:, None, None], act, 0.0)
    w, vec = np.linalg.eig(act)               # vec[:, :, k] for w[:, k]
    real = (w.imag == 0) & ok[:, None]
    vec = vec.real
    one = vec[:, _I1]
    real &= np.abs(one) > 1e-12 * np.abs(vec).max(axis=1)
    one = np.where(real, one, 1.0)
    xyz = np.stack([w.real, vec[:, _IY] / one, vec[:, _IZ] / one,
                    np.ones_like(one)], axis=-1)        # (N, 10, 4)
    Es = np.einsum('nkv,nvij->nkij', xyz, null.reshape(N, 4, 3, 3))
    Es /= np.maximum(np.linalg.norm(Es, axis=(2, 3), keepdims=True), 1e-300)
    return np.where(real[..., None, None], Es, 0.0), real


def sampson_error(E: np.ndarray, x0: np.ndarray, x1: np.ndarray
                  ) -> np.ndarray:
    """Squared Sampson distance (M, P) of P matches to M essential matrices
    (M, 3, 3), in f32 as OpenCV stores it."""
    h0, h1 = _homogeneous(x0), _homogeneous(x1)
    Ex0 = np.einsum('mij,pj->mpi', E, h0)
    Etx1 = np.einsum('mji,pj->mpi', E, h1)
    num = np.einsum('pi,mpi->mp', h1, Ex0) ** 2
    den = (Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2
           + Etx1[..., 1] ** 2)
    with np.errstate(divide='ignore', invalid='ignore'):
        return (num / den).astype(np.float32)


def update_num_iters(p: float, ep: float, model_points: int,
                     max_iters: int) -> int:
    """RANSAC's adaptive iteration count: enough samples to draw one
    all-inlier sample with probability ``p`` at an outlier share ``ep``,
    never above ``max_iters``."""
    p = min(max(p, 0.0), 1.0)
    ep = min(max(ep, 0.0), 1.0)
    num = max(1.0 - p, _DBL_MIN)
    denom = 1.0 - (1.0 - ep) ** model_points
    if denom < _DBL_MIN:
        return 0
    num, denom = np.log(num), np.log(denom)
    if denom >= 0 or -num >= max_iters * -denom:
        return max_iters
    return int(round(num / denom))


def find_essential_mat(x0: np.ndarray, x1: np.ndarray, threshold: float,
                       prob: float = 0.999, max_iters: int = 1000,
                       rng: Optional[np.random.Generator] = None) -> tuple:
    """RANSAC essential matrix of matches x0 -> x1 (P, 2), normalized
    coordinates. Returns (E (3, 3), or (3k, 3) for exactly five matches;
    inlier mask (P, 1) uint8), or (None, None) without a model.
    Hypotheses are solved in batches; the stopping rule is applied after
    each in order, as if they came one at a time."""
    x0 = np.asarray(x0, np.float64).reshape(-1, 2)
    x1 = np.asarray(x1, np.float64).reshape(-1, 2)
    count = len(x0)
    if count < MODEL_POINTS:
        return None, None
    if count == MODEL_POINTS:
        Es, ok = five_point(x0[None], x1[None])
        if not ok.any():
            return None, None
        return Es[0][ok[0]].reshape(-1, 3), np.ones((count, 1), np.uint8)
    rng = np.random.default_rng(0) if rng is None else rng
    thr2 = np.float32(threshold * threshold)
    best_count, best_E, best_mask = 0, None, None
    niters, it = max_iters, 0
    while it < niters:
        n = min(_BATCH, niters - it)
        idx = np.argpartition(rng.random((n, count)), MODEL_POINTS,
                              axis=1)[:, :MODEL_POINTS]
        Es, ok = five_point(x0[idx], x1[idx])
        inliers = sampson_error(Es.reshape(-1, 3, 3), x0, x1) <= thr2
        good = np.where(ok.ravel(), inliers.sum(axis=1), -1).reshape(n, -1)
        for i in range(n):
            if it >= niters:
                break
            it += 1
            j = int(good[i].argmax())
            if good[i, j] > max(best_count, MODEL_POINTS - 1):
                best_count = int(good[i, j])
                best_E = Es[i, j]
                best_mask = inliers[i * good.shape[1] + j]
                niters = update_num_iters(prob, (count - best_count) / count,
                                          MODEL_POINTS, niters)
    if best_E is None:
        return None, None
    return best_E, best_mask.astype(np.uint8)[:, None]


def decompose_essential(E: np.ndarray) -> tuple:
    """(R1, R2, t) of E = [t]x R: the two rotations and the unit
    translation (up to sign)."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0.0, 1, 0], [-1, 0, 0], [0, 0, 1]])
    return U @ W @ Vt, U @ W.T @ Vt, U[:, 2].copy()


def triangulate(P0: np.ndarray, P1: np.ndarray, x0: np.ndarray,
                x1: np.ndarray) -> np.ndarray:
    """Linear (DLT) triangulation of matches (P, 2) seen by cameras (3, 4):
    homogeneous points (P, 4), each of either sign."""
    A = np.stack([x0[:, :1] * P0[2] - P0[0], x0[:, 1:] * P0[2] - P0[1],
                  x1[:, :1] * P1[2] - P1[0], x1[:, 1:] * P1[2] - P1[1]],
                 axis=1)
    return np.linalg.svd(A)[2][:, -1]


def recover_pose(E: np.ndarray, x0: np.ndarray, x1: np.ndarray,
                 distance_thresh: float = 50.0,
                 mask: Optional[np.ndarray] = None) -> tuple:
    """The (R, t) of E's four candidates with the most matches in front of
    both cameras (x1 = R x0 + t, |t| = 1). Returns (count, R, t (3, 1),
    mask (P, 1) uint8 of those matches), the count and mask limited to
    ``mask``'s matches where one is given."""
    x0 = np.asarray(x0, np.float64).reshape(-1, 2)
    x1 = np.asarray(x1, np.float64).reshape(-1, 2)
    R1, R2, t = decompose_essential(E)
    P0 = np.eye(3, 4)
    best = None
    for R, tt in ((R1, t), (R2, t), (R1, -t), (R2, -t)):
        P1 = np.concatenate([R, tt[:, None]], axis=1)
        Q = triangulate(P0, P1, x0, x1)
        front = Q[:, 2] * Q[:, 3] > 0
        with np.errstate(divide='ignore', invalid='ignore'):
            Q = Q / Q[:, 3:]
            depth1 = Q @ P1[2]
            front &= ((Q[:, 2] < distance_thresh) & (depth1 > 0)
                      & (depth1 < distance_thresh))
        if mask is not None:
            front &= np.asarray(mask).ravel() != 0
        n = int(front.sum())
        if best is None or n > best[0]:
            best = (n, R, tt[:, None], front.astype(np.uint8)[:, None])
    return best
