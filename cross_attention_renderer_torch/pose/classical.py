"""Classical weights-free matching frontend: Harris corners + NCC patches.

Port of ``cross_attention_renderer_tpu/pose/classical.py``, the drop-in for
the SuperPoint + SuperGlue frontend of the unposed path when no learned
weights are given: Shi-Tomasi response from central-difference gradients
and box-summed structure tensors, iterated max-pool NMS
(:func:`superpoint.simple_nms`), a fixed top-K with a relative floor and
subpixel parabola refinement, zero-mean unit-norm patch descriptors, and
mutual nearest-neighbour NCC matching with an absolute floor and a
second-best margin. Only the RANSAC pose stays on the host
(``pose/essential.py``).

The box filter adds its 49 shifted copies in one fixed order, so the
response, and with it the keypoints, come out bit for bit the same on the
card and on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cross_attention_renderer_torch.pose.superpoint import simple_nms, top_k

Tensor = torch.Tensor


def _box_filter(x: Tensor, radius: int) -> Tensor:
    """(H, W) box sum over a (2r+1)^2 window, zero-padded SAME edges;
    unnormalized (Harris reads ratios of these sums)."""
    H, W = x.shape
    k = 2 * radius + 1
    xp = torch.nn.functional.pad(x, (radius,) * 4)
    out = torch.zeros_like(x)
    for dy in range(k):
        for dx in range(k):
            out = out + xp[dy:dy + H, dx:dx + W]
    return out


def harris_response(gray: Tensor, window_radius: int = 3) -> Tensor:
    """Shi-Tomasi corner response (min eigenvalue of the structure tensor)
    of an (H, W) image in [0, 1]. ``torch.gradient`` is central inside and
    one-sided at the edges, as ``jnp.gradient`` is."""
    iy, ix = torch.gradient(gray)
    sxx = _box_filter(ix * ix, window_radius)
    syy = _box_filter(iy * iy, window_radius)
    sxy = _box_filter(ix * iy, window_radius)
    half_tr = 0.5 * (sxx + syy)
    disc = torch.sqrt(torch.clamp(0.25 * (sxx - syy) ** 2 + sxy * sxy,
                                  min=0.0))
    return half_tr - disc


def _parabola(rm: Tensor, r0: Tensor, rp: Tensor) -> Tensor:
    """Argmax offset of the parabola through three samples, in +-0.5."""
    denom = rm - 2.0 * r0 + rp
    flat = denom.abs() < 1e-20
    off = 0.5 * (rm - rp) / torch.where(flat, torch.ones_like(denom), denom)
    return torch.where(flat, torch.zeros_like(off), off.clamp(-0.5, 0.5))


def detect(gray: Tensor, max_keypoints: int = 512, nms_radius: int = 4,
           border: int = 12) -> tuple:
    """Fixed-K Harris keypoints of an (H, W) image: (kpts_xy (K, 2),
    scores (K,), valid (K,) bool); invalid slots are top-K padding below
    the response floor."""
    H, W = gray.shape
    raw = harris_response(gray)
    r = simple_nms(raw[None], nms_radius)[0]
    yy = torch.arange(H, device=gray.device)[:, None]
    xx = torch.arange(W, device=gray.device)[None, :]
    inside = ((xx >= border) & (xx < W - border)
              & (yy >= border) & (yy < H - border))
    r = torch.where(inside, r, torch.full((), -torch.inf,
                                          device=gray.device))
    scores, idx = top_k(r.reshape(-1), max_keypoints)
    iy = idx // W
    ix = idx % W
    # subpixel: a parabola along each axis through the raw response
    step = torch.tensor([-1, 0, 1], device=gray.device)
    g = raw[torch.clamp(iy[:, None] + step, 0, H - 1), ix[:, None]]
    dy = _parabola(g[:, 0], g[:, 1], g[:, 2])
    g = raw[iy[:, None], torch.clamp(ix[:, None] + step, 0, W - 1)]
    dx = _parabola(g[:, 0], g[:, 1], g[:, 2])
    # relative floor: corners within 3 decades of the strongest one
    valid = scores > torch.clamp(scores[0] * 1e-3, min=1e-12)
    kxy = torch.stack([ix.float() + dx, iy.float() + dy], -1)
    return kxy, scores, valid


def describe(gray: Tensor, kpts_xy: Tensor, patch_radius: int = 7) -> Tensor:
    """Zero-mean unit-norm (K, (2r+1)^2) patch descriptors at the rounded
    keypoints; a patch that would leave the image is moved inside it (its
    start clamped, as ``lax.dynamic_slice`` clamps)."""
    H, W = gray.shape
    p = 2 * patch_radius + 1
    y = torch.clamp(torch.round(kpts_xy[:, 1]).long() - patch_radius,
                    0, H - p)
    x = torch.clamp(torch.round(kpts_xy[:, 0]).long() - patch_radius,
                    0, W - p)
    offs = torch.arange(p, device=gray.device)
    v = gray[(y[:, None] + offs)[:, :, None],
             (x[:, None] + offs)[:, None, :]].reshape(len(kpts_xy), -1)
    v = v - v.mean(dim=1, keepdim=True)
    return v / torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True),
                           min=1e-6)


def match_descriptors(d0: Tensor, d1: Tensor, valid0: Tensor, valid1: Tensor,
                      min_score: float = 0.6, margin: float = 0.05) -> tuple:
    """Mutual-nearest NCC matching with an absolute floor and a second-best
    margin. Returns (matches0 (K,) int32, index into d1 or -1; scores0
    (K,))."""
    sim = d0 @ d1.T
    sim = torch.where(valid0[:, None] & valid1[None, :], sim,
                      torch.full((), -2.0, device=sim.device))
    best1 = sim.argmax(dim=1)
    s_best = sim.amax(dim=1)
    rows = torch.arange(sim.shape[0], device=sim.device)
    s_second = sim.index_put((rows, best1),
                             torch.full((), -2.0, device=sim.device)
                             ).amax(dim=1)
    best0 = sim.argmax(dim=0)
    mutual = best0[best1] == rows
    ok = mutual & (s_best > min_score) & (s_best - s_second > margin)
    return torch.where(ok, best1, -1).to(torch.int32), s_best


@torch.inference_mode()
def match_pair_classical(image0: np.ndarray, image1: np.ndarray,
                         max_keypoints: int = 512, min_score: float = 0.6,
                         device='cuda') -> dict:
    """Grayscale pair in [0, 1] -> the matched-keypoint dict of
    ``unposed.match_pair`` (numpy), computed on ``device``."""
    g0 = torch.as_tensor(np.asarray(image0, np.float32), device=device)
    g1 = torch.as_tensor(np.asarray(image1, np.float32), device=device)
    k0, _, v0 = detect(g0, max_keypoints)
    k1, _, v1 = detect(g1, max_keypoints)
    m, conf = match_descriptors(describe(g0, k0), describe(g1, k1), v0, v1,
                                min_score=min_score)
    k0, k1, m, conf = (t.cpu().numpy() for t in (k0, k1, m, conf))
    valid = m > -1
    return {'mkpts0': k0[valid], 'mkpts1': k1[m[valid]],
            'mconf': conf[valid], 'keypoints0': k0, 'keypoints1': k1,
            'matches': m}
