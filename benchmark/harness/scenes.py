"""Posed scenes drawn on the device: the program's scene-dict layout, with
the poses of upstream's wide-baseline pairs as the repo's synthetic
scenes draw them (context cameras on a radius-2 shell looking at the
origin, the query camera among them), rewritten for batched draws on the
card."""

from __future__ import annotations

import torch


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def look_at(eye, at):
    """(..., 4, 4) cam2world of cameras at ``eye`` looking at ``at``, y
    up (OpenCV axes: z forward)."""
    up = torch.tensor([0.0, 1.0, 0.0], device=eye.device).expand_as(eye)
    z = _normalize(at - eye)
    x = _normalize(torch.linalg.cross(up, z, dim=-1))
    y = torch.linalg.cross(z, x, dim=-1)
    m = torch.eye(4, device=eye.device).expand(*eye.shape[:-1], 4, 4)
    m = m.clone()
    m[..., :3, 0], m[..., :3, 1], m[..., :3, 2], m[..., :3, 3] = x, y, z, eye
    return m


def intrinsics(H: int, W: int, device) -> torch.Tensor:
    k = torch.eye(4, device=device)
    k[0, 0] = k[1, 1] = 0.98 * H
    k[0, 2], k[1, 2] = W / 2.0, H / 2.0
    return k


def pixel_grid(H: int, W: int, device) -> torch.Tensor:
    """(1, 1, H*W, 2) pixel coordinates (x, y) of the whole image."""
    j, i = torch.meshgrid(torch.arange(H, device=device),
                          torch.arange(W, device=device), indexing='ij')
    return torch.stack([i, j], -1).reshape(1, 1, H * W, 2).float()


def draw(g: torch.Generator, n: int, n_view: int, H: int, W: int,
         rays: int | None, device) -> dict:
    """``n`` scenes: context views with random RGB in [-1, 1], and either
    the whole query image (``rays`` None) or ``rays`` random query pixels
    with random target RGB."""
    def randn(*shape):
        return torch.randn(*shape, generator=g, device=device)

    base = randn(n, 3)
    base = 2.0 * base / torch.linalg.vector_norm(base, dim=-1, keepdim=True)
    eyes = base[:, None] + 0.35 * randn(n, n_view, 3)
    ctx = look_at(eyes, 0.05 * randn(n, n_view, 3))
    qry = look_at(base + 0.2 * randn(n, 3), 0.05 * randn(n, 3))[:, None]
    K = intrinsics(H, W, device)
    rgb = torch.rand(n, n_view, H, W, 3, generator=g, device=device)
    rgb.mul_(2.0).sub_(1.0)
    if rays is None:
        uv = pixel_grid(H, W, device).expand(n, 1, H * W, 2)
        gt = None
    else:
        uv = torch.rand(n, 1, rays, 2, generator=g, device=device) * (
            min(H, W) - 1)
        gt = torch.rand(n, 1, rays, 3, generator=g, device=device) * 2 - 1
    query = {'cam2world': qry, 'intrinsics': K.expand(n, 1, 4, 4),
             'uv': uv, 'mask': torch.zeros(n, device=device)}
    if gt is not None:
        query['rgb'] = gt
    return {'context': {'rgb': rgb, 'cam2world': ctx,
                        'intrinsics': K.expand(n, n_view, 4, 4)},
            'query': query}


def take(scenes: dict, start: int, stop: int) -> dict:
    """Scenes ``start:stop`` of a drawn batch (views, no copy)."""
    return {part: {k: v[start:stop] for k, v in d.items()}
            for part, d in scenes.items()}


def count(scenes: dict) -> int:
    return scenes['context']['rgb'].shape[0]
