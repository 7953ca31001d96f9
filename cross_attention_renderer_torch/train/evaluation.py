"""Evaluation: full-image rendering with the encoder latent computed once
per scene, and the reference's per-scene metrics.

Port of ``make_chunk_renderer``, ``render_full_image``,
``make_scan_renderer``, ``make_summary_renderer``, ``make_image_renderer``
(its dense renderer) and ``evaluate_scene`` of
``cross_attention_renderer_tpu/train/evaluation.py`` (reference eval
protocol, eval_realestate10k.py:131-199). PyTorch runs
eagerly, so the JAX ``lax.scan`` over ray blocks is a Python loop; the
packed cell tables, where the model reads them, are still built once per
image. The parameters live in the model, so no entry point takes them.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cross_attention_renderer_torch.ops.grid_sample import pack_pyramid
from cross_attention_renderer_torch.utils.metrics import eval_image_metrics

Tensor = torch.Tensor


def make_chunk_renderer(model) -> tuple[Callable, Callable]:
    """(encode(scene) -> z, render_chunk(scene, z, uv) -> (rgb, valid)):
    one forward a chunk of query rays, with the latent ``z`` cached."""

    @torch.inference_mode()
    def encode(scene):
        return model.encode(scene)

    @torch.inference_mode()
    def render_chunk(scene, z, uv):
        s = dict(scene)
        s['query'] = dict(scene['query'], uv=uv)
        out = model(s, z=z)
        return out['rgb'], out['valid_mask']

    return encode, render_chunk


def render_full_image(render_chunk: Callable, scene: dict, z,
                      uv_full: Tensor, n_chunks: int
                      ) -> tuple[Tensor, Tensor]:
    """All rays of ``uv_full`` (B, Q, n_rays, 2) in ``n_chunks`` equal
    chunks of ``render_chunk(scene, z, uv) -> (rgb, valid)``, with the
    latent ``z`` cached."""
    n_rays = uv_full.shape[2]
    if n_rays % n_chunks:
        raise ValueError(f'{n_chunks} chunks do not divide {n_rays} rays')
    size = n_rays // n_chunks
    rgbs, valids = [], []
    for i in range(n_chunks):
        rgb, valid = render_chunk(scene, z,
                                  uv_full[:, :, i * size:(i + 1) * size])
        rgbs.append(rgb)
        valids.append(valid)
    return torch.cat(rgbs, dim=2), torch.cat(valids, dim=1)


def make_scan_renderer(model, n_chunks: int) -> Callable:
    """Whole-image renderer: ``fn(scene, z, uv_full) -> (rgb (B, Q, n, 3),
    valid (B, n, 1))``. Where the model reads the pyramid's cell tables,
    they are packed once per image (evaluation.py:87-106); then the ray
    blocks render in turn."""

    @torch.inference_mode()
    def render_image(scene, z, uv_full):
        zp = pack_pyramid(z) if model.uses_packed_tables else None

        def render_chunk(scene, z, uv):
            s = dict(scene)
            s['query'] = dict(scene['query'], uv=uv)
            out = model(s, z=z, z_packed=zp)
            return out['rgb'], out['valid_mask']

        return render_full_image(render_chunk, scene, z, uv_full, n_chunks)

    return render_image


def make_summary_renderer(model, n_chunks: int) -> Callable:
    """Whole-image renderer that also returns the per-ray fields the
    training summaries read: ``fn(scene, z, uv_full) -> model output dict``
    with the entries of one forward over all rays, rgb (B, Q, R, 3),
    valid_mask and depth_ray (B, R, 1), at_wt (B, V, R, P) and pixel_val
    (B, V, R, P, 2) (JAX ``make_summary_renderer``,
    evaluation.py:130-173). The rays render in ``n_chunks`` blocks, with
    the cell tables, where the model reads them, packed once per image as
    :func:`make_scan_renderer` packs them."""
    keys = ('rgb', 'valid_mask', 'depth_ray', 'at_wt', 'pixel_val')
    # the axis along which each field's rays lie
    ray_axis = {'rgb': 2, 'valid_mask': 1, 'depth_ray': 1, 'at_wt': 2,
                'pixel_val': 2}

    @torch.inference_mode()
    def render_image(scene, z, uv_full):
        n_rays = uv_full.shape[2]
        if n_rays % n_chunks:
            raise ValueError(f'{n_chunks} chunks do not divide {n_rays} '
                             'rays')
        size = n_rays // n_chunks
        zp = pack_pyramid(z) if model.uses_packed_tables else None
        parts = {k: [] for k in keys}
        for i in range(n_chunks):
            s = dict(scene)
            s['query'] = dict(scene['query'],
                              uv=uv_full[:, :, i * size:(i + 1) * size])
            out = model(s, z=z, z_packed=zp)
            for k in keys:
                parts[k].append(out[k])
        return {k: torch.cat(v, dim=ray_axis[k]) for k, v in parts.items()}

    return render_image


def make_image_renderer(model, n_chunks: int,
                        pruned: Optional[tuple] = None,
                        narrow: Optional[tuple] = None,
                        q8: bool = False) -> tuple[Callable, Callable]:
    """(encode(scene) -> z, render_image(scene, z) -> (rgb, valid)): the
    scene's full query uv grid in ``n_chunks`` ray blocks
    (:func:`make_scan_renderer`). ``pruned``, ``narrow`` and ``q8`` (the
    JAX package's fast-eval renderers) are not ported yet and raise."""
    if pruned is not None or narrow is not None or q8:
        raise NotImplementedError(
            'the fast-eval renderers (pruned, narrow, q8) are not ported '
            'yet: ROADMAP.md Queue A 6')
    encode, _ = make_chunk_renderer(model)
    scan = make_scan_renderer(model, n_chunks)
    return encode, lambda scene, z: scan(scene, z, scene['query']['uv'])


def evaluate_scene(model, scene: dict, H: int = 256, W: int = 256,
                   n_chunks: int = 8, lpips_fn: Optional[Callable] = None,
                   renderer=None) -> dict:
    """The reference protocol's evaluation of one scene with a full-image
    query uv grid (eval_realestate10k.py:131-199): encode once, render the
    image, grey out invalid rays in both images, then MSE, PSNR, SSIM and,
    with ``lpips_fn`` (``losses.lpips.load_lpips``), LPIPS. Returns numpy
    values: the metrics and the greyed images ``pred`` and ``target`` in
    [0, 1]. ``renderer`` is an (encode, render_image) pair from
    :func:`make_image_renderer`; the metrics run in f32 on the image's
    device."""
    if renderer is None:
        renderer = make_image_renderer(model, n_chunks)
    encode, render_image = renderer
    z = encode(scene)
    rgb, valid = render_image(scene, z)
    pred01 = (rgb.float().reshape(H, W, 3) + 1.0) * 0.5
    target01 = (scene['query']['rgb'].float().reshape(H, W, 3) + 1.0) * 0.5
    mask = valid.float().reshape(H, W, 1)
    metrics = eval_image_metrics(pred01, target01, mask)
    out = {k: v.detach().cpu().numpy() for k, v in metrics.items()}
    if lpips_fn is not None:
        # lpips_distance is batched NHWC in [-1, 1]
        pred = (metrics['pred'][None] - 0.5) * 2.0
        target = (metrics['target'][None] - 0.5) * 2.0
        out['lpips'] = float(lpips_fn(pred, target)[0])
    return out
