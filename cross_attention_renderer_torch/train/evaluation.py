"""Full-image rendering with the encoder latent computed once per scene.

Port of ``render_full_image`` and ``make_scan_renderer`` of
``cross_attention_renderer_tpu/train/evaluation.py`` (reference eval
protocol, eval_realestate10k.py:136-161). PyTorch runs eagerly, so the JAX
``lax.scan`` over ray blocks is a Python loop; the packed cell tables, where
the model reads them, are still built once per image.
"""

from __future__ import annotations

from typing import Callable

import torch

from cross_attention_renderer_torch.ops.grid_sample import pack_pyramid

Tensor = torch.Tensor


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
