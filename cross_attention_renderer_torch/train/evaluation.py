"""Evaluation: full-image rendering with the encoder latent computed once
per scene, and the reference's per-scene metrics.

Port of ``make_chunk_renderer``, ``render_full_image``,
``make_scan_renderer``, ``make_summary_renderer``, ``make_image_renderer``,
the fast-eval renderers (``resample_epipolar_t``, ``make_pruned_renderer``,
``narrow_pyramid``, ``quantize_pyramid``, ``make_fast_renderer``,
``make_narrow_renderer``), ``make_sharded_renderer`` and ``evaluate_scene``
of ``cross_attention_renderer_tpu/train/evaluation.py`` (reference eval
protocol, eval_realestate10k.py:131-199). PyTorch runs eagerly, so the
JAX ``lax.scan`` over ray blocks is a Python loop; the packed cell tables,
where the model reads them, are still built once per image. The parameters live in the model, so no entry point takes them:
where JAX hands a renderer per-scene parameters (a folded fuse kernel), the
port hands it a sibling of the model (``CrossAttentionRenderer.clone``)
that holds them and shares every other weight.

Spans (``utils/profiling.py:span``, on only under a profiler): each
whole-image renderer runs under ``car.render_image``, its packing of the
cell tables under ``car.pack_pyramid`` and each ray block under
``car.block``; the model's own spans nest inside them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional, Sequence

import torch

from cross_attention_renderer_torch.ops.grid_sample import pack_pyramid
from cross_attention_renderer_torch.parallel.distributed import (
    all_gather_cat)
from cross_attention_renderer_torch.parallel.mesh import axis_size
from cross_attention_renderer_torch.utils.metrics import eval_image_metrics
from cross_attention_renderer_torch.utils.profiling import span

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
    latent ``z`` cached; each chunk under the ``car.block`` span."""
    n_rays = uv_full.shape[2]
    if n_rays % n_chunks:
        raise ValueError(f'{n_chunks} chunks do not divide {n_rays} rays')
    size = n_rays // n_chunks
    rgbs, valids = [], []
    for i in range(n_chunks):
        with span('car.block'):
            rgb, valid = render_chunk(scene, z,
                                      uv_full[:, :, i * size:(i + 1) * size])
        rgbs.append(rgb)
        valids.append(valid)
    return torch.cat(rgbs, dim=2), torch.cat(valids, dim=1)


def _image_span(render_image: Callable) -> Callable:
    """``render_image`` under the ``car.render_image`` span."""
    @functools.wraps(render_image)
    def spanned(*args):
        with span('car.render_image'):
            return render_image(*args)

    return spanned


def _packed_tables(model, z):
    """The pyramid's cell tables, packed once an image where the model
    reads them (evaluation.py:87-106), else None."""
    if not model.uses_packed_tables:
        return None
    with span('car.pack_pyramid'):
        return pack_pyramid(z)


def make_scan_renderer(model, n_chunks: int) -> Callable:
    """Whole-image renderer: ``fn(scene, z, uv_full) -> (rgb (B, Q, n, 3),
    valid (B, n, 1))``. Where the model reads the pyramid's cell tables,
    they are packed once per image (evaluation.py:87-106); then the ray
    blocks render in turn."""

    @torch.inference_mode()
    @_image_span
    def render_image(scene, z, uv_full):
        zp = _packed_tables(model, z)

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
    @_image_span
    def render_image(scene, z, uv_full):
        n_rays = uv_full.shape[2]
        if n_rays % n_chunks:
            raise ValueError(f'{n_chunks} chunks do not divide {n_rays} '
                             'rays')
        size = n_rays // n_chunks
        zp = _packed_tables(model, z)
        parts = {k: [] for k in keys}
        for i in range(n_chunks):
            s = dict(scene)
            s['query'] = dict(scene['query'],
                              uv=uv_full[:, :, i * size:(i + 1) * size])
            with span('car.block'):
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
    (:func:`make_scan_renderer`); ``pruned``, ``narrow`` and ``q8`` switch
    to the fast-eval renderer (:func:`make_fast_renderer`)."""
    encode, _ = make_chunk_renderer(model)
    if pruned is not None or narrow is not None or q8:
        scan = make_fast_renderer(model, n_chunks, pruned=pruned,
                                  narrow=narrow, q8=q8)
    else:
        scan = make_scan_renderer(model, n_chunks)
    return encode, lambda scene, z: scan(scene, z, scene['query']['uv'])


def resample_epipolar_t(at_wt: Tensor, n_fine: int,
                        floor: float = 0.1) -> Tensor:
    """Stratified inverse-CDF resampling of epipolar-segment positions
    (JAX evaluation.py:200-250).

    ``at_wt`` (B, V, R, Pc): the round-1 joint (view, sample) attention
    weights of a coarse uniform pass. Each view's weights, renormalised and
    blended with a ``floor`` of uniform mass, are a piecewise-constant pdf
    over t in [0, 1] with bins centred on ``linspace(0, 1, Pc)``; the
    ``n_fine`` deterministic strata u = (k + 0.5) / n_fine invert its CDF.
    Returns (B, V, R, n_fine) f32, ascending along the last axis."""
    *lead, Pc = at_wt.shape
    dev, f32 = at_wt.device, torch.float32
    w = at_wt.float()
    w = w / (w.sum(dim=-1, keepdim=True) + 1e-9)
    w = (1.0 - floor) * w + floor / Pc
    # Bin edges: [0, midpoints of the coarse grid, 1]; a bin's probability
    # is its weight times its width, so uniform weights sample uniformly in
    # t though the end bins are half as wide.
    t = torch.linspace(0.0, 1.0, Pc, dtype=f32, device=dev)
    edges = torch.cat([torch.zeros(1, dtype=f32, device=dev),
                       0.5 * (t[:-1] + t[1:]),
                       torch.ones(1, dtype=f32, device=dev)])
    w = w * (edges[1:] - edges[:-1]) * Pc
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-12)
    cdf = torch.cat([torch.zeros((*lead, 1), dtype=f32, device=dev),
                     torch.cumsum(w, dim=-1)], dim=-1)     # (..., Pc + 1)
    u = (torch.arange(n_fine, dtype=f32, device=dev) + 0.5) / n_fine
    # The bin of each stratum: #{j : cdf_j <= u_k} - 1.
    below = ((cdf[..., :, None] <= u).sum(dim=-2) - 1).clamp(0, Pc - 1)
    c0 = torch.gather(cdf, -1, below)
    c1 = torch.gather(cdf, -1, below + 1)
    e0, e1 = edges[below], edges[below + 1]
    frac = (u - c0) / torch.clamp(c1 - c0, min=1e-12)
    return e0 + frac * (e1 - e0)


def make_pruned_renderer(model, n_chunks: int, n_coarse: int = 16,
                         n_fine: int = 24, floor: float = 0.1) -> Callable:
    """Coarse-to-fine whole-image renderer (JAX evaluation.py:253-306),
    with :func:`make_scan_renderer`'s signature. Per ray block: a uniform
    pass at ``n_coarse`` samples without the second attention round scores
    each segment by its round-1 weights; then the model renders at
    ``n_fine`` samples placed by :func:`resample_epipolar_t`. Its images
    differ from the uniform protocol's, so it is for evaluation and
    trajectories that opt in."""
    coarse_model = model.clone(repeat_attention=False)

    @torch.inference_mode()
    @_image_span
    def render_image(scene, z, uv_full):
        B, _, n_rays, _ = uv_full.shape
        V = scene['context']['rgb'].shape[1]
        size = n_rays // n_chunks
        zp = _packed_tables(model, z)
        t_coarse = torch.linspace(
            0.0, 1.0, n_coarse, dtype=torch.float32,
            device=uv_full.device).expand(B, V, size, n_coarse)

        def render_chunk(scene, z, uv):
            s = dict(scene)
            s['query'] = dict(scene['query'], uv=uv)
            coarse = coarse_model(s, z=z, z_packed=zp, t_vals=t_coarse)
            t_fine = resample_epipolar_t(coarse['at_wt'], n_fine, floor)
            out = model(s, z=z, z_packed=zp, t_vals=t_fine.detach())
            return out['rgb'], out['valid_mask']

        return render_full_image(render_chunk, scene, z, uv_full, n_chunks)

    return render_image


@contextlib.contextmanager
def _f32_products():
    """CUDA matrix products in full f32 (no TF32), as JAX's HIGHEST."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _fold(model, kernels: Sequence[Optional[Tensor]], widths) -> Tensor:
    """``query_encode_latent``'s kernel with the row block of each pyramid
    level l replaced by ``kernels[l]`` (None keeps it); the tanh rows
    stay."""
    kern = model.query_encode_latent.kernel
    blocks, off = [], 0
    for blk, C in zip(kernels, widths):
        blocks.append(kern[off:off + C] if blk is None
                      else blk.to(kern.dtype))
        off += C
    blocks.append(kern[off:])
    return torch.cat(blocks)


def narrow_pyramid(model, z: Sequence[Tensor], widths: Sequence[int]
                   ) -> tuple[tuple, object]:
    """Per-scene PCA narrowing of the pyramid (JAX evaluation.py:309-367).

    The exchange reads the gathered features only through
    ``query_encode_latent``, and the bilinear gather and that layer's first
    product are linear, so each level is projected onto its top-k
    uncentred principal components P (k, C) and P folded into the layer's
    rows: W^T x ~ (P W)^T (P x). Levels with k >= C pass unchanged.
    Returns (the narrow levels, a sibling of ``model`` with the folded
    kernel, ``model.clone``). The products run in f32 without TF32 (JAX's
    HIGHEST). The basis's sign is whatever ``eigh`` gives: the narrow
    levels may differ from JAX's in sign per component, the render
    does not."""
    if len(widths) != len(z):
        raise ValueError(f'narrow takes one width a pyramid level '
                         f'({len(z)}), got {tuple(widths)}')
    z_n, folds, widths_n = [], [], []
    kern = model.query_encode_latent.kernel
    off = 0
    with _f32_products():
        for z_l, k in zip(z, widths):
            C = z_l.shape[-1]
            if k >= C:
                z_n.append(z_l)
                folds.append(None)
                widths_n.append(C)
            else:
                X = z_l.reshape(-1, C).float()
                _, vecs = torch.linalg.eigh(X.T @ X)    # ascending
                P = vecs.flip(-1)[:, :k].T              # (k, C), descending
                z_n.append((X @ P.T).reshape(*z_l.shape[:-1], k)
                           .to(z_l.dtype))
                folds.append(P @ kern[off:off + C].float())
                widths_n.append(k)
            off += C
        kern_n = _fold(model, folds, [z_l.shape[-1] for z_l in z])
    return tuple(z_n), model.clone(fuse_kernel=kern_n,
                                   narrow_features=widths_n)


def quantize_pyramid(model, z: Sequence[Tensor]) -> tuple[tuple, object]:
    """int8 quantization of the pyramid (JAX evaluation.py:370-408):
    per-channel symmetric scales s = max |x| / 127 over the scene's images,
    q = clip(round(x / s), -127, 127) (round half to even). The bilinear
    combine is linear per channel, so diag(s) folds into
    ``query_encode_latent``'s feature rows and the gathers read int8 rows.
    Returns (the int8 levels, a sibling of ``model`` with the folded
    kernel). For rendering only: no gradient is defined for int8
    tables."""
    z_q, folds = [], []
    kern = model.query_encode_latent.kernel
    off = 0
    for z_l in z:
        x = z_l.float()
        C = x.shape[-1]
        s = torch.clamp(x.abs().amax(dim=tuple(range(x.ndim - 1))) / 127.0,
                        min=1e-8)
        z_q.append(torch.clamp(torch.round(x / s), -127, 127)
                   .to(torch.int8))
        folds.append(kern[off:off + C].float() * s[:, None])
        off += C
    kern_q = _fold(model, folds, [z_l.shape[-1] for z_l in z])
    return tuple(z_q), model.clone(fuse_kernel=kern_q)


def make_fast_renderer(model, n_chunks: int,
                       pruned: Optional[tuple] = None,
                       narrow: Optional[tuple] = None,
                       q8: bool = False) -> Callable:
    """Whole-image renderer composing the fast-eval levers (JAX
    evaluation.py:411-450), with :func:`make_scan_renderer`'s signature:
    ``pruned=(C, F)`` coarse-to-fine sampling
    (:func:`make_pruned_renderer`), ``narrow=(k1, k2, k3)`` per-scene PCA
    narrowing (:func:`narrow_pyramid`), ``q8`` int8 tables
    (:func:`quantize_pyramid`). Their images approximate the uniform
    full-width protocol's, so they are opt-in.

    The folds are taken per image, outside inference mode, so that their
    kernel keeps a version counter and the kernels' weight layouts
    (``ops/gather_epilogue.py:_prepared``) are built once per image.
    ``q8`` needs a path that reads the packed cell tables (K2, K3, K4 or
    the plain take path, :attr:`uses_packed_tables`): the sorted stream's
    gather (K5) and the one-hot and banded gathers (K7, K8) have no int8
    mode, and raise. ``narrow`` takes one width a pyramid level (three for
    the DPT encoder, four for the ResNet34 and U-Net ones). ``pruned``
    places samples on the epipolar segment, which ``no_sample`` has not:
    the model refuses its ``t_vals`` there, as the JAX renderer does."""
    if (narrow is not None or q8) and not model.multiview:
        raise ValueError('narrow/q8 rendering requires the multiview '
                         '(V >= 2, latent-concat) path')
    if q8 and not model.uses_packed_tables:
        raise ValueError(
            'q8 rendering reads int8 cell tables, which only the packed-'
            'table paths take (the fused epilogues K2 and K3, the fused '
            'render K4, the take gathers); the sorted stream (K5) and the '
            'one-hot and banded gathers (K7, K8) have none')

    @_image_span        # holds the folds and the inner renderer's span
    def render_image(scene, z, uv_full):
        m, zc = model, tuple(z)
        with torch.inference_mode(False), torch.no_grad():
            if narrow is not None:
                zc, m = narrow_pyramid(m, zc, tuple(narrow))
            if q8:
                zc, m = quantize_pyramid(m, zc)
        inner = (make_pruned_renderer(m, n_chunks, *pruned)
                 if pruned is not None else make_scan_renderer(m, n_chunks))
        return inner(scene, zc, uv_full)

    return render_image


def make_narrow_renderer(model, n_chunks: int,
                         widths: tuple = (128, 128, 64),
                         pruned: Optional[tuple] = None) -> Callable:
    """PCA-narrowed whole-image renderer; see :func:`make_fast_renderer`."""
    return make_fast_renderer(model, n_chunks, pruned=pruned,
                              narrow=tuple(widths))


def make_sharded_renderer(model, mesh) -> Callable:
    """Ray-sharded full-image renderer (JAX evaluation.py:460-482): the
    query rays split over the mesh's ``rays`` axis (rays are independent
    until the image is assembled). Returns ``fn(scene, z, uv) -> (rgb (B,
    Q, n, 3), valid (B, n, 1))``: each rank of the axis renders its
    contiguous slice of ``uv``'s ray axis (axis 2, JAX's ``P(None, None,
    'rays', None)``) in one forward, and every rank receives the whole
    image, gathered over the axis. Every rank of a ray group calls it with
    the same arguments; the ray count must divide by the axis."""
    n, r = axis_size(mesh, 'rays'), mesh.get_local_rank('rays')
    group = mesh.get_group('rays')
    _, render_chunk = make_chunk_renderer(model)

    @torch.inference_mode()
    @_image_span
    def sharded(scene, z, uv):
        if uv.shape[2] % n:
            raise ValueError(f'{uv.shape[2]} rays do not divide over '
                             f'rays={n}')
        size = uv.shape[2] // n
        rgb, valid = render_chunk(scene, z, uv[:, :, r * size:(r + 1) * size])
        return all_gather_cat(rgb, group, 2), all_gather_cat(valid, group, 1)

    return sharded


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
