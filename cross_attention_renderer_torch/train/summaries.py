"""Training summaries: image grids, attention entropy, depth colormap,
epipolar-line visualisation.

The port's own numpy copy of ``cross_attention_renderer_tpu/train/
summaries.py`` (behavioural reference: the reference repo's
``summaries.py``). The epipolar visualisation, painting the sampled
epipolar points and the argmax-attention point into the context images at
a fixed query pixel (summaries.py:72-141), was the reference's main live
debugging instrument. Everything runs on the host on finished outputs;
torch tensors (any device, any float type) and arrays are taken alike.
"""

from __future__ import annotations

import numpy as np


def _np(x) -> np.ndarray:
    """A torch tensor or an array as a numpy array (floats as f32)."""
    if hasattr(x, 'detach'):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


# fixed inspection pixel, ref summaries.py:84 (query ray index 2065)
INSPECT_RAY = 2065


def attention_entropy(at_wt: np.ndarray) -> float:
    """Mean softmax entropy over the joint (view, sample) axis.

    Ref: training loop entropy scalar (training.py:110-116). at_wt:
    (B, V, R, P)."""
    at_wt = _np(at_wt)
    b, v, r, p = at_wt.shape
    flat = np.transpose(at_wt, (0, 2, 1, 3)).reshape(b, r, v * p)
    ent = -(flat * np.log(np.clip(flat, 1e-12, None))).sum(-1)
    return float(ent.mean())


def colorize_depth(depth: np.ndarray, lo=None, hi=None) -> np.ndarray:
    """Jet-like colormap for (H, W) depth -> (H, W, 3) uint8.

    Ref: summaries.py depth colormap (matplotlib jet)."""
    depth = _np(depth)
    lo = np.nanmin(depth) if lo is None else lo
    hi = np.nanmax(depth) if hi is None else hi
    t = np.clip((depth - lo) / max(hi - lo, 1e-8), 0, 1)
    # piecewise jet approximation
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def paint_epipolar_points(context_rgb01: np.ndarray, pixel_val_ndc: np.ndarray,
                          at_wt: np.ndarray, ray_idx: int = INSPECT_RAY
                          ) -> np.ndarray:
    """Paint epipolar samples (red) + argmax-attention sample (green) of one
    query ray into each context image.

    Ref: ``epi_summary`` (summaries.py:72-141).

    Args:
      context_rgb01: (V, H, W, 3) in [0, 1].
      pixel_val_ndc: (V, R, P, 2).
      at_wt: (V, R, P) attention of round 1.
    Returns (V, H, W, 3) uint8.
    """
    context_rgb01, pixel_val_ndc, at_wt = (
        _np(context_rgb01), _np(pixel_val_ndc), _np(at_wt))
    V, H, W, _ = context_rgb01.shape
    ray_idx = min(ray_idx, pixel_val_ndc.shape[1] - 1)
    out = (context_rgb01 * 255).astype(np.uint8).copy()
    for v in range(V):
        pts = pixel_val_ndc[v, ray_idx]                 # (P, 2) ndc
        xs = np.clip(((pts[:, 0] + 1) / 2 * (W - 1)).astype(int), 0, W - 1)
        ys = np.clip(((pts[:, 1] + 1) / 2 * (H - 1)).astype(int), 0, H - 1)
        out[v, ys, xs] = [255, 0, 0]
        best = int(np.argmax(at_wt[v, ray_idx]))
        y, x = ys[best], xs[best]
        out[v, max(y - 2, 0):y + 3, max(x - 2, 0):x + 3] = [0, 255, 0]
    return out


def epipolar_panel(query_rgb01: np.ndarray, context_rgb01: np.ndarray,
                   query_uv: np.ndarray, pixel_val_ndc: np.ndarray,
                   at_wt: np.ndarray, ray_idx: int = INSPECT_RAY
                   ) -> np.ndarray:
    """The reference's single ``epipolar_line`` grid panel.

    Ref: ``epi_summary`` (summaries.py:72-141): the inspected query pixel is
    blacked out in the QUERY image (square of half-size ``H//64 + 1``), each
    epipolar sample is painted as a black square into the context images, and
    the argmax-attention sample as a darker square; query + context tiles are
    concatenated into one row (the reference uses
    ``torchvision.utils.make_grid``).

    Args:
      query_rgb01: (H, W, 3) in [0, 1].
      context_rgb01: (V, H, W, 3) in [0, 1].
      query_uv: (R, 2) query pixel coordinates (pixel units).
      pixel_val_ndc: (V, R, P, 2).
      at_wt: (V, R, P) round-1 attention.
    Returns (H, (1 + V) * W, 3) uint8.
    """
    query_rgb01, context_rgb01, query_uv, pixel_val_ndc, at_wt = (
        _np(a) for a in (query_rgb01, context_rgb01, query_uv,
                         pixel_val_ndc, at_wt))
    V, H, W, _ = context_rgb01.shape
    ray_idx = min(ray_idx, pixel_val_ndc.shape[1] - 1)
    ps = H // 64 + 1                       # marker half-size, ref :90
    qry = (query_rgb01 * 255).astype(np.uint8).copy()
    x, y = (int(query_uv[ray_idx, 0]), int(query_uv[ray_idx, 1]))
    qry[max(y - ps, 0):min(y + ps, H - 1),
        max(x - ps, 0):min(x + ps, W - 1)] = 0
    ctx = (context_rgb01 * 255).astype(np.uint8).copy()
    for v in range(V):
        pts = np.clip((pixel_val_ndc[v, ray_idx] + 1) / 2, 0, 1)   # (P, 2)
        xs = (pts[:, 0] * (W - 1)).astype(int)
        ys = (pts[:, 1] * (H - 1)).astype(int)
        for px, py in zip(xs, ys):
            ctx[v, max(py - ps, 0):min(py + ps, H - 1),
                max(px - ps, 0):min(px + ps, W - 1)] = 64
        best = int(np.argmax(at_wt[v, ray_idx]))
        bx, by = xs[best], ys[best]
        ctx[v, max(by - ps, 0):min(by + ps, H - 1),
            max(bx - ps, 0):min(bx + ps, W - 1)] = 0
    return np.concatenate([qry[None], ctx], 0).transpose(1, 0, 2, 3).reshape(
        H, (1 + V) * W, 3)


def write_summaries(writer, step: int, scene: dict, model_out: dict,
                    prefix: str = ''):
    """Writes the reference's summary set to ``writer``: anything with
    tensorboardX's ``add_scalar(tag, value, step)`` and ``add_image(tag,
    image, step, dataformats='HWC')`` (``img_summaries``,
    summaries.py:15-68)."""
    ctx_rgb = _np(scene['context']['rgb'][0])          # (V,H,W,3)
    ctx01 = (ctx_rgb + 1) * 0.5
    at_wt = _np(model_out['at_wt'])                    # (B,V,R,P)
    writer.add_scalar(prefix + 'at_wt_entropy', attention_entropy(at_wt),
                      step)
    for v in range(ctx01.shape[0]):
        writer.add_image(f'{prefix}context_{v}',
                         np.clip(ctx01[v], 0, 1), step,
                         dataformats='HWC')

    rgb = _np(model_out['rgb'][0, 0])                  # (R,3)
    depth = _np(model_out['depth_ray'][0, :, 0])       # (R,)
    n = rgb.shape[0]
    side = int(np.sqrt(n))
    if side * side == n:
        img = np.clip((rgb.reshape(side, side, 3) + 1) * 0.5, 0, 1)
        depth_img = colorize_depth(depth.reshape(side, side))
    else:
        # Sparse train-time ray sets (e.g. query_sparsity=192) don't tile
        # into an image; scatter each predicted ray at its uv position over
        # a mid-grey canvas so train summaries stay populated (the reference
        # only wrote val images, training.py:121-122 commented out — we keep
        # train-time visibility instead).
        H, W = ctx01.shape[1:3]
        uv = _np(scene['query']['uv'][0, 0])[:n]        # (R,2) pixels
        xs = np.clip(uv[:, 0].astype(int), 0, W - 1)
        ys = np.clip(uv[:, 1].astype(int), 0, H - 1)
        img = np.full((H, W, 3), 0.5, np.float32)
        img[ys, xs] = np.clip((rgb + 1) * 0.5, 0, 1)
        depth_img = np.zeros((H, W, 3), np.uint8)
        depth_img[ys, xs] = colorize_depth(depth[None])[0]
    writer.add_image(prefix + 'prediction', img, step, dataformats='HWC')
    writer.add_image(prefix + 'depth', depth_img, step, dataformats='HWC')
    pix = _np(model_out['pixel_val'][0])               # (V,R,P,2)
    painted = paint_epipolar_points(ctx01, pix, at_wt[0])
    for v in range(painted.shape[0]):
        writer.add_image(f'{prefix}epipolar_{v}', painted[v], step,
                         dataformats='HWC')
    # the reference's combined query+context panel (epi_summary); the query
    # tile reuses the prediction canvas built above (gt and prediction share
    # uv layout, and the panel only needs the marked pixel's location)
    Hc, Wc = ctx01.shape[1:3]
    uv = scene.get('query', {}).get('uv')
    if uv is not None:
        quv = _np(uv[0, 0])
    else:                       # full-image render: rays follow the uv grid
        quv = np.stack(np.meshgrid(np.arange(Wc), np.arange(Hc))[::-1],
                       -1).reshape(-1, 2)[:, ::-1].astype(np.float32)
    if img.shape[:2] == (Hc, Wc):
        writer.add_image(prefix + 'epipolar_line',
                         epipolar_panel(img, ctx01, quv, pix, at_wt[0]),
                         step, dataformats='HWC')
