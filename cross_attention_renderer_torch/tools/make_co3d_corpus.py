"""Generate a CO3D-v2-format corpus from the analytic boxes worlds.

Port of the JAX package's ``tools/make_co3d_corpus.py``, which imports the
JAX package's synthetic worlds (and so needs jax): this writer takes them
from ``cross_attention_renderer_torch/data/synthetic.py``. It writes the
images with imageio (JPEG frames, PNG masks), which it needs. For the same
flags both write the same files.

The 3-view CO3D training/eval path (reference ``train_co3d.py`` +
``dataset/co3d.yaml``) runs against a self-generated category that is
bit-faithful to the on-disk CO3D-v2 layout the loader consumes
(``data/co3d.py``):

  <root>/<category>/frame_annotations.jgz        (gzip json list)
  <root>/<category>/set_lists/set_lists_fewview_{train,dev}.json
  <root>/<category>/<sequence>/images/frame*.jpg
  <root>/<category>/<sequence>/masks/frame*.png

Frames are renders of the multi-view-consistent boxes worlds
(data/synthetic.py:_render_boxes) from an orbit camera, so 3-view training
through the CO3D path can actually learn view synthesis. Viewpoints are
written in pytorch3d's row-vector (+X left, +Y up) convention with
``ndc_norm_image_bounds`` intrinsics — the exact inverse of the loader's
``cameras_from_annotation`` conversion.

Usage:
  python -m cross_attention_renderer_torch.tools.make_co3d_corpus \
      --root corpus/co3d --seqs 8
  python -m cross_attention_renderer_torch.tools.make_co3d_corpus \
      --root corpus/co3d_val --seqs 2 --seed_base 5000 --split dev
"""

import argparse
import gzip
import json
from pathlib import Path

import numpy as np

from cross_attention_renderer_torch.utils.image import imageio_v2

FLIP = np.array([-1.0, -1.0, 1.0])


def opencv_to_p3d(w2c: np.ndarray):
    """OpenCV world2cam -> pytorch3d (R, T) row-vector convention.

    Inverse of data/co3d.py:cameras_from_annotation: R_cv=(R*flip).T,
    t_cv=T*flip  =>  R = R_cv.T * flip (columns), T = t_cv * flip.
    """
    R_cv, t_cv = w2c[:3, :3], w2c[:3, 3]
    return (R_cv.T * FLIP[None, :]), (t_cv * FLIP)


def pixel_K_to_ndc(K: np.ndarray, H: int, W: int):
    """Pixel-unit K -> (focal_length, principal_point) in
    ndc_norm_image_bounds, inverse of the loader's rescale."""
    half = np.array([W, H], np.float64) / 2
    f_ndc = np.array([K[0, 0], K[1, 1]]) / half
    p_ndc = (half - np.array([K[0, 2], K[1, 2]])) / half
    return f_ndc, p_ndc


def orbit_c2w(rng, n):
    """Wide-baseline orbit like make_corpus._world_pose_rows."""
    from cross_attention_renderer_torch.data.synthetic import (
        look_at_cam2world)
    arc = np.deg2rad(40.0)
    phase = rng.uniform(0, 2 * np.pi)
    out = []
    for t in range(n):
        a = phase + arc * (t / max(n - 1, 1) - 0.5)
        eye = np.array([1.9 * np.sin(a), 0.25 * np.sin(2.3 * a),
                        -1.9 * np.cos(a)]) + rng.normal(0, 0.01, 3)
        out.append(look_at_cam2world(eye, np.zeros(3), up=(0.0, 1.0, 0.0)))
    return out


def main(argv=None):
    imageio = imageio_v2('writing JPEG frames and PNG masks')
    from cross_attention_renderer_torch.data.synthetic import (
        _render_boxes, _world_rects)

    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--category', default='boxes')
    ap.add_argument('--seqs', type=int, default=8)
    ap.add_argument('--frames', type=int, default=16)
    ap.add_argument('--size', type=int, default=256)
    ap.add_argument('--seed_base', type=int, default=0)
    ap.add_argument('--split', choices=['train', 'dev'], default='train')
    a = ap.parse_args(argv)

    H = W = a.size
    K = np.eye(4)
    K[0, 0] = K[1, 1] = 1.2 * W
    K[0, 2], K[1, 2] = W / 2, H / 2

    cat = Path(a.root) / a.category
    (cat / 'set_lists').mkdir(parents=True, exist_ok=True)
    annots = []
    set_list = {'train': [], 'val': [], 'test': []}
    key = {'train': 'train', 'dev': 'val'}[a.split]
    mask = np.full((H, W), 255, np.uint8)    # full-frame fg: bbox ~= frame

    for s in range(a.seqs):
        seed = a.seed_base + s
        seq = f'seq{seed:05d}'
        rng = np.random.default_rng(1000 + seed)
        rects = _world_rects(seed, 6)
        (cat / seq / 'images').mkdir(parents=True, exist_ok=True)
        (cat / seq / 'masks').mkdir(parents=True, exist_ok=True)
        for f, c2w in enumerate(orbit_c2w(rng, a.frames)):
            rgb = _render_boxes(c2w, K, H, W, rects)          # [-1, 1]
            img = ((rgb + 1) * 127.5).clip(0, 255).astype(np.uint8)
            ipath = f'{a.category}/{seq}/images/frame{f:03d}.jpg'
            mpath = f'{a.category}/{seq}/masks/frame{f:03d}.png'
            imageio.imwrite(Path(a.root) / ipath, img, quality=95)
            imageio.imwrite(Path(a.root) / mpath, mask)
            R, T = opencv_to_p3d(np.linalg.inv(c2w))
            f_ndc, p_ndc = pixel_K_to_ndc(K, H, W)
            annots.append({
                'sequence_name': seq, 'frame_number': f,
                'frame_timestamp': float(f),
                'image': {'path': ipath, 'size': [H, W]},
                'mask': {'path': mpath, 'mass': float(H * W)},
                'viewpoint': {
                    'R': R.tolist(), 'T': T.tolist(),
                    'focal_length': f_ndc.tolist(),
                    'principal_point': p_ndc.tolist(),
                    'intrinsics_format': 'ndc_norm_image_bounds',
                },
            })
            set_list[key].append([seq, f, ipath])
        print(f'{seq} done', flush=True)

    # frame_annotations.jgz is shared across splits of a category: merge
    # with any existing annotations (keyed by image path) instead of
    # clobbering a previous split's generation run.
    jgz = cat / 'frame_annotations.jgz'
    if jgz.exists():
        old = {a['image']['path']: a for a in
               json.load(gzip.open(jgz, 'rt'))}
        old.update({a['image']['path']: a for a in annots})
        annots = list(old.values())
    with gzip.open(jgz, 'wt') as fh:
        json.dump(annots, fh)
    (cat / 'set_lists' / f'set_lists_fewview_{a.split}.json').write_text(
        json.dumps(set_list))
    print(f'{a.seqs} seqs x {a.frames} frames at {cat} ({a.split})')


if __name__ == '__main__':
    main()
