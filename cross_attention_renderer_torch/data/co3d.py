"""CO3D-v2 dataset loader — pytorch3d-free.

Port of ``cross_attention_renderer_tpu/data/co3d.py``, a numpy
re-implementation of the reference's implicitron-based loader (``dataset/co3d_dataset.py``, 1310 LoC on pytorch3d+co3d packages).
All the pytorch3d machinery collapses into direct math:

  * annotations: gzipped-JSON ``frame_annotations.jgz`` /
    ``sequence_annotations.jgz`` per category + ``set_lists_*.json`` subset
    splits (co3d_dataset.py:302-308,244-245);
  * bbox crop around the foreground mask (threshold 0.4, context 0.3,
    clamped; co3d_dataset.py:543-556) then scale-preserving resize to 256
    with bottom/right zero padding and a crop-validity mask;
  * cameras: the reference converts annotation NDC intrinsics -> pytorch3d
    NDC -> OpenCV (co3d_dataset.py:632-688, 1041-1050 via
    ``opencv_from_cameras_projection``). Composing those steps, the pixel
    intrinsics of the OUTPUT image are simply

        f_px = f_ndc * rescale * scale
        c_px = (half_wh_orig - p_ndc * rescale - bbox_xy0) * scale

    and the OpenCV world2cam is R_cv = (R * [-1,-1,1])^T (column flips),
    t_cv = T * [-1,-1,1], from pytorch3d's row-vector x_cam = X R + T with
    (+X left, +Y up) axes. cam2world = [R_cv^T | -R_cv^T t_cv];
  * sampling: train = random V inputs + sorted random Q queries; dev/test =
    the same but seeded per index (co3d_dataset.py:376-390);
  * category one-hot over the 51 CO3D categories, NeRFormer 10-category
    subset supported (co3d_dataset.py:36-58);
  * query sparsity 192 random rays (co3d_dataset.py:1114-1121).
"""

from __future__ import annotations

import gzip
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from cross_attention_renderer_torch.utils.image import imageio_v2

# Category lists (co3d_dataset.py:36-58, which mirrors the CO3D repo).
CO3D_ALL_CATEGORIES = list(reversed([
    "baseballbat", "banana", "bicycle", "microwave", "tv",
    "cellphone", "toilet", "hairdryer", "couch", "kite", "pizza",
    "umbrella", "wineglass", "laptop",
    "hotdog", "stopsign", "frisbee", "baseballglove",
    "cup", "parkingmeter", "backpack", "toyplane", "toybus",
    "handbag", "chair", "keyboard", "car", "motorcycle",
    "carrot", "bottle", "sandwich", "remote", "bowl", "skateboard",
    "toaster", "mouse", "toytrain", "book", "toytruck",
    "orange", "broccoli", "plant", "teddybear",
    "suitcase", "bench", "ball", "cake",
    "vase", "hydrant", "apple", "donut",
]))
CO3D_NERFORMER_SUBSET_CATEGORIES = CO3D_ALL_CATEGORIES[:10]
ALL_CATEGORY_MAPPING = {
    'all': CO3D_ALL_CATEGORIES,
    'all_nerformer': CO3D_NERFORMER_SUBSET_CATEGORIES,
}


def load_jgz(path: str | Path):
    with gzip.open(path, 'rt', encoding='utf8') as f:
        return json.load(f)


def _load_image_rgb(path) -> np.ndarray:
    imageio = imageio_v2('reading CO3D frames')
    img = np.asarray(imageio.imread(path), np.float32)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    return img[..., :3] / 255.0


def _load_mask(path) -> np.ndarray:
    imageio = imageio_v2('reading CO3D frames')
    m = np.asarray(imageio.imread(path), np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    return m / 255.0


def bbox_from_mask(mask: np.ndarray, thr: float = 0.4) -> np.ndarray:
    """Tight (x0, y0, w, h) box around mask > thr, whole image if empty."""
    ys, xs = np.where(mask > thr)
    if len(ys) == 0:
        return np.array([0, 0, mask.shape[1], mask.shape[0]])
    return np.array([xs.min(), ys.min(), xs.max() - xs.min() + 1,
                     ys.max() - ys.min() + 1])


def clamp_bbox(bbox_xywh: np.ndarray, context: float,
               image_hw: tuple[int, int]) -> np.ndarray:
    """Expand by ``context`` and clamp -> rounded (x0, y0, x1, y1)."""
    x0, y0, w, h = bbox_xywh.astype(np.float64)
    x0 -= w * context / 2
    y0 -= h * context / 2
    x1 = x0 + w * (1 + context)
    y1 = y0 + h * (1 + context)
    H, W = image_hw
    box = np.round([max(x0, 0), max(y0, 0), min(x1, W), min(y1, H)])
    return box.astype(np.int64)


def resize_with_pad(img: np.ndarray, out: int,
                    nearest: bool = False) -> tuple[np.ndarray, float,
                                                    np.ndarray]:
    """implicitron-style resize: scale = min(out/h, out/w), zero-pad
    bottom/right, return (image, scale, valid mask)."""
    h, w = img.shape[:2]
    scale = min(out / h, out / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    from cross_attention_renderer_torch.data.realestate import _resize
    if nearest:
        ys = np.clip((np.arange(nh) / scale).astype(int), 0, h - 1)
        xs = np.clip((np.arange(nw) / scale).astype(int), 0, w - 1)
        resized = img[ys][:, xs]
    else:
        resized = _resize(img, (nh, nw))
    pad_shape = (out, out) + img.shape[2:]
    canvas = np.zeros(pad_shape, img.dtype)
    canvas[:nh, :nw] = resized
    valid = np.zeros((out, out), np.float32)
    valid[:nh, :nw] = 1.0
    return canvas, scale, valid


def cameras_from_annotation(viewpoint: dict, image_size_hw, bbox_xy0,
                            scale: float) -> tuple[np.ndarray, np.ndarray]:
    """Annotation viewpoint -> (cam2world 4x4, pixel-unit K 4x4) for the
    cropped+resized image. See module docstring for the derivation."""
    H, W = image_size_hw
    half_wh = np.array([W, H], np.float64) / 2
    fmt = viewpoint.get('intrinsics_format', 'ndc_norm_image_bounds')
    if fmt.lower() == 'ndc_norm_image_bounds':
        rescale = half_wh
    elif fmt.lower() == 'ndc_isotropic':
        rescale = half_wh.min()
    else:
        raise ValueError(f'unknown intrinsics format {fmt}')
    p_ndc = np.asarray(viewpoint['principal_point'], np.float64)
    f_ndc = np.asarray(viewpoint['focal_length'], np.float64)
    pp_px = half_wh - p_ndc * rescale - np.asarray(bbox_xy0, np.float64)
    f_px = f_ndc * rescale
    K = np.eye(4)
    K[0, 0] = f_px[0] * scale
    K[1, 1] = f_px[1] * scale
    K[0, 2] = pp_px[0] * scale
    K[1, 2] = pp_px[1] * scale

    R_p3d = np.asarray(viewpoint['R'], np.float64)       # row-vector conv.
    T_p3d = np.asarray(viewpoint['T'], np.float64)
    flip = np.array([-1.0, -1.0, 1.0])
    R_cv = (R_p3d * flip[None, :]).T                      # world2cam rotation
    t_cv = T_p3d * flip
    c2w = np.eye(4)
    c2w[:3, :3] = R_cv.T
    c2w[:3, 3] = -R_cv.T @ t_cv
    return c2w.astype(np.float32), K.astype(np.float32)


class CO3Dv2Dataset:
    """Scene-dict dataset over CO3D-v2 sequences.

    Ref: ``CO3Dv2Wrapper`` + ``Co3dV2Dataset`` (co3d_dataset.py:228-1141).

    ``masked=False`` (the default) keeps the background, as the JAX
    package's loader does; ``masked=True`` multiplies each frame by its
    foreground mask, as the original CO3D protocol does.
    """

    def __init__(self, root: str, category: str = 'all_nerformer',
                 subset: str = 'fewview_train',
                 num_input_views: int = 3, num_query_views: int = 1,
                 image_size: int = 256, masked: bool = False,
                 query_sparsity: Optional[int] = 192,
                 box_crop_thr: float = 0.4, box_crop_context: float = 0.3,
                 seed: int = 0):
        self.root = Path(root)
        self.image_size = image_size
        self.masked = masked
        self.subset = subset
        self.num_input_views = num_input_views
        self.num_query_views = num_query_views
        self.query_sparsity = query_sparsity
        self.box_crop_thr = box_crop_thr
        self.box_crop_context = box_crop_context
        self.rng = np.random.default_rng(seed)

        cats = ALL_CATEGORY_MAPPING.get(category, [category])
        split = {'fewview_train': 'train', 'fewview_dev': 'val',
                 'fewview_test': 'test'}[subset]

        self.frames: dict[str, dict] = {}          # image path -> annotation
        self.seq_to_paths: dict[str, list[str]] = {}
        self.seq_category: dict[str, str] = {}
        for cat in cats:
            cat_dir = self.root / cat
            if not cat_dir.exists():
                continue
            annots = load_jgz(cat_dir / 'frame_annotations.jgz')
            by_path = {a['image']['path']: a for a in annots}
            set_lists = json.loads(
                (cat_dir / 'set_lists' / f'set_lists_{subset}.json')
                .read_text())
            for seq_name, _, path in set_lists[split]:
                if path not in by_path:
                    continue
                self.frames[path] = by_path[path]
                self.seq_to_paths.setdefault(seq_name, []).append(path)
                self.seq_category[seq_name] = cat
        # keep sequences with > 10 frames (co3d_dataset.py:330-334), except
        # the fewview_test subset which keeps everything
        if subset != 'fewview_test':
            self.seq_to_paths = {k: v for k, v in self.seq_to_paths.items()
                                 if len(v) > 10}
        self.seq_list = sorted(self.seq_to_paths)

        cat_sorted = sorted(CO3D_ALL_CATEGORIES)
        self.cat_to_idx = {c: i for i, c in enumerate(cat_sorted)}
        self.n_categories = len(cat_sorted)

        i, j = np.meshgrid(np.arange(image_size), np.arange(image_size),
                           indexing='xy')
        self.uv = np.stack([i, j], -1).reshape(-1, 2).astype(np.float32)

    def __len__(self) -> int:
        return len(self.seq_list)

    def _load_frame(self, path: str):
        entry = self.frames[path]
        mask = _load_mask(self.root / entry['mask']['path'])
        bbox = bbox_from_mask(mask, self.box_crop_thr)
        box_xyxy = clamp_bbox(bbox, self.box_crop_context, mask.shape[:2])
        x0, y0, x1, y1 = box_xyxy
        img = _load_image_rgb(self.root / entry['image']['path'])
        img_c = img[y0:y1, x0:x1]
        mask_c = mask[y0:y1, x0:x1]
        img_r, scale, crop_mask = resize_with_pad(img_c, self.image_size)
        mask_r, _, _ = resize_with_pad(mask_c, self.image_size, nearest=True)
        if self.masked:
            img_r = img_r * mask_r[..., None]
        c2w, K = cameras_from_annotation(
            entry['viewpoint'], entry['image']['size'], (x0, y0), scale)
        return img_r, mask_r, crop_mask, c2w, K

    def _sample(self, n: int, index: int):
        if self.subset == 'fewview_train':
            rng = self.rng
        else:
            rng = np.random.default_rng(index)   # deterministic eval
        inp = rng.permutation(n)[:self.num_input_views]
        qry = np.sort(rng.permutation(n)[:self.num_query_views])
        return inp, qry

    def __getitem__(self, index: int) -> dict:
        seq = self.seq_list[index]
        paths = self.seq_to_paths[seq]
        inp_idx, qry_idx = self._sample(len(paths), index)

        cat_onehot = np.zeros(self.n_categories, np.float32)
        # custom (non-official) categories — e.g. a generated corpus —
        # carry a zero one-hot rather than crashing the loader
        cat_idx = self.cat_to_idx.get(self.seq_category[seq])
        if cat_idx is not None:
            cat_onehot[cat_idx] = 1.0

        ctx = [self._load_frame(paths[i]) for i in inp_idx]
        qry = [self._load_frame(paths[i]) for i in qry_idx]

        q_rgb, q_uv = [], []
        for img, *_ in qry:
            rgb = ((img - 0.5) * 2.0).reshape(-1, 3).astype(np.float32)
            if self.query_sparsity is not None:
                rix = self.rng.permutation(self.uv.shape[0])[
                    :self.query_sparsity]
                q_uv.append(self.uv[rix])
                q_rgb.append(rgb[rix])
            else:
                q_uv.append(self.uv)
                q_rgb.append(rgb)

        return {
            'context': {
                'rgb': np.stack([(c[0] - 0.5) * 2.0 for c in ctx]
                                ).astype(np.float32),
                'cam2world': np.stack([c[3] for c in ctx]),
                'intrinsics': np.stack([c[4] for c in ctx]),
                'fg_mask': np.stack([c[1] for c in ctx]).astype(np.float32),
                'crop_mask': np.stack([c[2] for c in ctx]),
            },
            'query': {
                'rgb': np.stack(q_rgb),
                'cam2world': np.stack([c[3] for c in qry]),
                'intrinsics': np.stack([c[4] for c in qry]),
                'uv': np.stack(q_uv),
                'mask': np.float32(0.0),
            },
            'category': cat_onehot,
            'sequence': seq,
        }
