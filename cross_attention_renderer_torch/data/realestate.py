"""RealEstate10K / ACID dataset loaders (npz frame archives + .mat pose tables).

Port of ``cross_attention_renderer_tpu/data/realestate.py``, a numpy
re-implementation of the reference's data layer
(``dataset/realestate10k_dataio.py`` / ``acid_dataio.py`` — the two are
structurally identical, so one implementation serves both). Items are
channel-last numpy scene dicts in exactly the layout the renderer consumes,
drawn from the same seeds as the JAX package's; :func:`batch_iterator`
stacks them into torch tensors, on the caller's device when asked.

Key reference behaviors preserved:
  * per-scene ``data.npz`` frame archives keyed by timestamp filenames,
    timestamp-sorted (realestate10k_dataio.py:280-284);
  * .mat pose tables: rows [timestamp, fx, fy, cx, cy, _, _, w2c(3x4 flat)]
    (realestate10k_dataio.py:61-72,94-101);
  * 360p -> 256x455 resize, center square crop, intrinsics rescale
    (realestate10k_dataio.py:357-369; utils/data_util.py:116-121);
  * train sampling: context frames >= 92 apart, query within +-64 frames of
    the context span (realestate10k_dataio.py:296-344);
  * augmentation: 50% h-flip with cam2world sign fix + random aspect crop
    (realestate10k_dataio.py:24-59);
  * query-ray subsampling: ``query_sparsity`` random rays, or for LPIPS a
    50/50 coin flip between a contiguous 32x32 patch (mask=1) and 1024
    random rays (mask=0) (realestate10k_dataio.py:380-405);
  * defective scenes are skipped by resampling a random index
    (realestate10k_dataio.py:259-278);
  * Vis variant: deterministic context {0, min(128, n-1)}, query >= 10
    frames from every context (realestate10k_dataio.py:584-595);
  * 128-frame trajectory query set for video rendering
    (realestate10k_dataio.py:104-188).
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Iterator, Optional

import numpy as np
import torch

from cross_attention_renderer_torch.train import trainer

try:
    import cv2
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

IMG_H, IMG_W = 256, 455     # post-resize frame size (realestate10k_dataio.py:232)
CROP = 256                  # square crop size
NFRAME_VIEW = 92            # min context separation (realestate10k_dataio.py:298)
QUERY_WINDOW = 64           # query within +-64 of the context span


def full_uv_grid(dim: Optional[int] = None) -> np.ndarray:
    """(dim*dim, 2) pixel (x, y) coords, x varying fastest
    (realestate10k_dataio.py:238-245)."""
    dim = CROP if dim is None else dim
    i, j = np.meshgrid(np.arange(dim), np.arange(dim), indexing='xy')
    return np.stack([i, j], -1).reshape(-1, 2).astype(np.float32)


@dataclasses.dataclass
class Camera:
    """One pose-table row. Ref: ``Camera`` (realestate10k_dataio.py:61-72)."""
    intrinsics: np.ndarray   # 4x4, normalized (fx, fy, cx, cy in 0..1)
    c2w: np.ndarray          # 4x4

    @classmethod
    def from_row(cls, row: np.ndarray) -> 'Camera':
        fx, fy, cx, cy = row[1:5]
        k = np.eye(4)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = fx, fy, cx, cy
        w2c = np.eye(4)
        w2c[:3, :] = np.asarray(row[7:19]).reshape(3, 4)
        return cls(intrinsics=k, c2w=np.linalg.inv(w2c))


def unnormalize_intrinsics(k: np.ndarray, h: int, w: int) -> np.ndarray:
    k = k.copy()
    k[0] *= w
    k[1] *= h
    return k


def square_crop(img: np.ndarray) -> np.ndarray:
    """Center square crop (utils/data_util.py:116-121)."""
    m = min(img.shape[:2])
    cy, cx = img.shape[0] // 2, img.shape[1] // 2
    return img[cy - m // 2:cy + m // 2, cx - m // 2:cx + m // 2]


def augment(rng: np.random.Generator, rgb: np.ndarray, intr: np.ndarray,
            c2w: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """50% h-flip (with the cam2world x-axis sign fix) + random aspect crop
    + resize back to 256^2 with intrinsics rescale
    (realestate10k_dataio.py:24-59)."""
    if rng.uniform() < 0.5:
        rgb = rgb[:, ::-1, :]
        flip = np.diag([-1.0, 1.0, 1.0, 1.0])
        c2w = c2w @ flip
    py = rng.integers(1, 32) if rng.uniform() < 0.5 else 0
    px = rng.integers(1, 32) if rng.uniform() < 0.5 else 0
    if py:
        rgb = rgb[py:-py, :, :]
    if px:
        rgb = rgb[:, px:-px, :]
    h, w = rgb.shape[:2]
    rgb = _resize(rgb, (CROP, CROP))
    intr = intr.copy()
    intr[0, 0] *= CROP / w
    intr[1, 1] *= CROP / h
    return rgb, intr, c2w


def _resize(img: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    if _HAS_CV2:
        return cv2.resize(img, (hw[1], hw[0]))
    # nearest fallback (test environments without cv2)
    ys = (np.arange(hw[0]) * img.shape[0] / hw[0]).astype(int)
    xs = (np.arange(hw[1]) * img.shape[1] / hw[1]).astype(int)
    return img[ys][:, xs]


class SceneStore:
    """Scene directory of per-scene npz archives + a .mat pose table.

    When the native C++ loader (native/dataloader.cc) is available, whole
    batches of frames are decoded/resized/cropped on a worker-thread pool in
    one call instead of per-frame Python (``use_native``)."""

    def __init__(self, img_root: str | Path, pose_root: str | Path,
                 max_num_scenes: Optional[int] = None,
                 use_native: bool = True):
        from scipy.io import loadmat
        self.scenes = sorted(Path(img_root).glob('*/'))
        if max_num_scenes:
            self.scenes = self.scenes[:max_num_scenes]
        self.poses = loadmat(str(pose_root))
        self.use_native = False
        if use_native:
            from cross_attention_renderer_torch.data import native_loader
            self.use_native = native_loader.available()
        self._native_cache: 'OrderedDict' = OrderedDict()
        self._native_lock = threading.Lock()

    def native_frames(self, idx: int, fnames: list[str]) -> np.ndarray:
        """(N, 256, 256, 3) float frames in [-1, 1] via the native core.

        Thread-safe: prefetch workers (``batch_iterator(num_workers>0)``)
        share a small LRU of open archives; the decode itself runs without
        the GIL on the C++ pool."""
        from cross_attention_renderer_torch.data import native_loader
        scene = self.scenes[idx]
        with self._native_lock:
            arch = self._native_cache.get(idx)
            if arch is None:
                npzs = sorted(scene.glob('*.npz'))
                arch = native_loader.NativeNpz(npzs[0])
                self._native_cache[idx] = arch
                while len(self._native_cache) > 16:
                    self._native_cache.popitem(last=False)
            else:
                self._native_cache.move_to_end(idx)
        return arch.load_frames(
            list(fnames), out_hw=(CROP, CROP), resize_hw=(IMG_H, IMG_W),
            square_crop=True)

    def __len__(self) -> int:
        return len(self.scenes)

    def load(self, idx: int):
        """Returns (frames dict, sorted filenames, timestamps, pose table)
        or None for a defective scene (missing pose/npz/short video)."""
        scene = self.scenes[idx]
        name = scene.name
        if name not in self.poses:
            return None
        npzs = sorted(scene.glob('*.npz'))
        if not npzs:
            return None
        try:
            data = np.load(npzs[0])
        except Exception:
            return None
        files = list(data.keys())
        if len(files) <= 10:
            return None
        ts = np.array([int(f.split('.')[0]) for f in files])
        order = np.argsort(ts)
        return data, np.array(files)[order], ts[order], self.poses[name]


def _pose_at(pose_table: np.ndarray, timestamp: int) -> Camera:
    """Ref: ``parse_pose`` (realestate10k_dataio.py:94-101)."""
    ts = np.around(pose_table[:, 0])
    row = pose_table[ts == timestamp][0]
    return Camera.from_row(row)


def _frame_camera(pose_table, timestamp: int):
    cam = _pose_at(pose_table, timestamp)
    intr = unnormalize_intrinsics(cam.intrinsics, IMG_H, IMG_W)
    # center-crop principal-point rescale (realestate10k_dataio.py:367-369)
    intr[0, 2] /= IMG_W / CROP
    intr[1, 2] /= IMG_H / CROP
    return intr.astype(np.float32), cam.c2w.astype(np.float32)


def _load_frame(data, fname: str, pose_table, timestamp: int,
                rng: Optional[np.random.Generator], do_augment: bool,
                rgb_pre: Optional[np.ndarray] = None,
                always_resize: bool = False):
    """One frame -> (rgb [-1,1], pixel intrinsics, cam2world).

    ``rgb_pre`` short-circuits image decoding with an already
    decoded/cropped/normalized frame from the native loader."""
    intr, c2w = _frame_camera(pose_table, timestamp)
    if rgb_pre is not None:
        if not do_augment:
            return rgb_pre, intr, c2w
        # Augment (flip/crop/resize) commutes with the [-1,1] normalization
        # the native core already applied, so the C++ decode path serves the
        # training loop too (reference: 8 DataLoader workers/rank,
        # train_realestate10k.py:81).
        return augment(rng, rgb_pre, intr, c2w)
    rgb = data[fname]
    # RealEstate resizes only 360p inputs (realestate10k_dataio.py:357-358);
    # ACID resizes unconditionally (acid_dataio.py:387).
    if rgb.shape[0] == 360 or (always_resize
                               and rgb.shape[:2] != (IMG_H, IMG_W)):
        rgb = _resize(rgb, (IMG_H, IMG_W))
    rgb = square_crop(rgb)
    if rgb.shape[:2] != (CROP, CROP):
        # Odd-resolution scrape (neither 360p nor the expected frame size):
        # without this check a full-image item would pair a CROP² uv grid
        # with a differently-sized rgb SILENTLY; raising routes the scene
        # into the defect-resample path like every other scrape defect.
        raise ValueError(f'unexpected frame size {rgb.shape}')
    if do_augment:
        rgb, intr, c2w = augment(rng, rgb, intr, c2w)
    rgb = rgb.astype(np.float32) / 127.5 - 1.0
    return rgb, intr, c2w


def _subsample_rays(rng: np.random.Generator, rgb_flat: np.ndarray,
                    uv: np.ndarray, query_sparsity: Optional[int],
                    lpips: bool):
    """Ray subsampling incl. the LPIPS patch coin-flip
    (realestate10k_dataio.py:380-405). Returns (uv, rgb, mask)."""
    if query_sparsity is None:
        return uv, rgb_flat, 0.0
    if lpips:
        if rng.integers(0, 2):
            grid_uv = uv.reshape(CROP, CROP, 2)
            grid_rgb = rgb_flat.reshape(CROP, CROP, 3)
            off = 32
            x0 = rng.integers(0, CROP - off)
            y0 = rng.integers(0, CROP - off)
            sel_uv = grid_uv[y0:y0 + off, x0:x0 + off].reshape(-1, 2)
            sel_rgb = grid_rgb[y0:y0 + off, x0:x0 + off].reshape(-1, 3)
            return sel_uv, sel_rgb, 1.0
        rix = rng.permutation(uv.shape[0])[:1024]
        return uv[rix], rgb_flat[rix], 0.0
    rix = rng.permutation(uv.shape[0])[:query_sparsity]
    return uv[rix], rgb_flat[rix], 0.0


class RealEstate10k:
    """Training dataset (random wide-baseline context pairs + nearby query).

    Ref: ``RealEstate10k`` (realestate10k_dataio.py:193-466). Works for ACID
    too (acid_dataio.py is the same format).
    """

    def __init__(self, img_root, pose_root, num_ctxt_views: int = 2,
                 num_query_views: int = 1,
                 query_sparsity: Optional[int] = 192,
                 max_num_scenes: Optional[int] = None, augment: bool = True,
                 lpips: bool = False, seed: int = 0):
        self.store = SceneStore(img_root, pose_root, max_num_scenes)
        self.num_ctxt_views = num_ctxt_views
        self.num_query_views = num_query_views
        self.query_sparsity = query_sparsity
        self.augment = augment
        self.lpips = lpips
        self.uv = full_uv_grid()
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self._rng_lock = threading.Lock()

    def _spawn_rng(self) -> np.random.Generator:
        """Fork a per-item generator so prefetch workers never share
        mutable RNG state (np.random.Generator is not thread-safe)."""
        with self._rng_lock:
            return np.random.default_rng(
                int(self.rng.integers(np.iinfo(np.int64).max)))

    # Frames are resized only when 360p (ACID overrides to always resize).
    always_resize = False

    def __len__(self) -> int:
        return len(self.store)

    def _query_bounds(self, id_feat: np.ndarray, n_frames: int):
        """Query-frame window around the context span
        (realestate10k_dataio.py:317-341): +-64 extrapolative at <=2 views,
        strictly interior at 3 views."""
        if self.num_ctxt_views <= 2:
            return (max(id_feat.min() - QUERY_WINDOW, 0),
                    min(id_feat.max() + QUERY_WINDOW, n_frames - 1))
        return id_feat.min() + QUERY_WINDOW, id_feat.max() - QUERY_WINDOW

    def _sample_ids(self, n_frames: int,
                    rng: Optional[np.random.Generator] = None):
        """Context/query frame selection (realestate10k_dataio.py:296-344)."""
        rng = self.rng if rng is None else rng
        candidates = np.arange(0, n_frames - 1)
        id_feats = []
        for _ in range(self.num_ctxt_views):
            if len(candidates) == 0:
                return None
            pick = rng.choice(candidates)
            candidates = candidates[(candidates < pick - NFRAME_VIEW)
                                    | (candidates > pick + NFRAME_VIEW)]
            id_feats.append(int(pick))
        id_feat = np.array(id_feats)
        low, high = self._query_bounds(id_feat, n_frames)
        if high <= low:
            return None
        id_render = rng.integers(low, high, size=self.num_query_views)
        return id_feat, id_render

    def __getitem__(self, idx: int) -> dict:
        return self._getitem_rng(idx, self._spawn_rng())

    def getitem_seeded(self, idx: int, serial: int) -> dict:
        """Deterministic variant used by :func:`batch_iterator`: the per-item
        generator derives from (dataset seed, draw serial, index) instead of
        shared mutable RNG state, so prefetch workers reproduce identical
        augmentation / frame-selection randomness for a fixed seed no matter
        which thread finishes first."""
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, serial, idx)))
        return self._getitem_rng(idx, rng)

    def _getitem_rng(self, idx: int, rng: np.random.Generator) -> dict:
        # Defective scenes (missing npz/pose/frames, corrupt archives,
        # timestamps absent from the pose table) are skipped by resampling a
        # random index, mirroring realestate10k_dataio.py:259-278.
        for _ in range(100):
            try:
                return self._load_item(idx, rng)
            except (IndexError, KeyError, OSError, ValueError):
                pass
            idx = int(rng.integers(0, len(self.store)))
        raise RuntimeError('no valid scenes found')

    def _load_item(self, idx: int,
                   rng: Optional[np.random.Generator] = None) -> dict:
        rng = self.rng if rng is None else rng
        loaded = self.store.load(idx)
        sampled = (self._sample_ids(len(loaded[1]), rng)
                   if loaded is not None else None)
        if sampled is None:
            raise ValueError('defective scene')
        data, files, ts, pose = loaded
        id_feat, id_render = sampled

        # Native fast path: decode the whole frame batch on the C++ pool.
        pre = {}
        if self.store.use_native:
            all_ids = list(id_render) + list(id_feat)
            try:
                frames = self.store.native_frames(
                    idx, [files[i] for i in all_ids])
                pre = {i: frames[k] for k, i in enumerate(all_ids)}
            except IOError:
                pre = {}

        q_rgb, q_intr, q_c2w, q_uv, mask = [], [], [], [], 0.0
        for i in id_render:
            rgb, intr, c2w = _load_frame(data, files[i], pose, ts[i],
                                         rng, self.augment,
                                         rgb_pre=pre.get(i),
                                         always_resize=self.always_resize)
            uv, rgb_sel, mask = _subsample_rays(
                rng, rgb.reshape(-1, 3), self.uv, self.query_sparsity,
                self.lpips)
            q_rgb.append(rgb_sel)
            q_uv.append(uv)
            q_intr.append(intr)
            q_c2w.append(c2w)

        c_rgb, c_intr, c_c2w = [], [], []
        for i in id_feat:
            rgb, intr, c2w = _load_frame(data, files[i], pose, ts[i],
                                         rng, self.augment,
                                         rgb_pre=pre.get(i),
                                         always_resize=self.always_resize)
            c_rgb.append(rgb)
            c_intr.append(intr)
            c_c2w.append(c2w)

        return {
            'context': {'rgb': np.stack(c_rgb),
                        'cam2world': np.stack(c_c2w),
                        'intrinsics': np.stack(c_intr)},
            'query': {'rgb': np.stack(q_rgb),
                      'cam2world': np.stack(q_c2w),
                      'intrinsics': np.stack(q_intr),
                      'uv': np.stack(q_uv).astype(np.float32),
                      'mask': np.float32(mask)},
        }


def context_ids(views: int, end: int) -> list[int]:
    """The evaluation and trajectory context frames: ``views`` frames
    evenly spaced over [0, end], [0] for one view. At 1-3 views these are
    the reference's {0}, {0, end} and {0, end // 2, end}
    (realestate10k_dataio.py:104-188, :469-595); 4 views and more (which the
    reference and the JAX loaders do not take) extend the spacing."""
    if views == 1:
        return [0]
    return [end * i // (views - 1) for i in range(views)]


class RealEstate10kVis(RealEstate10k):
    """Deterministic eval variant: context {0, min(128, n-1)} (plus midpoint
    at 3 views, :func:`context_ids`), query >= 10 frames from every context
    (realestate10k_dataio.py:469-595)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault('augment', False)
        kwargs.setdefault('query_sparsity', None)
        super().__init__(*args, **kwargs)

    def _sample_ids(self, n_frames: int,
                    rng: Optional[np.random.Generator] = None):
        rng = self.rng if rng is None else rng
        start, end = 0, min(n_frames - 1, 128)
        id_feat = np.array(context_ids(self.num_ctxt_views, end))
        ok = [i for i in range(start, end)
              if np.abs(id_feat - i).min() > 10]
        if not ok:
            return None
        return id_feat, np.array([rng.choice(ok)])


def trajectory_scene(scene_path, pose_dir, views: int = 2,
                     n_frames: int = 128) -> dict:
    """Full camera trajectory for video rendering. Ref: ``get_camera_pose``
    (realestate10k_dataio.py:104-188). Query = frames 1..n-1; context =
    endpoints (+ midpoint at 3 views, :func:`context_ids`).

    ``pose_dir`` is either a directory of per-scene ``<scene>.txt`` pose
    files (the RealEstate10K distribution format) or a ``poses.mat`` scene
    table (the scraped-corpus layout, realestate10k_dataio.py:193-215).
    Letterboxed 256x455 frames are center square-cropped like the
    training loader."""
    scene_path = Path(scene_path)
    data = np.load(sorted(scene_path.glob('*.npz'))[0])
    files = list(data.keys())
    ts = np.array([int(f.split('.')[0]) for f in files])
    order = np.argsort(ts)
    files, ts = np.array(files)[order], ts[order]

    rows = {}
    pose_dir = Path(pose_dir)
    if pose_dir.suffix == '.mat':
        from scipy.io import loadmat
        table = loadmat(str(pose_dir))[scene_path.name]
        for row in np.asarray(table, np.float64):
            rows[int(row[0])] = row
    else:
        with open(pose_dir / f'{scene_path.name}.txt') as f:
            for i, line in enumerate(f):
                if i == 0:
                    continue
                row = np.array([float(x) for x in line.split()])
                rows[int(row[0])] = row
    n = min(n_frames, len(files))

    def frame(i):
        cam = Camera.from_row(rows[ts[i]])
        intr = unnormalize_intrinsics(cam.intrinsics, IMG_H, IMG_W)
        intr[0, 2] /= IMG_W / CROP
        intr[1, 2] /= IMG_H / CROP
        rgb = data[files[i]].astype(np.float32) / 127.5 - 1.0
        if rgb.shape[0] != rgb.shape[1]:
            rgb = square_crop(rgb)
        return rgb, intr.astype(np.float32), cam.c2w.astype(np.float32)

    q = [frame(i) for i in range(1, n)]
    c = [frame(i) for i in context_ids(views, min(len(files) - 1, 128))]
    uv = full_uv_grid()
    return {
        'context': {'rgb': np.stack([x[0] for x in c])[None],
                    'cam2world': np.stack([x[2] for x in c])[None],
                    'intrinsics': np.stack([x[1] for x in c])[None]},
        'query': {'rgb': np.stack([x[0] for x in q])[None],
                  'cam2world': np.stack([x[2] for x in q])[None],
                  'intrinsics': np.stack([x[1] for x in q])[None],
                  'uv': np.broadcast_to(uv, (1, n - 1) + uv.shape)},
    }


def collate(items: list) -> dict:
    """Items (nested dicts of arrays and numbers) stacked leaf by leaf into
    torch tensors on the CPU; a leaf of scalars (the query 'mask') stacks
    to (B,)."""
    first = items[0]
    if isinstance(first, dict):
        return {k: collate([it[k] for it in items]) for k in first}
    return torch.from_numpy(np.stack([np.asarray(x) for x in items]))


def batch_iterator(dataset, batch_size: int, seed: int = 0,
                   to_device: bool = True, num_workers: int = 0,
                   prefetch: int = 2, shard: tuple[int, int] = (0, 1),
                   device='cuda') -> Iterator[dict]:
    """Deterministic sharded-shuffle batch iterator (replaces the reference's
    8-worker-per-rank torch DataLoader, train_realestate10k.py:80-86).

    Batches are nested dicts of torch tensors (:func:`collate`), on
    ``device`` when ``to_device``, else on the CPU.

    ``num_workers > 0`` loads items on a thread pool and assembles batches on
    a background thread, keeping up to ``prefetch`` batches ahead of the
    training step — input decode (which runs GIL-free in the native C++
    core) overlaps the card's compute instead of serializing with it.

    ``shard=(process_index, process_count)``: multi-host input sharding.
    ``batch_size`` stays the GLOBAL batch; every process draws the same
    shuffle (same seed) and yields only its contiguous
    ``batch_size // process_count`` rows of each global batch — the
    deterministic split that replaces the reference's per-rank independent
    full-dataset shuffle (train_realestate10k.py:80-86). Item serials stay
    globally unique so seeded augmentations differ across processes' rows.
    """
    pid, nproc = shard
    assert 0 <= pid < nproc, shard
    assert batch_size % nproc == 0, (batch_size, nproc)
    local_bs = batch_size // nproc
    rng = np.random.default_rng(seed)
    n = len(dataset)
    if n == 0:
        raise ValueError('batch_iterator: the dataset is empty')
    seeded = getattr(dataset, 'getitem_seeded', None)

    def batches() -> Iterator[np.ndarray]:
        # One shuffle an epoch, cut into whole global batches (the tail is
        # dropped). A dataset smaller than one batch, which the JAX
        # package's iterator waits on forever, fills each batch from
        # successive shuffles instead.
        while True:
            if n >= batch_size:
                order = rng.permutation(n)
                for i in range(0, n - batch_size + 1, batch_size):
                    yield order[i:i + batch_size]
            else:
                yield np.concatenate([rng.permutation(n) for _ in
                                      range(-(-batch_size // n))]
                                     )[:batch_size]

    def index_stream() -> Iterator[tuple]:
        # (index, serial) pairs; the serial is handed out single-threaded so
        # seeded datasets stay reproducible under multi-worker prefetch.
        serial = 0
        for chunk in batches():
            for k, j in enumerate(chunk[pid * local_bs:
                                        (pid + 1) * local_bs]):
                yield int(j), serial + pid * local_bs + k
            serial += batch_size

    def fetch(job: tuple) -> dict:
        idx, serial = job
        return dataset[idx] if seeded is None else seeded(idx, serial)

    def assemble(items: list) -> dict:
        for it in items:
            it.pop('sequence', None)  # non-numeric metadata (CO3D)
        batch = collate(items)
        return trainer.to_device(batch, device) if to_device else batch

    idxs = index_stream()
    if num_workers <= 0:
        while True:
            yield assemble([fetch(next(idxs)) for _ in range(local_bs)])
        return

    import queue
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    out: 'queue.Queue' = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def producer():
        try:
            with ThreadPoolExecutor(num_workers) as pool:
                pending: deque = deque()
                while not stop.is_set():
                    while len(pending) < local_bs * (prefetch + 1):
                        pending.append(pool.submit(fetch, next(idxs)))
                    items = [pending.popleft().result()
                             for _ in range(local_bs)]
                    batch = assemble(items)
                    while not stop.is_set():
                        try:
                            out.put(batch, timeout=0.2)
                            break
                        except queue.Full:
                            pass
        except BaseException as e:  # surface worker crashes to the consumer
            while not stop.is_set():
                try:
                    out.put(e, timeout=0.2)
                    break
                except queue.Full:
                    try:  # drop a stale batch so the error can land
                        out.get_nowait()
                    except queue.Empty:
                        pass

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = out.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
