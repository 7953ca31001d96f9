"""Generate a multi-GB on-disk RealEstate10K-format corpus for throughput
runs (reference layout: per-scene dir with one npz of raw uint8 frames
keyed '<timestamp>.png', plus one .mat pose table; realestate10k_dataio.py).

Port of the JAX package's ``tools/make_corpus.py``, which imports the JAX
package's synthetic worlds (and so needs jax): this writer takes them from
``cross_attention_renderer_torch/data/synthetic.py`` and otherwise runs
numpy and scipy. For the same flags both write the same arrays (the npz
members and the pose table; the zip archives' timestamps differ).

Includes the defect classes real scrapes contain (the reason the
reference's loader resamples, realestate10k_dataio.py:259-278): a scene
with no npz, a truncated npz, a scene absent from the pose table, a
<=10-frame scene, plus 360p frames mixed in (the pre-resize path).

``--world boxes`` makes the corpus GEOMETRICALLY CONSISTENT: every frame
is an analytic render of that scene's occlusion world
(data/synthetic.py:_render_boxes) at the pose-table camera, so training
through the full data path (native loader -> augment -> sampler -> CLI)
can actually learn view synthesis and held-out eval measures quality, not
just plumbing. ``--seed_base`` separates train/val world populations.

Generation is chunk-parallel: each invocation writes scenes
[--start, --start + --scenes) plus a ``poses_part<start>.mat``; a final
``--merge`` pass combines the parts into the ``poses.mat`` the loader
reads. Per-scene rng seeding keeps any chunking deterministic.

Usage:
  # 4-way parallel 40-scene corpus with defect scenes in chunk 0:
  for s in 0 10 20 30; do
    python -m cross_attention_renderer_torch.tools.make_corpus \
        --root corpus/re10k_boxes --world boxes \
        --start $s --scenes 10 --defects $((s == 0)) &
  done; wait
  python -m cross_attention_renderer_torch.tools.make_corpus \
      --root corpus/re10k_boxes --merge
  # held-out val worlds:
  python -m cross_attention_renderer_torch.tools.make_corpus \
      --root corpus/re10k_boxes_val --world boxes --scenes 8 \
      --seed_base 5000 --defects 0
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
from scipy.io import savemat

H, W = 256, 455          # reference video frames (256p letterboxed)
N_FRAMES = 140


def pose_rows(rng, n):
    rows = []
    base = np.eye(4)
    for t in range(n):
        ts = 1000 * t
        w2c = base.copy()
        w2c[:3, 3] += rng.normal(0, 0.02, 3) + [0, 0, 0.01 * t]
        rows.append([ts, 0.9, 1.6, 0.5, 0.5, 0, 0,
                     *w2c[:3, :].reshape(-1)])
    return np.asarray(rows)


# --- geometrically consistent ('boxes' world) corpus ----------------------

# normalized intrinsics written to the pose table; pixel units follow the
# reference convention (fx*W, fy*H) — square pixels at 256x455
FX, FY, CX, CY = 0.9, 1.6, 0.5, 0.5


def _world_pose_rows(rng, n):
    """Smooth wide-baseline camera arc over the world: radius-2 orbit
    around the origin (the world sits near z=0) with small jitter, the
    kind of dolly real clips have. Frame 0 vs frame 128 ends up ~35
    degrees apart — the paper's wide-baseline setting."""
    from cross_attention_renderer_torch.data.synthetic import (
        look_at_cam2world)
    rows = []
    arc = np.deg2rad(40.0)
    phase = rng.uniform(0, 2 * np.pi)
    for t in range(n):
        a = phase + arc * (t / max(n - 1, 1) - 0.5)
        eye = np.array([1.9 * np.sin(a), 0.25 * np.sin(2.3 * a),
                        -1.9 * np.cos(a)])
        eye += rng.normal(0, 0.01, 3)
        c2w = look_at_cam2world(eye, np.array([0.0, 0.0, 0.0]),
                                up=(0.0, 1.0, 0.0))
        w2c = np.linalg.inv(c2w)
        rows.append([1000 * t, FX, FY, CX, CY, 0, 0,
                     *w2c[:3, :].reshape(-1)])
    return np.asarray(rows)


def _render_world_frames(scene_seed: int, rows: np.ndarray) -> dict:
    """Render every pose-table camera against the scene's boxes world."""
    from cross_attention_renderer_torch.data.synthetic import (
        _render_boxes, _world_rects)
    K = np.eye(4)
    K[0, 0], K[1, 1] = FX * W, FY * H
    K[0, 2], K[1, 2] = CX * W, CY * H
    rects = _world_rects(scene_seed, 6)
    frames = {}
    for row in rows:
        w2c = np.eye(4)
        w2c[:3, :] = row[7:19].reshape(3, 4)
        c2w = np.linalg.inv(w2c)
        rgb = _render_boxes(c2w, K, H, W, rects)       # [-1, 1]
        frames[f'{int(row[0])}.png'] = np.clip(
            (rgb + 1.0) * 127.5, 0, 255).astype(np.uint8)
    return frames


def textured(rng, h, w):
    """Cheap structured frames (pure noise defeats any decode caching but
    compresses to nothing visually; gradients + noise is closer to video)."""
    yy, xx = np.mgrid[0:h, 0:w]
    f1, f2 = rng.uniform(0.02, 0.2, 2)
    base = (np.sin(xx * f1) * np.cos(yy * f2) * 80 + 128)
    img = base[..., None] + rng.normal(0, 30, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--root', required=True)
    ap.add_argument('--scenes', type=int, default=50)
    ap.add_argument('--frames', type=int, default=N_FRAMES)
    ap.add_argument('--world', choices=['noise', 'boxes'], default='noise',
                    help="'boxes': multi-view-consistent analytic worlds "
                         "(learnable); 'noise': textured noise (throughput)")
    ap.add_argument('--seed_base', type=int, default=0,
                    help='world-seed offset (separate train/val worlds)')
    ap.add_argument('--defects', type=int, default=1,
                    help='include the defect-class scenes (0/1)')
    ap.add_argument('--start', type=int, default=0,
                    help='first scene index of this chunk (parallel '
                         'generation: run N processes with disjoint '
                         '--start ranges, then --merge)')
    ap.add_argument('--merge', action='store_true',
                    help='merge poses_part*.mat chunks into poses.mat '
                         'and exit')
    args = ap.parse_args(argv)

    root = Path(args.root)
    if args.merge:
        poses = {}
        parts = sorted(root.glob('poses_part*.mat'))
        from scipy.io import loadmat
        for part in parts:
            d = {k: v for k, v in loadmat(str(part)).items()
                 if not k.startswith('__')}
            # stale parts from an earlier run with different chunking or
            # seed_base silently shadow each other — make that loud
            dup = sorted(set(d) & set(poses))
            if dup:
                print(f'WARNING: {part.name} redefines {len(dup)} scene(s) '
                      f'from an earlier part (e.g. {dup[0]}) — stale '
                      f'poses_part*.mat from a previous run with different '
                      f'chunking? Delete the old parts and re-merge.')
            poses.update(d)
        savemat(root / 'poses.mat', poses)
        print(f'merged {len(parts)} parts, {len(poses)} scenes '
              f'-> {root / "poses.mat"}')
        return

    img_root = root / 'frames'
    img_root.mkdir(parents=True, exist_ok=True)
    poses = {}
    total = 0
    for s in range(args.start, args.start + args.scenes):
        # per-scene rng: chunk-parallel generation stays deterministic
        rng = np.random.default_rng(args.seed_base * 100003 + s)
        name = f'scene{s:04d}'
        sdir = img_root / name
        sdir.mkdir(exist_ok=True)
        if args.world == 'boxes':
            rows = _world_pose_rows(rng, args.frames)
            frames = _render_world_frames(args.seed_base + s, rows)
        else:
            rows = pose_rows(rng, args.frames)
            frames = {}
            for t in range(args.frames):
                hw = (360, 640) if (s % 7 == 0 and t % 5 == 0) else (H, W)
                frames[f'{1000 * t}.png'] = textured(rng, *hw)
        np.savez(sdir / 'data.npz', **frames)
        total += sum(a.nbytes for a in frames.values())
        poses[name] = rows
        print(f'{name} done', flush=True)

    def write_poses():
        savemat(root / f'poses_part{args.start:04d}.mat', poses)
        if args.start == 0:
            # single-invocation workflow: the loader needs poses.mat, so the
            # default chunk writes it directly; multi-chunk runs overwrite
            # it with --merge afterwards.
            savemat(root / 'poses.mat', poses)

    if not args.defects:
        write_poses()
        print(f'{args.scenes} {args.world} scenes (chunk @{args.start}), '
              f'{total / 1e9:.2f} GB frames at {root}')
        return

    # defect classes (their own pose-part; rng independent of the scenes)
    rng = np.random.default_rng(args.seed_base * 100003 + 99991)
    (img_root / 'scene_no_npz').mkdir(exist_ok=True)
    poses['scene_no_npz'] = pose_rows(rng, 20)

    sdir = img_root / 'scene_truncated'
    sdir.mkdir(exist_ok=True)
    good = {f'{1000 * t}.png': textured(rng, H, W) for t in range(20)}
    np.savez(sdir / 'data.npz', **good)
    raw = (sdir / 'data.npz').read_bytes()
    (sdir / 'data.npz').write_bytes(raw[:len(raw) // 3])
    poses['scene_truncated'] = pose_rows(rng, 20)

    sdir = img_root / 'scene_unposed'     # npz fine, absent from .mat
    sdir.mkdir(exist_ok=True)
    np.savez(sdir / 'data.npz',
             **{f'{1000 * t}.png': textured(rng, H, W) for t in range(20)})

    sdir = img_root / 'scene_short'       # <= 10 frames -> rejected
    sdir.mkdir(exist_ok=True)
    np.savez(sdir / 'data.npz',
             **{f'{1000 * t}.png': textured(rng, H, W) for t in range(8)})
    poses['scene_short'] = pose_rows(rng, 8)

    # pose table covers only every other frame timestamp (ffmpeg extraction
    # and the pose scrape drift apart in real data); picks that land on an
    # uncovered frame raise in _pose_at and get resampled
    sdir = img_root / 'scene_ts_mismatch'
    sdir.mkdir(exist_ok=True)
    np.savez(sdir / 'data.npz',
             **{f'{1000 * t}.png': textured(rng, H, W) for t in range(40)})
    poses['scene_ts_mismatch'] = pose_rows(rng, 40)[::2]

    # odd-resolution scrape: neither 360p nor the expected 256x455 —
    # must be rejected (frame-size check), not silently mis-shaped
    sdir = img_root / 'scene_odd_res'
    sdir.mkdir(exist_ok=True)
    np.savez(sdir / 'data.npz',
             **{f'{1000 * t}.png': textured(rng, 144, 256)
                for t in range(20)})
    poses['scene_odd_res'] = pose_rows(rng, 20)

    write_poses()
    print(f'{args.scenes} scenes + 6 defects (chunk @{args.start}), '
          f'{total / 1e9:.2f} GB frames at {root}')


if __name__ == '__main__':
    main()
