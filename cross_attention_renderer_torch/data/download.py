"""Data acquisition (L8): build RealEstate10K / ACID per-scene npz archives.

Port of ``cross_attention_renderer_tpu/data/download.py`` (numpy and the
standard library; no torch), a re-implementation of the reference's
downloaders
(``data_download/generate_realestate.py`` / ``generate_acid.py``): parse the
per-scene pose .txt files (YouTube URL + per-frame timestamps/cameras),
download each video once, extract the pose-timestamped frames with ffmpeg,
and pack them into ``<scene>/data.npz`` keyed by ``<timestamp>.jpg``.

Video download is pluggable: :func:`build_dataset` takes the fetcher as an
argument (the reference hard-codes pytube; the default here uses pytube or
yt-dlp where one is installed), and ``extract_scene`` also accepts a local
video file, so everything but the fetch runs offline.
Failures are logged and skipped, mirroring generate_realestate.py:139-145.
"""

from __future__ import annotations

import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional

import numpy as np


def parse_scene_txt(path: str | Path) -> tuple[str, list[int]]:
    """Scene .txt -> (youtube url, microsecond timestamps).

    Ref: generate_realestate.py DataDownloader.__init__ (the first line is
    the URL; column 0 of each following line is the timestamp)."""
    lines = Path(path).read_text().splitlines()
    url = lines[0].strip()
    timestamps = [int(ln.split(' ')[0]) for ln in lines[1:] if ln.strip()]
    return url, timestamps


def _timestamp_str(ts_us: int) -> str:
    """Microseconds -> ffmpeg HH:MM:SS.mmm. Ref: generate_realestate.py:44-51."""
    ms = int(ts_us / 1000)
    return (f'{ms // 3600000:02d}:{(ms % 3600000) // 60000:02d}:'
            f'{(ms % 60000) // 1000:02d}.{ms % 1000:03d}')


def extract_scene(video_path: str | Path, timestamps_us: list[int],
                  out_dir: str | Path, quality: int = 1) -> Path:
    """ffmpeg-extract the pose-timestamped frames and pack data.npz.

    Ref: ``process`` (generate_realestate.py:30-72)."""
    import imageio.v2 as imageio
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    npz_path = out_dir / 'data.npz'
    if npz_path.exists():
        return npz_path
    images = {}
    for ts in timestamps_us:
        frame_path = out_dir / f'{ts}.jpg'
        cmd = ['ffmpeg', '-y', '-ss', _timestamp_str(ts), '-i',
               str(video_path), '-vframes', '1', '-q:v', str(quality),
               '-f', 'image2', str(frame_path)]
        subprocess.run(cmd, capture_output=True, check=False)
        if frame_path.exists():
            images[f'{ts}.jpg'] = np.asarray(imageio.imread(frame_path))
            frame_path.unlink()
    if not images:
        raise IOError(f'no frames extracted from {video_path}')
    np.savez(npz_path, **images)
    return npz_path


def default_video_fetcher(url: str, out_path: Path) -> Optional[Path]:
    """Download a 360p stream with pytube or yt-dlp, whichever is present."""
    try:
        from pytube import YouTube  # type: ignore
        stream = YouTube(url).streams.filter(res='360p').first()
        if stream is None:
            return None
        stream.download(str(out_path.parent), out_path.name)
        return out_path
    except ImportError:
        pass
    except Exception:
        return None
    if shutil.which('yt-dlp'):
        rc = subprocess.run(
            ['yt-dlp', '-f', 'bestvideo[height<=360]', '-o', str(out_path),
             url], capture_output=True)
        return out_path if rc.returncode == 0 and out_path.exists() else None
    raise RuntimeError('no video downloader available '
                       '(install pytube or yt-dlp)')


def build_dataset(pose_txt_dir: str | Path, output_root: str | Path,
                  fetcher: Callable = default_video_fetcher,
                  workers: int = 4) -> list[str]:
    """Download + extract every scene; returns the failed scene names.

    Ref: ``DataDownloader.Run`` (generate_realestate.py:130-180): one video
    download per URL, scene extraction fanned out over a worker pool,
    failures appended to ``failed_videos.txt``.
    """
    pose_txt_dir = Path(pose_txt_dir)
    output_root = Path(output_root)
    output_root.mkdir(parents=True, exist_ok=True)

    by_url: dict[str, list[tuple[str, list[int]]]] = {}
    for txt in sorted(pose_txt_dir.glob('*.txt')):
        url, ts = parse_scene_txt(txt)
        by_url.setdefault(url, []).append((txt.stem, ts))

    failed: list[str] = []
    for url, scenes in by_url.items():
        video = fetcher(url, output_root / '_current_video.mp4')
        if video is None:
            failed.extend(name for name, _ in scenes)
            with open(output_root / 'failed_videos.txt', 'a') as f:
                f.writelines(name + '\n' for name, _ in scenes)
            continue
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(
                lambda s: extract_scene(video, s[1], output_root / s[0]),
                scenes))
        Path(video).unlink(missing_ok=True)
    return failed
