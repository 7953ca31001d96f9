"""ctypes bindings for the native C++ data-loading core (native/dataloader.cc).

Port of ``cross_attention_renderer_tpu/data/native_loader.py``. The JAX
package builds the library with ``make -C native/``, which writes
``native/libdataloader.so`` beside the source. The port leaves ``native/``
as it is: at first use it compiles ``native/dataloader.cc`` itself, with
the flags of ``native/Makefile``, into ``cross_attention_renderer_torch/
build/`` (git-ignored), named by a hash of the source. Where no compiler
is found or the build fails, :func:`available` is False and the loaders
take their numpy route, as the JAX package's do. The first call of
:func:`available` prints which loader the data layer uses.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / 'native' / 'dataloader.cc'
BUILD_DIR = Path(__file__).resolve().parents[1] / 'build'
CXXFLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall')   # native/Makefile
LDFLAGS = ('-shared', '-lz', '-lpthread')
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library for this source and these flags is built."""
    h = hashlib.sha1(SOURCE.read_bytes())
    h.update(' '.join(CXXFLAGS + LDFLAGS).encode())
    return BUILD_DIR / f'libdataloader_{h.hexdigest()[:12]}.so'


def _build(out: Path) -> Optional[str]:
    """Compiles the library into ``out``; returns None, or why it failed."""
    cxx = os.environ.get('CXX') or shutil.which('g++')
    if cxx is None or not SOURCE.exists():
        return 'no C++ compiler' if cxx is None else f'no {SOURCE}'
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    try:
        proc = subprocess.run([cxx, *CXXFLAGS, str(SOURCE), '-o', str(tmp),
                               *LDFLAGS], capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f'{cxx}: {e}'
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return proc.stderr.strip().splitlines()[-1] if proc.stderr else (
            f'{cxx} exited with {proc.returncode}')
    os.replace(tmp, out)     # atomic: a reader never sees half a file
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    why = None if path.exists() else _build(path)
    if why is None:
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            why = str(e)
    if why is not None:
        print(f'data loader: numpy route (native loader unavailable: '
              f'{why})', flush=True)
        return None
    lib.dl_open.restype = ctypes.c_void_p
    lib.dl_open.argtypes = [ctypes.c_char_p]
    lib.dl_close.argtypes = [ctypes.c_void_p]
    lib.dl_num_entries.argtypes = [ctypes.c_void_p]
    lib.dl_entry_name.restype = ctypes.c_char_p
    lib.dl_entry_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dl_load_frames.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    print(f'data loader: native route ({path.name})', flush=True)
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


class NativeNpz:
    """Native per-scene npz frame archive with parallel batched decoding."""

    def __init__(self, path: str | Path):
        lib = _load()
        if lib is None:
            raise RuntimeError('native dataloader unavailable')
        self._lib = lib
        self._h = lib.dl_open(str(path).encode())
        if not self._h:
            raise IOError(f'failed to open npz {path}')

    def keys(self) -> list[str]:
        n = self._lib.dl_num_entries(self._h)
        return [self._lib.dl_entry_name(self._h, i).decode()
                for i in range(n)]

    def load_frames(self, entries: Sequence[str], out_hw=(256, 256),
                    resize_hw=(0, 0), square_crop=True,
                    n_threads: int = 8) -> np.ndarray:
        """Decode+resize+crop+normalize frames to (N, H, W, 3) f32 in
        [-1, 1] on the worker pool."""
        n = len(entries)
        out = np.empty((n, out_hw[0], out_hw[1], 3), np.float32)
        arr = (ctypes.c_char_p * n)(*[e.encode() for e in entries])
        ok = self._lib.dl_load_frames(
            self._h, arr, n, out.ctypes.data_as(
                ctypes.POINTER(ctypes.c_float)),
            out_hw[0], out_hw[1], resize_hw[0], resize_hw[1],
            int(square_crop), n_threads)
        if ok != n:
            raise IOError(f'decoded {ok}/{n} frames')
        return out

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.dl_close(self._h)
