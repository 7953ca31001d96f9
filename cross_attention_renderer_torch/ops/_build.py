"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`. Libraries land
in ``build/`` inside the package (listed in ``.gitignore``), named by a hash
of the source and flags, so an edited kernel rebuilds and an unchanged one
loads at once. Nothing here runs at import time: importing the package needs
neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR / 'build'
KERNELS = ('epipolar_attention', 'gather_epilogue')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``CUDA_HOME``, ``/usr/local/cuda`` or ``PATH``."""
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and (Path(root) / 'bin' / 'nvcc').exists():
            return str(Path(root) / 'bin' / 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                           'machine with the CUDA toolkit')
    return found


def library_path(name: str) -> Path:
    src = CSRC_DIR / f'{name}.cu'
    digest = hashlib.sha1(src.read_bytes()
                          + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{name}_{digest}.so'


def build(names=KERNELS) -> dict[str, str]:
    """Compiles the named kernels that are not built yet, all at once.

    Starts one ``nvcc`` per source, waits for all, and returns each
    compiler's output (``-Xptxas -v`` reports registers, shared memory and
    spills). Raises if any build fails."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc_path(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC_DIR / f'{name}.cu')]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)     # atomic: a reader never sees half a file
        else:
            failed.append(name)
    if failed:
        raise RuntimeError('nvcc failed for ' + ', '.join(failed) + ':\n'
                           + '\n'.join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build((name,))
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]


def check(code: int, what: str) -> None:
    """Raises if a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f'{what}: CUDA error {code} at launch')
