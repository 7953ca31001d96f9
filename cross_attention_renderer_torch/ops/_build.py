"""Builds the hand-written CUDA kernels under ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with :mod:`ctypes`. Libraries land
in ``build/`` inside the package (listed in ``.gitignore``), named by a hash
of the source, the shared headers ``csrc/*.cuh`` and the flags, so an
edited kernel rebuilds and an unchanged one loads at once. A variant
(``VARIANTS``) is a source built with a define into a library of its own,
on first use. Nothing here runs at import time: importing the package
needs neither ``nvcc`` nor a card.
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
KERNELS = ('epipolar_attention', 'gather_epilogue', 'gather_epilogue_multi',
           'fused_mlp', 'fused_render', 'bilinear_gather', 'row_gather',
           'stream_takes')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
# name -> (source, defines): K2, K3 and K9 at an odd output width
# (csrc/exchange_core.cuh, "Output widths"), which the usual builds refuse
VARIANTS = {f'{name}_odd': (name, ('-DCORE_ODD_OUTPUT=1',))
            for name in ('gather_epilogue', 'gather_epilogue_multi',
                         'fused_mlp')}
# The exchange core's sources (4-12 instantiations of one large kernel
# each) are optimized in parallel by nvcc's split compilation: half the
# time of the longest build (143 -> 69 s, all sources at once on an
# 8-core host, nvcc 12.9), the same SASS (compared with cuobjdump).
SPLIT_SOURCES = ('gather_epilogue', 'gather_epilogue_multi', 'fused_mlp',
                 'fused_render')
SPLIT_FLAGS = ('-split-compile=0',)

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


def source_flags(name: str) -> tuple[str, tuple[str, ...]]:
    """The source of library ``name`` and the flags it builds with beyond
    ``NVCC_FLAGS``: a variant's defines, the core's split compilation."""
    source, defines = VARIANTS.get(name, (name, ()))
    return source, defines + (SPLIT_FLAGS if source in SPLIT_SOURCES
                              else ())


def library_path(name: str) -> Path:
    source, extra = source_flags(name)
    h = hashlib.sha1((CSRC_DIR / f'{source}.cu').read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        h.update(header.read_bytes())
    h.update(' '.join(NVCC_FLAGS + extra).encode())
    digest = h.hexdigest()[:12]
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
        source, extra = source_flags(name)
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, '-o', str(tmp),
               str(CSRC_DIR / f'{source}.cu')]
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


def use(name: str, lib: ctypes.CDLL | None) -> None:
    """Makes :func:`load` give ``lib`` for ``name``: a variant of the
    source built elsewhere, as the tools' studies build them. None: the
    package's own build again."""
    if lib is None:
        _loaded.pop(name, None)
    else:
        _loaded[name] = lib


def check(code: int, what: str) -> None:
    """Raises if a launcher returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f'{what}: CUDA error {code} at launch')
