"""The latent exchange (``models/renderer.py``'s fused epilogues: kernels
K2 at two views and K3 at three and more, on ``csrc/exchange_core.cuh``).

Its work, whatever kernel does it: for every (view, ray, sample) and each
of the V streams (the view's own maps and each other view's), the fuse
MLP ([pyramid features | tanh(pt / 5)] -> F -> O); then per sample the
latent (V*O -> O) and key (V*O -> K -> K) products. Bytes: the views'
pyramids, each sample's position and point a stream (f32), the weights
and the latent and key written (the model's type), each once.
"""

import importlib.util
from pathlib import Path

KERNELS = (r'exchange_core',)

_spec = importlib.util.spec_from_file_location(
    'bench_work_shapes', Path(__file__).with_name('shapes.py'))
shapes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(shapes)


def work(cfg: dict, images: int) -> tuple[float, float]:
    """(operations, bytes) of the exchange for ``images`` whole images."""
    s = shapes.sizes(cfg)
    V, F, O, K = s['V'], s['F'], s['O'], s['K']
    M = images * V * s['R'] * s['P']
    macs = M * (V * ((F + 3) * F + F * O) + V * O * O + V * O * K + K * K)
    weights = ((F + 3) * F + F * O + V * O * O + V * O * K + K * K) * 2
    nbytes = (images * V * shapes.pyramid_bytes(cfg) + M * V * 5 * 4
              + weights + M * (O + K) * 2)
    return 2.0 * macs, float(nbytes)
