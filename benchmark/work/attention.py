"""Both rounds of joint (view, sample) attention (kernel K1,
``csrc/epipolar_attention.cu``, twice a ray block).

Its work: per (view, ray, sample) and round a query . key of K and a
weighted sum of the O-wide latent, the softmax over a ray's V*P logits.
Bytes, each read once for the pair of rounds: both rounds' queries, the
keys and the latents; written: each round's (ray, O) sum and (view, ray,
sample) weights, in the model's type. Bound by bytes.
"""

import importlib.util
from pathlib import Path

KERNELS = (r'epipolar_attention',)

_spec = importlib.util.spec_from_file_location(
    'bench_work_shapes', Path(__file__).with_name('shapes.py'))
shapes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(shapes)


def work(cfg: dict, images: int) -> tuple[float, float]:
    s = shapes.sizes(cfg)
    O, K = s['O'], s['K']
    rays = images * s['R']
    M = rays * s['V'] * s['P']
    ops = 2 * M * (2 * K + 2 * O + 5)
    nbytes = 2 * (M * (3 * K + O) + 2 * (rays * O + M))
    return float(ops), float(nbytes)
