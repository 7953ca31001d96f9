"""Writes synthetic LPIPS weights through the port's conversion path.

  python -m cross_attention_renderer_torch.tools.make_synthetic_lpips \\
      [--out cross_attention_renderer_torch/build/lpips_synthetic.npz] \\
      [--seed 0]

Port of the JAX repository's ``tools/make_synthetic_lpips.py``: the real
blobs (torchvision's VGG16 features and the lpips package's lin layers,
reference loss_functions.py:102-118) are not in the repository and cannot
be fetched, so this draws a torch-layout state dict of the same shapes from
numpy's ``default_rng(seed)`` in the JAX tool's order (He-scaled 3x3
filters, zero biases, lin weights uniform in [0.01, 0.1)), runs it through
``losses/lpips.py:convert_weights`` (the code a user with the real blobs
runs) and writes the npz that ``load_lpips`` and ``$LPIPS_WEIGHTS`` read;
for the same seed it equals the JAX tool's npz. The default path lies
under the package's git-ignored ``build/``. A synthetic LPIPS is still a
smooth multi-scale distance, so a stage-2 fine-tune against it exercises
every line of the curriculum; only its agreement with human judgement
differs.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# torchvision vgg16().features conv layer indices and (out, in) channels
VGG16_CONVS = [
    (0, 64, 3), (2, 64, 64),
    (5, 128, 64), (7, 128, 128),
    (10, 256, 128), (12, 256, 256), (14, 256, 256),
    (17, 512, 256), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]
LIN_CHANNELS = [64, 128, 256, 512, 512]
DEFAULT_OUT = (Path(__file__).resolve().parents[1] / 'build'
               / 'lpips_synthetic.npz')


def synthetic_state(seed: int) -> tuple[dict, dict]:
    """(vgg16 features state dict, lpips lin state dict) of numpy arrays."""
    rng = np.random.default_rng(seed)
    vgg_state = {}
    for layer, out_c, in_c in VGG16_CONVS:
        std = np.sqrt(2.0 / (in_c * 9))
        vgg_state[f'{layer}.weight'] = rng.normal(
            0, std, (out_c, in_c, 3, 3)).astype(np.float32)
        vgg_state[f'{layer}.bias'] = np.zeros(out_c, np.float32)
    lpips_state = {
        f'lin{i}.model.1.weight':
            rng.uniform(0.01, 0.1, (1, c, 1, 1)).astype(np.float32)
        for i, c in enumerate(LIN_CHANNELS)}
    return vgg_state, lpips_state


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--out', default=str(DEFAULT_OUT))
    p.add_argument('--seed', type=int, default=0)
    opt = p.parse_args(argv)
    from cross_attention_renderer_torch.losses.lpips import convert_weights
    path = convert_weights(*synthetic_state(opt.seed), opt.out)
    print(f'synthetic LPIPS weights at {path} '
          f'(export LPIPS_WEIGHTS={path})', flush=True)
    return Path(path)


if __name__ == '__main__':
    main()
