"""The benchmark's CPU tests: the harness and the reference at tiny sizes.
Run from the repo root: ``python -m pytest benchmark/tests``."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent)):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402


def tiny_config(n_view: int = 2, model: str = 'midas_vit', **kw) -> dict:
    """The flagship's architecture at widths a CPU test holds; the
    ResNet34 and the U-Net (``model`` ``resnet``, ``unet``) at their
    published widths, which a 32x32 image holds, with none of the DPT's
    keys."""
    cfg = {'name': 'tiny', 'model': model, 'n_view': n_view,
           'n_samples': 8, 'image_size': [32, 32], 'dtype': 'float32',
           'ray_blocks': 2}
    if model == 'midas_vit':
        cfg.update(fusion_features=32, vit_width=64, vit_depth=2,
                   vit_heads=2, resnet_layers=[1, 1, 1], pretrain_grid=14)
    cfg.update(kw)
    return cfg


@pytest.fixture
def tiny():
    return tiny_config
