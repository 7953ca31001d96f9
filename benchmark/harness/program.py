"""The system under test: the PyTorch and CUDA port, driven through its
normal entry points. This is the only module of the benchmark that imports
the program.

* render: ``train/evaluation.py:make_image_renderer(model, blocks)``'s
  ``encode`` and ``render_image`` over ``CrossAttentionRenderer``;
* train: ``train/trainer.py:make_train_step(model, TrainConfig())`` over
  ``create_train_state``.

The model is built on the meta device (no host-side draw of its weights)
and takes the benchmark's weights, made on the card from the seed.
"""

from __future__ import annotations

import torch

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def build_kernels(cfg: dict, route: str) -> None:
    """Compiles, all at once, the kernel sources that ``route`` launches
    for ``cfg`` (into the program's build folder, keyed by their sources;
    a later run finds them built). The train step's default route
    launches none."""
    from cross_attention_renderer_torch.ops import _build
    if route != 'render':
        return
    core = 'gather_epilogue' if cfg['n_view'] == 2 else 'gather_epilogue_multi'
    _build.build(('epipolar_attention', core))


def make_model(cfg: dict, weights: dict, device):
    """``CrossAttentionRenderer`` of ``cfg`` holding ``weights``. Only the
    DPT hybrid (``model`` ``midas_vit``) takes sizes of its own; the
    ResNet34 and the U-Net have their published ones."""
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    dpt = {}
    if cfg['model'] == 'midas_vit':
        dpt = dict(fusion_features=cfg['fusion_features'],
                   vit_width=cfg['vit_width'], vit_depth=cfg['vit_depth'],
                   vit_heads=cfg['vit_heads'],
                   resnet_layers=tuple(cfg['resnet_layers']))
    with torch.device('meta'):
        model = CrossAttentionRenderer(
            n_view=cfg['n_view'], npoints=cfg['n_samples'],
            model=cfg['model'], dtype=DTYPES[cfg['dtype']], device='meta',
            **dpt)
    model = model.to_empty(device=device)
    model.load_state_dict(weights)
    return model


def render_entry(model, cfg: dict):
    """(encode(scene) -> pyramid, render_image(scene, pyramid) -> (rgb,
    valid)) of the whole query image in ``cfg['ray_blocks']`` blocks."""
    from cross_attention_renderer_torch.train.evaluation import (
        make_image_renderer)
    return make_image_renderer(model, cfg['ray_blocks'])


def train_entry(model):
    """(state, step): step 0 of ``model`` under the reference recipe's
    ``TrainConfig()`` (stage 1: L1 image loss, Adam 5e-5, clip 1.0), and
    its train step, ``step(state, scene) -> (state, metrics)``."""
    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)
    cfg = TrainConfig()
    state = create_train_state(model, cfg)
    return state, make_train_step(model, cfg), cfg


def adam_first_moments(state, names: dict) -> dict:
    """{name: Adam's first moment} of every parameter the optimizer holds
    (``names``: id(param) -> name)."""
    opt = state.optimizer
    return {names[id(p)]: opt.adam.state[p]['exp_avg']
            for p in opt.params if p in opt.adam.state}
