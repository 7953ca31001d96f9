"""Convert an upstream CrossAttentionRenderer checkpoint to the port's
state dict.

Maps the PyTorch state dict of yilundu/cross_attention_renderer
(``torch.save({'model': state_dict, ...})``, training.py:118-120) onto
:class:`~cross_attention_renderer_torch.models.renderer.
CrossAttentionRenderer`, every key that the JAX repository's
``tools/convert_checkpoint.py`` maps, straight into the port's layouts. The
port keeps the upstream torch layouts, so only names change, and:

  Conv2d / Conv1d 1x1 (o, i, 1[, 1]) -> Dense weight (o, i), or a
                                        SplitDense kernel (i, o)
  timm ViT qkv fused (3E, E), (3E,)   -> attention query / key / value
                                        weights (E, E) and biases (E,)
  GroupNorm / LayerNorm weight, bias  -> weight, bias (of the port's norm
                                        module)

The upstream weights are not in this repository, and nothing here fetches
them. Usage:

  python -m cross_attention_renderer_torch.tools.convert_checkpoint \\
      --torch_ckpt model.pth --out params.pt --views 2

writes ``{'params': state_dict, 'step': 0}``, which ``--checkpoint_path
params.pt`` loads into the ``eval``, ``render_traj`` and ``train`` CLIs
(``train/trainer.py`` ``restore_checkpoint``) at that view count, and
prints the upstream keys it left unmapped. The encoder's depths (the
upstream model's: 12 ViT blocks, ResNet stages of 3, 4 and 9 blocks) are
read off the upstream keys.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable

import numpy as np
import torch

Tensor = torch.Tensor

# Upstream head modules (reference constructor models.py:101-145) -> the
# port's module and its layout: 'split' a SplitDense kernel (in, out),
# 'dense' a Dense weight (out, in), 'conv' a Conv weight as it is.
HEAD_MAP: dict[str, str] = {
    'query_encode_latent': 'split',
    'query_encode_latent_2': 'split',
    'update_val_merge': 'dense',
    'latent_value': 'split',
    'key_map': 'split',
    'key_map_2': 'split',
    'query_embed': 'split',
    'query_embed_2': 'split',
    'encode_latent': 'split',            # Conv1d
    'query_repeat_embed': 'split',
    'query_repeat_embed_2': 'split',
    'conv_map': 'conv',                  # 7x7 full-resolution conv
}

ENCODER = 'encoder.pretrained.model.'
BACKBONE = ENCODER + 'patch_embed.backbone.'
SCRATCH = 'encoder.scratch.'


def _as_tensor(v) -> Tensor:
    """An upstream value (torch tensor or numpy array) as an f32 tensor of
    its own."""
    t = v.detach() if isinstance(v, Tensor) else torch.from_numpy(
        np.asarray(v))
    return t.to(torch.float32).contiguous().clone()


def _dense(w: Tensor) -> Tensor:
    """(o, i[, 1[, 1]]) -> (o, i)."""
    return w.reshape(w.shape[0], w.shape[1])


class _Mapper:
    """Fills the port's state dict from ``sd``, remembering which upstream
    keys it read."""

    def __init__(self, sd: dict):
        self.sd = sd
        self.out: dict[str, Tensor] = {}
        self.used: set[str] = set()

    def has(self, key: str) -> bool:
        return key in self.sd

    def get(self, key: str) -> Tensor:
        self.used.add(key)
        return _as_tensor(self.sd[key])

    def put(self, ours: str, theirs: str,
            fn: Callable[[Tensor], Tensor] = lambda t: t) -> None:
        """``ours`` = fn(``theirs``), where the upstream dict has it."""
        if self.has(theirs):
            self.out[ours] = fn(self.get(theirs)).contiguous()

    def layer(self, ours: str, theirs: str,
              fn: Callable[[Tensor], Tensor] = lambda t: t) -> None:
        """A layer's weight through ``fn`` and its bias as it is."""
        self.put(f'{ours}.weight', f'{theirs}.weight', fn)
        self.put(f'{ours}.bias', f'{theirs}.bias')


def _absent_heads(n_view: int) -> tuple[str, ...]:
    """The upstream head modules a model of ``n_view`` views does not
    build: the single-view merge above one view, the multi-view fuse MLP
    at one (models/renderer.py)."""
    return (('update_val_merge',) if n_view >= 2
            else ('query_encode_latent', 'query_encode_latent_2'))


def _heads(m: _Mapper, n_view: int) -> None:
    for ref, kind in HEAD_MAP.items():
        if not m.has(f'{ref}.weight') or ref in _absent_heads(n_view):
            continue
        if kind == 'split':
            m.put(f'{ref}.kernel', f'{ref}.weight', lambda w: _dense(w).t())
            m.put(f'{ref}.bias', f'{ref}.bias')
        else:
            m.layer(ref, ref, _dense if kind == 'dense' else (lambda w: w))


def _phi(m: _Mapper, prefix: str = 'phi.') -> None:
    """The ResnetFC decoder: lin_z.{i} -> lin_z{i}, blocks.{i} ->
    block{i}."""
    m.layer('phi.lin_in', prefix + 'lin_in')
    m.layer('phi.lin_out', prefix + 'lin_out')
    i = 0
    while m.has(f'{prefix}blocks.{i}.fc_0.weight'):
        m.layer(f'phi.lin_z{i}', f'{prefix}lin_z.{i}')
        for fc in ('fc_0', 'fc_1'):
            m.layer(f'phi.block{i}.{fc}', f'{prefix}blocks.{i}.{fc}')
        i += 1


def _backbone(m: _Mapper, resnet_layers) -> None:
    """timm's ResNetV2 stem and stages (the ViT-hybrid's, non-preact)."""
    ours = 'encoder.backbone.'
    if not m.has(BACKBONE + 'stem.conv.weight'):
        return
    m.put(ours + 'stem_conv.weight', BACKBONE + 'stem.conv.weight')
    m.layer(ours + 'stem_norm.GroupNorm_0', BACKBONE + 'stem.norm')
    for s, n_blocks in enumerate(resnet_layers):
        for b in range(n_blocks):
            mine = f'{ours}stage{s}_block{b}.'
            theirs = f'{BACKBONE}stages.{s}.blocks.{b}.'
            for i in (1, 2, 3):
                m.put(f'{mine}conv{i}.weight', f'{theirs}conv{i}.weight')
                m.layer(f'{mine}norm{i}.GroupNorm_0', f'{theirs}norm{i}')
            m.put(mine + 'downsample_conv.weight',
                  theirs + 'downsample.conv.weight')
            m.layer(mine + 'downsample_norm.GroupNorm_0',
                    theirs + 'downsample.norm')


def _vit(m: _Mapper, vit_depth: int) -> None:
    """The ViT: tokens, embeddings and blocks, qkv split into query, key
    and value."""
    ours = 'encoder.vit.'
    if not m.has(ENCODER + 'cls_token'):
        return
    m.put(ours + 'cls_token', ENCODER + 'cls_token')
    m.put(ours + 'pos_embed', ENCODER + 'pos_embed')
    m.layer(ours + 'pose_embed', ENCODER + 'pose_embed')
    m.layer(ours + 'patch_proj', ENCODER + 'patch_embed.proj', _dense)
    for i in range(vit_depth):
        mine, theirs = f'{ours}block{i}.', f'{ENCODER}blocks.{i}.'
        for norm in ('norm1', 'norm2'):
            m.layer(mine + norm, theirs + norm)
        m.layer(mine + 'mlp_fc1', theirs + 'mlp.fc1')
        m.layer(mine + 'mlp_fc2', theirs + 'mlp.fc2')
        w = m.get(theirs + 'attn.qkv.weight')
        b = m.get(theirs + 'attn.qkv.bias')
        E = w.shape[1]
        for k, name in enumerate(('query', 'key', 'value')):
            m.out[f'{mine}attn.{name}.weight'] = w[k * E:(k + 1) * E].clone()
            m.out[f'{mine}attn.{name}.bias'] = b[k * E:(k + 1) * E].clone()
        m.layer(mine + 'attn.out', theirs + 'attn.proj')


def _dpt(m: _Mapper) -> None:
    """The DPT scratch (midas/blocks.py names): layer*_rn, the refinenets,
    the readout projections and the post-processing convs."""
    for i in (1, 2, 3, 4):
        m.put(f'encoder.layer{i}_rn.weight', f'{SCRATCH}layer{i}_rn.weight')
    for i in (1, 2, 3, 4):
        theirs = f'{SCRATCH}refinenet{i}.'
        if not m.has(theirs + 'out_conv.weight'):
            continue
        m.layer(f'encoder.refinenet{i}.out_conv', theirs + 'out_conv')
        for j in (1, 2):
            unit = f'{theirs}resConfUnit{j}.'
            if m.has(unit + 'conv1.weight'):
                for conv in ('conv1', 'conv2'):
                    m.layer(f'encoder.refinenet{i}.rcu{j}.{conv}',
                            unit + conv)
    post = 'encoder.pretrained.act_postprocess'
    for i, ours in ((3, 'ProjectReadout_0'), (4, 'ProjectReadout_1')):
        m.layer(f'encoder.{ours}.project', f'{post}{i}.0.project.0')
    for theirs, ours in ((f'{post}3.3', 'post3_conv'),
                         (f'{post}4.3', 'post4_conv1'),
                         (f'{post}4.4', 'post4_conv2')):
        m.layer(f'encoder.{ours}', theirs)


def _convert(sd: dict, n_view: int, vit_depth: int, resnet_layers
             ) -> tuple[dict[str, Tensor], list[str]]:
    m = _Mapper(sd)
    _heads(m, n_view)
    _phi(m)
    _backbone(m, resnet_layers)
    _vit(m, vit_depth)
    _dpt(m)
    return m.out, sorted(set(sd) - m.used)


def convert_reference_state_dict(sd: dict, n_view: int = 2,
                                 vit_depth: int = 12,
                                 resnet_layers=(3, 4, 9)
                                 ) -> dict[str, Tensor]:
    """The port's state dict (f32) from an upstream state dict (tensors or
    numpy arrays), for a model of ``n_view`` views: the JAX tool's mapping
    but for the head a model of that view count does not build
    (:func:`_absent_heads`; the upstream model builds both), so that the
    result loads strictly. Weight-standardized conv kernels convert as
    they are (the port standardizes them in its forward, as timm's
    StdConv2d does)."""
    return _convert(sd, n_view, vit_depth, resnet_layers)[0]


def _depths(sd: dict) -> tuple[int, tuple[int, ...]]:
    """(ViT blocks, ResNet blocks a stage) of an upstream state dict, read
    off its keys (the upstream model's: 12 and (3, 4, 9))."""
    def count(prefix):
        n = 0
        while any(k.startswith(f'{prefix}{n}.') for k in sd):
            n += 1
        return n

    stages = count(BACKBONE + 'stages.')
    return (count(ENCODER + 'blocks.'),
            tuple(count(f'{BACKBONE}stages.{s}.blocks.')
                  for s in range(stages)))


def main(argv=None) -> Path:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--torch_ckpt', required=True)
    p.add_argument('--out', required=True)
    p.add_argument('--views', type=int, default=2)
    opt = p.parse_args(argv)
    ckpt = torch.load(opt.torch_ckpt, map_location='cpu', weights_only=True)
    sd = ckpt.get('model', ckpt)
    state, unmapped = _convert(sd, opt.views, *_depths(sd))
    out = Path(opt.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({'params': state, 'step': 0}, out)
    print(f'wrote {out}: {len(state)} tensors from {len(sd)} upstream keys '
          f'({opt.views} views)', flush=True)
    print(f'{len(unmapped)} upstream keys left unmapped'
          + ''.join(f'\n  {key}' for key in unmapped), flush=True)
    return out


if __name__ == '__main__':
    main()
