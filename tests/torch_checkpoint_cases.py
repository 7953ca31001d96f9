"""An upstream-layout checkpoint made from a seed, for the tests of the
port's converter (tests/test_torch_convert_checkpoint.py) and for
``chip_smoke.py``'s converter phase: the inverse of
``cross_attention_renderer_torch/tools/convert_checkpoint.py``'s mapping,
written from the upstream module names (yilundu/cross_attention_renderer,
timm's ViT-hybrid, MiDaS's DPT scratch). Imports neither JAX nor the JAX
package."""

import re

import numpy as np

ENC = 'encoder.pretrained.model.'
BB = ENC + 'patch_embed.backbone.'
# the port's name pieces -> the upstream ones, in order (the inverse of the
# mapping, written from the upstream module names)
RENAMES = (
    ('encoder.backbone.stem_conv.', BB + 'stem.conv.'),
    ('encoder.backbone.stem_norm.GroupNorm_0.', BB + 'stem.norm.'),
    ('encoder.vit.patch_proj.', ENC + 'patch_embed.proj.'),
    ('encoder.vit.', ENC),
    ('encoder.layer', 'encoder.scratch.layer'),
    ('encoder.refinenet', 'encoder.scratch.refinenet'),
    ('encoder.ProjectReadout_0.project.',
     'encoder.pretrained.act_postprocess3.0.project.0.'),
    ('encoder.ProjectReadout_1.project.',
     'encoder.pretrained.act_postprocess4.0.project.0.'),
    ('encoder.post3_conv.', 'encoder.pretrained.act_postprocess3.3.'),
    ('encoder.post4_conv1.', 'encoder.pretrained.act_postprocess4.3.'),
    ('encoder.post4_conv2.', 'encoder.pretrained.act_postprocess4.4.'),
)
PATTERNS = (  # (regular expression on the port's key, replacement)
    (r'^encoder\.backbone\.stage(\d+)_block(\d+)\.',
     BB + r'stages.\1.blocks.\2.'),
    (r'(norm\d|downsample_norm)\.GroupNorm_0\.', r'\1.'),
    (r'downsample_(conv|norm)\.', r'downsample.\1.'),
    (r'block(\d+)\.mlp_fc(\d)\.', r'blocks.\1.mlp.fc\2.'),
    (r'block(\d+)\.attn\.out\.', r'blocks.\1.attn.proj.'),
    (r'block(\d+)\.norm(\d)\.', r'blocks.\1.norm\2.'),
    (r'\.rcu(\d)\.', r'.resConfUnit\1.'),
    (r'phi\.lin_z(\d+)\.', r'phi.lin_z.\1.'),
    (r'phi\.block(\d+)\.', r'phi.blocks.\1.'),
)


def _upstream_key(key: str) -> str:
    for ours, theirs in RENAMES:
        if key.startswith(ours):
            key = theirs + key[len(ours):]
            break
    for pattern, repl in PATTERNS:
        key = re.sub(pattern, repl, key)
    return key


def upstream_state_dict(port_shapes: dict, seed: int) -> dict:
    """An upstream-layout state dict (numpy f32) holding what the port's
    model of these state-dict shapes holds, drawn from ``seed``: SplitDense
    kernels as 1x1 convs (Conv1d for encode_latent), the ViT's query, key
    and value as one fused qkv, the patch projection as a 1x1 conv."""
    rng = np.random.default_rng(seed)
    out, qkv = {}, {}
    for key, shape in port_shapes.items():
        value = (0.05 * rng.standard_normal(shape)).astype(np.float32)
        name, leaf = key.rsplit('.', 1)
        if leaf == 'kernel':                     # SplitDense (in, out)
            tail = (1,) if name == 'encode_latent' else (1, 1)
            out[f'{name}.weight'] = np.ascontiguousarray(
                value.T).reshape(value.shape[1], value.shape[0], *tail)
        elif '.attn.' in key and key.split('.')[-2] in ('query', 'key',
                                                         'value'):
            qkv[key] = value
        elif key.startswith('encoder.vit.patch_proj.weight'):
            out[_upstream_key(key)] = value.reshape(*value.shape, 1, 1)
        else:
            out[_upstream_key(key)] = value
    blocks = sorted({k.split('.attn.')[0] for k in qkv})
    for block in blocks:
        up = _upstream_key(block + '.attn.out.weight').replace(
            'attn.proj.weight', 'attn.qkv.')
        for leaf in ('weight', 'bias'):
            out[up + leaf] = np.concatenate(
                [qkv[f'{block}.attn.{n}.{leaf}']
                 for n in ('query', 'key', 'value')])
    return out
