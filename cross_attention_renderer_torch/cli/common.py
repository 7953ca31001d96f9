"""Shared CLI plumbing: one flag system for all entry points.

Port of ``cross_attention_renderer_tpu/cli/common.py``: the same flags with
the same defaults (``--dtype float32`` among them), plus ``--device``
(default ``cuda``; ``--device cpu`` runs the plain versions of the kernels
on the CPU). ``--model``, the four ablation flags and ``--views`` (any
positive count, the context frames spaced evenly as
``data/realestate.py:context_ids`` spaces them) reach the renderer as in
the JAX CLI. The fast-eval flags
(``--pruned``, ``--narrow``, ``--q8``, ``--fast``) select
``train/evaluation.py``'s fast renderers, with JAX's defaults.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from cross_attention_renderer_torch.utils.image import imageio_v2

ABLATIONS = ('no_sample', 'no_latent_concat', 'no_multiview', 'no_high_freq')


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument('--experiment_name', type=str, default='exp')
    p.add_argument('--logging_root', type=str, default='logs')
    p.add_argument('--dataset', type=str, default='realestate10k',
                   choices=['realestate10k', 'acid'])
    p.add_argument('--img_root', type=str, required=False)
    p.add_argument('--pose_root', type=str, required=False)
    p.add_argument('--checkpoint_path', type=str, default=None,
                   help="a checkpoint directory of the port's trainer "
                        "(its 'current' checkpoint is read) or one of its "
                        '.pt files')
    p.add_argument('--co3d_root', type=str, default=None,
                   help='use CO3D-v2 instead of npz scenes')
    p.add_argument('--co3d_category', type=str, default='all_nerformer')
    p.add_argument('--views', type=int, default=2)
    p.add_argument('--model', type=str, default='midas_vit',
                   choices=['midas_vit', 'resnet', 'unet'])
    # ablations (train_realestate10k.py:51-55)
    p.add_argument('--no_sample', action='store_true')
    p.add_argument('--no_latent_concat', action='store_true')
    p.add_argument('--no_multiview', action='store_true')
    p.add_argument('--no_high_freq', action='store_true')
    # tri-state: unset -> the model's default (the CUDA kernel on the card,
    # the plain version on the CPU)
    p.add_argument('--fused_attention', action='store_true', default=None,
                   help='force the fused epipolar attention kernel on')
    p.add_argument('--no_fused_attention', dest='fused_attention',
                   action='store_false',
                   help='force the plain attention path')
    # encoder size knobs (defaults = reference config; smaller for smoke runs)
    p.add_argument('--fusion_features', type=int, default=256)
    p.add_argument('--vit_width', type=int, default=768)
    p.add_argument('--vit_depth', type=int, default=12)
    p.add_argument('--vit_heads', type=int, default=12)
    p.add_argument('--resnet_layers', type=int, nargs=3, default=(3, 4, 9))
    p.add_argument('--npoints', type=int, default=0)
    p.add_argument('--dtype', type=str, default='float32',
                   choices=['float32', 'bfloat16'],
                   help='compute dtype (attention logits and softmax are '
                        'always f32); the parameters stay f32')
    p.add_argument('--device', type=str, default='cuda',
                   help="where the model runs: 'cuda' (the default) or "
                        "'cpu'")
    # fast-eval levers (eval/traj only; their images differ from the
    # reference protocol's)
    p.add_argument('--pruned', type=str, default=None, metavar='C,F',
                   help='coarse-to-fine fast-eval sampling: C coarse + F '
                        'attention-guided fine samples instead of the '
                        'uniform npoints grid')
    p.add_argument('--narrow', type=str, default=None, metavar='K1,K2,K3',
                   help='per-scene PCA narrowing of the gathered feature '
                        'pyramid to these per-level widths')
    p.add_argument('--q8', action='store_true',
                   help='int8 gather tables (per-channel scales folded '
                        'into the fuse kernel)')
    p.add_argument('--fast', action='store_true',
                   help='preset composing all three fast-eval levers at '
                        'their documented defaults: --pruned 8,16 '
                        '--narrow 128,128,64 --q8; explicit flags override '
                        'their part of the preset')
    return p


def parse_pruned(opt):
    """'C,F' -> (int, int) or None (shared by eval / render_traj)."""
    if not getattr(opt, 'pruned', None):
        return None
    c, f = (int(x) for x in opt.pruned.split(','))
    return (c, f)


def fast_eval_kwargs(opt) -> dict:
    """--pruned/--narrow/--q8/--fast -> make_image_renderer kwargs."""
    narrow = (tuple(int(x) for x in opt.narrow.split(','))
              if getattr(opt, 'narrow', None) else None)
    pruned = parse_pruned(opt)
    q8 = bool(getattr(opt, 'q8', False))
    if getattr(opt, 'fast', False):
        pruned = pruned or (8, 16)
        narrow = narrow or (128, 128, 64)
        q8 = True
    return dict(pruned=pruned, narrow=narrow, q8=q8)


class FrameWriter:
    """mp4 writer with a PNG-sequence fallback (no ffmpeg in some envs)."""

    def __init__(self, out_path: str, fps: int = 10):
        imageio = imageio_v2('writing a video')
        self._imageio = imageio
        self.frames_dir = None
        self.writer = None
        self.count = 0
        try:
            self.writer = imageio.get_writer(out_path, fps=fps)
            self.path = out_path
        except Exception:
            from pathlib import Path
            self.frames_dir = Path(str(out_path) + '.frames')
            self.frames_dir.mkdir(parents=True, exist_ok=True)
            self.path = str(self.frames_dir)
            print(f'no mp4 backend (ffmpeg missing); writing PNG frames '
                  f'to {self.frames_dir}', flush=True)

    def append(self, frame):
        if self.writer is not None:
            self.writer.append_data(frame)
        else:
            self._imageio.imwrite(
                self.frames_dir / f'{self.count:04d}.png', frame)
        self.count += 1

    def close(self):
        if self.writer is not None:
            self.writer.close()


def build_model(opt):
    """The renderer the flags describe, on ``opt.device``, its parameters
    drawn from seed 0 (JAX cli/common.py:130-142). Raises ValueError for
    ``--views`` below 1."""
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    return CrossAttentionRenderer(
        dtype=getattr(torch, opt.dtype), n_view=opt.views, model=opt.model,
        **{a: bool(getattr(opt, a)) for a in ABLATIONS},
        npoints=opt.npoints, fused_attention=opt.fused_attention,
        fusion_features=opt.fusion_features, vit_width=opt.vit_width,
        vit_depth=opt.vit_depth, vit_heads=opt.vit_heads,
        resnet_layers=tuple(opt.resnet_layers), device=opt.device)


def restore_params(state, checkpoint_path: str) -> None:
    """Loads the parameters of a checkpoint of the port's trainer into
    ``state``'s model: ``checkpoint_path`` is a checkpoint directory (its
    ``current`` checkpoint, as the JAX CLI reads) or a ``.pt`` file of
    one."""
    from pathlib import Path

    from cross_attention_renderer_torch.train.trainer import (
        restore_checkpoint)
    path = Path(checkpoint_path)
    if path.suffix == '.pt':
        restore_checkpoint(path.parent, state, path.stem)
    else:
        restore_checkpoint(path, state)


def scene_batch(item: dict, device) -> dict:
    """A dataset item (nested dict of arrays) as a batch of one: torch
    tensors with a leading axis of 1, on ``device``. Non-numeric metadata
    (CO3D's 'sequence') is dropped."""
    from cross_attention_renderer_torch.data.realestate import collate
    from cross_attention_renderer_torch.train.trainer import to_device
    item = dict(item)
    item.pop('sequence', None)
    return to_device(collate([item]), device)


def to_uint8(img01) -> np.ndarray:
    """An image in [0, 1] (tensor or array) as uint8 pixels."""
    if isinstance(img01, torch.Tensor):
        img01 = img01.detach().float().cpu().numpy()
    return (np.clip(img01, 0, 1) * 255).astype(np.uint8)
