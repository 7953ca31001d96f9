"""LPIPS (VGG) perceptual distance in PyTorch.

Port of ``cross_attention_renderer_tpu/losses/lpips.py``: the ``lpips``
package's VGG variant that the reference uses (loss_functions.py:90-92,
eval_realestate10k.py:124): the VGG16 convolution stack, its five taps
(relu1_2, relu2_2, relu3_3, relu4_3, relu5_3) unit-normalised across
channels, the learned nonnegative 1x1 heads, the spatial mean and the sum
over taps. The convolutions run in plain torch (cuDNN on the card).

The weights load from the same ``.npz`` as the JAX package's
(:func:`convert_weights` from torchvision VGG16 + lpips state dicts;
convolutions in HWIO): :func:`load_lpips` takes a path, else
``$LPIPS_WEIGHTS``, else ``losses/weights/lpips_vgg.npz``, and raises a
clear error when there is none; callers treat LPIPS as optional.

Inputs are (..., H, W, 3) images in [-1, 1] (the lpips convention).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# convolutions per VGG16 block (torchvision's 'D' configuration); the tap
# is each block's last ReLU
_VGG_BLOCKS = (2, 2, 3, 3, 3)
# the lpips package's input scaling (lpips/lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _vgg_features(weights: dict, x: Tensor) -> list[Tensor]:
    """The five tap activations (post-ReLU) of NCHW ``x``."""
    taps, idx = [], 0
    for b, n in enumerate(_VGG_BLOCKS):
        for _ in range(n):
            x = F.relu(F.conv2d(x, weights[f'conv{idx}_w'],
                                weights[f'conv{idx}_b'], padding=1))
            idx += 1
        taps.append(x)
        if b < len(_VGG_BLOCKS) - 1:
            x = F.max_pool2d(x, 2, 2)
    return taps


def _normalize_channels(x: Tensor, eps: float = 1e-10) -> Tensor:
    # eps is added to the norm, not the sum, as the lpips package's
    # normalize_tensor does (lpips/__init__.py)
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


def lpips_distance(weights: dict, img0: Tensor, img1: Tensor) -> Tensor:
    """Per-image LPIPS distance; img*: (B, H, W, 3) in [-1, 1]; weights
    as :func:`torch_weights` returns them."""
    dev, dt = img0.device, weights['conv0_w'].dtype
    shift = torch.tensor(_SHIFT, device=dev, dtype=dt).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, device=dev, dtype=dt).view(1, 3, 1, 1)
    x0 = (img0.to(dt).permute(0, 3, 1, 2) - shift) / scale
    x1 = (img1.to(dt).permute(0, 3, 1, 2) - shift) / scale
    total = 0.0
    for i, (a, b) in enumerate(zip(_vgg_features(weights, x0),
                                   _vgg_features(weights, x1))):
        d = (_normalize_channels(a) - _normalize_channels(b)) ** 2
        lin = weights[f'lin{i}_w'].view(1, -1, 1, 1)
        total = total + torch.sum(d * lin, dim=1).mean(dim=(-1, -2))
    return total


def torch_weights(raw: dict, device='cuda') -> dict:
    """The npz arrays as torch tensors on ``device``: convolutions from
    HWIO to torch's (out, in, kh, kw)."""
    out = {}
    for k, v in raw.items():
        t = torch.as_tensor(np.asarray(v, np.float32))
        if k.startswith('conv') and k.endswith('_w'):
            t = t.permute(3, 2, 0, 1)
        out[k] = t.contiguous().to(device)
    return out


def default_weights_path() -> Path:
    env = os.environ.get('LPIPS_WEIGHTS')
    if env:
        return Path(env)
    return Path(__file__).parent / 'weights' / 'lpips_vgg.npz'


def load_lpips(path: Optional[str] = None, device='cuda') -> Callable:
    """``fn(img0, img1) -> (B,)`` distances from converted weights, on
    ``device``; images (B, H, W, 3) in [-1, 1], tensors or arrays.

    ``fn`` is differentiable in both images, as the JAX ``load_lpips``'s
    is: the stage-2 loss (``losses/lf_loss.py``) trains through it. The
    VGG weights are constants (``requires_grad=False``)."""
    p = Path(path) if path else default_weights_path()
    if not p.exists():
        raise FileNotFoundError(
            f'LPIPS weights not found at {p}. Convert them with '
            'cross_attention_renderer_torch.losses.lpips.convert_weights '
            'from a torchvision VGG16 + lpips checkpoint, or set '
            '$LPIPS_WEIGHTS.')
    weights = torch_weights(dict(np.load(p)), device)

    def fn(img0, img1):
        a = torch.as_tensor(img0, dtype=torch.float32, device=device)
        b = torch.as_tensor(img1, dtype=torch.float32, device=device)
        return lpips_distance(weights, a, b)

    return fn


def convert_weights(vgg_state: dict, lpips_state: dict, out_path: str):
    """Converts torch state dicts to the npz layout (the JAX package's).

    vgg_state: torchvision ``vgg16(weights=...).features.state_dict()``;
    lpips_state: ``lpips.LPIPS(net='vgg')`` state dict (the lin layers).
    Arrays or tensors."""
    def arr(v):
        return (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))

    out = {}
    conv_ids = sorted({int(k.split('.')[0]) for k in vgg_state
                       if k.endswith('.weight')})
    for i, layer in enumerate(conv_ids):
        out[f'conv{i}_w'] = arr(vgg_state[f'{layer}.weight']).transpose(
            2, 3, 1, 0)                                 # (out,in,kh,kw) -> HWIO
        out[f'conv{i}_b'] = arr(vgg_state[f'{layer}.bias'])
    for i in range(5):
        key = f'lins.{i}.model.1.weight'
        if key not in lpips_state:
            key = f'lin{i}.model.1.weight'
        out[f'lin{i}_w'] = arr(lpips_state[key]).reshape(-1)  # (1, C, 1, 1)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_path, **out)
    return out_path
