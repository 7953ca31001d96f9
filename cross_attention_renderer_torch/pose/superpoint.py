"""SuperPoint keypoint detector and descriptor in PyTorch.

Port of ``cross_attention_renderer_tpu/pose/superpoint.py``: the same fixed
top-K over the NMS'd score map with a validity mask (below-threshold and
border slots are masked, not dropped), on the upstream MagicLeap network
(``conv1a`` ... ``convDb``, NCHW), whose state dict loads into
:class:`SuperPoint` as it is.

Weights: :func:`init_params` draws the JAX package's numpy dict (HWIO
kernels), :meth:`SuperPoint.from_params` carries such a dict (or an npz that
:func:`convert_weights` wrote) into the module, and :func:`convert_weights`
maps an upstream state dict onto that npz layout, as the JAX function does.

Precision: the network runs in full f32 on the card. The package turns
TF32 off for cuDNN and cuBLAS on import, and the pose nets keep that: the
top-K over a score map whose values differ in the fifth digit (random
weights put every softmax near 1/65) would pick other keypoints under
TF32's 10-bit mantissa, and the matches would follow.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

_CHANNELS = (64, 64, 128, 128)
_DETECTOR_CH = 256
_DESC_DIM = 256
_CONV_NAMES = tuple(f'conv{i + 1}{ab}' for i in range(4) for ab in 'ab') + (
    'convPa', 'convPb', 'convDa', 'convDb')


def init_params(rng: np.random.Generator | int = 0) -> dict:
    """Random parameters in the JAX package's layout (HWIO), drawn as its
    ``init_params`` draws them."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    p = {}

    def conv(name, cin, cout, k):
        p[f'{name}_w'] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(
            np.float32)
        p[f'{name}_b'] = np.zeros(cout, np.float32)

    cin = 1
    for i, c in enumerate(_CHANNELS):
        conv(f'conv{i + 1}a', cin, c, 3)
        conv(f'conv{i + 1}b', c, c, 3)
        cin = c
    conv('convPa', cin, _DETECTOR_CH, 3)
    conv('convPb', _DETECTOR_CH, 65, 1)
    conv('convDa', cin, _DETECTOR_CH, 3)
    conv('convDb', _DETECTOR_CH, _DESC_DIM, 1)
    return p


def convert_weights(torch_state: dict) -> dict:
    """Upstream state dict (OIHW) -> the npz layout (HWIO) of
    :func:`init_params`."""
    out = {}
    for k, v in torch_state.items():
        name = k.split('.')[0]
        v = np.asarray(v.detach().cpu() if isinstance(v, Tensor) else v)
        if k.endswith('weight'):
            out[f'{name}_w'] = v.transpose(2, 3, 1, 0)
        else:
            out[f'{name}_b'] = v
    return out


def simple_nms(scores: Tensor, radius: int) -> Tensor:
    """Iterated max-pool NMS on (B, H, W) scores. ``max_pool2d`` pads with
    -inf, as JAX's ``reduce_window`` does, so padding never wins a max."""
    k = 2 * radius + 1

    def maxpool(x):
        return F.max_pool2d(x[:, None], k, stride=1, padding=radius)[:, 0]

    zeros = torch.zeros_like(scores)
    max_mask = scores == maxpool(scores)
    for _ in range(2):
        supp = maxpool(max_mask.to(scores.dtype)) > 0
        supp_scores = torch.where(supp, zeros, scores)
        new_max = supp_scores == maxpool(supp_scores)
        max_mask = max_mask | (new_max & ~supp)
    return torch.where(max_mask, scores, zeros)


def top_k(flat: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """The ``k`` largest of each row of ``flat`` and their indices, ties to
    the lower index (``lax.top_k``'s order; ``torch.topk`` leaves it
    open)."""
    values, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def sample_descriptors(kpts_xy: Tensor, desc_map: Tensor, s: int = 8
                       ) -> Tensor:
    """Bilinear descriptor sampling at keypoints, align_corners=True,
    corners clipped to the map. desc_map (B, h, w, C); kpts (B, K, 2) in
    pixels. Returns unit-norm (B, K, C)."""
    B, h, w, C = desc_map.shape
    k = kpts_xy - s / 2 + 0.5
    k = k / torch.tensor([w * s - s / 2 - 0.5, h * s - s / 2 - 0.5],
                         dtype=desc_map.dtype, device=desc_map.device)
    x = k[..., 0] * (w - 1)
    y = k[..., 1] * (h - 1)
    x0 = torch.clamp(torch.floor(x), 0, w - 1)
    y0 = torch.clamp(torch.floor(y), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    flat_map = desc_map.reshape(B, h * w, C)

    def gather(ix, iy):
        flat = (iy * w + ix).long()
        return torch.gather(flat_map, 1, flat[..., None].expand(-1, -1, C))

    v = (gather(x0, y0) * (1 - wx) * (1 - wy)
         + gather(x1, y0) * wx * (1 - wy)
         + gather(x0, y1) * (1 - wx) * wy
         + gather(x1, y1) * wx * wy)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


class SuperPoint(nn.Module):
    """The upstream network; :meth:`forward` returns JAX's fixed-K dict."""

    def __init__(self, device='cuda'):
        super().__init__()
        cin = 1
        for i, c in enumerate(_CHANNELS):
            setattr(self, f'conv{i + 1}a', nn.Conv2d(cin, c, 3, padding=1))
            setattr(self, f'conv{i + 1}b', nn.Conv2d(c, c, 3, padding=1))
            cin = c
        self.convPa = nn.Conv2d(cin, _DETECTOR_CH, 3, padding=1)
        self.convPb = nn.Conv2d(_DETECTOR_CH, 65, 1)
        self.convDa = nn.Conv2d(cin, _DETECTOR_CH, 3, padding=1)
        self.convDb = nn.Conv2d(_DETECTOR_CH, _DESC_DIM, 1)
        self.to(device)

    @classmethod
    def from_params(cls, params: dict, device='cuda') -> 'SuperPoint':
        """The module holding a JAX-layout dict's weights (HWIO -> OIHW)."""
        model = cls(device='cpu')
        state = {}
        for name in _CONV_NAMES:
            state[f'{name}.weight'] = torch.from_numpy(np.ascontiguousarray(
                np.asarray(params[f'{name}_w'], np.float32).transpose(
                    3, 2, 0, 1)))
            state[f'{name}.bias'] = torch.from_numpy(
                np.asarray(params[f'{name}_b'], np.float32))
        model.load_state_dict(state, strict=True)
        return model.to(device).eval()

    @torch.inference_mode()
    def dense(self, image: Tensor, nms_radius: int = 4) -> tuple:
        """image (B, 1, H, W) grayscale in [0, 1] -> (the keypoint score
        map after NMS (B, H, W), the unit-norm descriptor map (B, 256, H/8,
        W/8))."""
        x = image
        for i in range(4):
            x = F.relu(getattr(self, f'conv{i + 1}a')(x))
            x = F.relu(getattr(self, f'conv{i + 1}b')(x))
            if i < 3:
                x = F.max_pool2d(x, 2, 2)

        logits = self.convPb(F.relu(self.convPa(x)))     # (B, 65, h, w)
        scores = torch.softmax(logits, dim=1)[:, :-1]
        # depth-to-space 8x: channel 8a + b goes to row offset a, column
        # offset b, JAX's (h, 8, w, 8) order
        scores = F.pixel_shuffle(scores, 8)[:, 0]
        dmap = self.convDb(F.relu(self.convDa(x)))
        dmap = dmap / torch.clamp(torch.linalg.norm(dmap, dim=1,
                                                    keepdim=True), min=1e-12)
        return simple_nms(scores, nms_radius), dmap

    @torch.inference_mode()
    def forward(self, image: Tensor, max_keypoints: int = 1024,
                nms_radius: int = 4, keypoint_threshold: float = 0.005,
                border: int = 4) -> dict:
        """image (B, 1, H, W) grayscale in [0, 1]. Returns keypoints (B, K,
        2) xy pixels, scores (B, K), valid (B, K) bool and descriptors (B,
        K, 256); K = max_keypoints, invalid slots masked."""
        scores, dmap = self.dense(image, nms_radius)
        B, H, W = scores.shape
        ys = torch.arange(H, device=image.device)[:, None]
        xs = torch.arange(W, device=image.device)[None, :]
        in_border = ((ys >= border) & (ys < H - border)
                     & (xs >= border) & (xs < W - border))
        masked = torch.where(in_border[None], scores,
                             torch.zeros((), device=image.device))
        top_scores, top_idx = top_k(masked.reshape(B, H * W), max_keypoints)
        keypoints = torch.stack([(top_idx % W).float(),
                                 (top_idx // W).float()], dim=-1)
        descriptors = sample_descriptors(keypoints, dmap.permute(0, 2, 3, 1))
        return {'keypoints': keypoints, 'scores': top_scores,
                'valid': top_scores > keypoint_threshold,
                'descriptors': descriptors}
