"""Small convolutional down-stack encoder (``--model unet``).

Port of ``cross_attention_renderer_tpu/encoders/unet.py`` (the reference's
``UNetEncoder``, whose forward returns only the four down-path maps,
encoder.py:178-206): a 7x7 conv to 32 channels and a 2x2 max-pool, then
conv + ReLU to 64, 128, 256 and 512 channels with a 2x2 max-pool between
them, channel-last:

  encoder(rgb (N, H, W, 3)) -> (64 @ H/2, 128 @ H/4, 256 @ H/8, 512 @ H/16)

(concatenated width 960). The convolutions carry the Flax names
``down1`` .. ``down5``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from cross_attention_renderer_torch.layers import Conv

Tensor = torch.Tensor

# (channels, kernel size) of down2 .. down5
DOWN = ((64, 5), (128, 3), (256, 3), (512, 3))


def _pool(x: Tensor) -> Tensor:
    """2x2 max-pool, stride 2, no padding (``flax.linen.max_pool``), NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class UNetEncoder(nn.Module):

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.down1 = Conv(3, 32, 7, padding=3, dtype=dtype)
        d_in = 32
        for i, (ch, k) in enumerate(DOWN):
            setattr(self, f'down{i + 2}',
                    Conv(d_in, ch, k, padding=k // 2, dtype=dtype))
            d_in = ch

    def forward(self, rgb: Tensor) -> tuple[Tensor, ...]:
        x = _pool(torch.relu(self.down1(rgb)))
        outs = []
        for i in range(len(DOWN)):
            x = torch.relu(getattr(self, f'down{i + 2}')(x))
            outs.append(x)
            if i < len(DOWN) - 1:
                x = _pool(x)
        return tuple(outs)
