"""Fully-connected ResNet light-field decoder (``phi``).

Port of ``cross_attention_renderer_tpu/models/resnet_fc.py``: the latent is
injected additively before every residual block (``x = x + lin_z[i](z)``),
each block's second layer starts at zero, kaiming fan-in init elsewhere.
Input layout ``zx = [z | x]``.
"""

from __future__ import annotations

import torch
from torch import nn

from cross_attention_renderer_torch.layers import Dense

Tensor = torch.Tensor


class ResnetBlockFC(nn.Module):
    """x + fc_1(relu(fc_0(relu(x)))); fc_1 starts at zero."""

    def __init__(self, size_in: int, size_h: int, size_out: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc_0 = Dense(size_in, size_h, init='kaiming', dtype=dtype)
        self.fc_1 = Dense(size_h, size_out, init='zeros', dtype=dtype)
        if size_in != size_out:
            self.shortcut = Dense(size_in, size_out, use_bias=False,
                                  init='kaiming', dtype=dtype)
        self.size_out = size_out

    def forward(self, x: Tensor) -> Tensor:
        dx = self.fc_1(torch.relu(self.fc_0(torch.relu(x))))
        if x.shape[-1] != self.size_out:
            x = self.shortcut(x)
        return x + dx


class ResnetFC(nn.Module):
    """rgb = lin_out(relu(blocks(lin_in(x)))) with z added before every
    block; instantiated by the renderer as ResnetFC(d_in=V*9,
    d_latent=V*latent, d_out=3, n_blocks=3, d_hidden=128)."""

    def __init__(self, d_in: int, d_latent: int, d_out: int = 3,
                 n_blocks: int = 3, d_hidden: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_latent, self.n_blocks = d_latent, n_blocks
        self.lin_in = Dense(d_in, d_hidden, init='kaiming', dtype=dtype)
        for i in range(n_blocks):
            setattr(self, f'lin_z{i}',
                    Dense(d_latent, d_hidden, init='kaiming', dtype=dtype))
            setattr(self, f'block{i}',
                    ResnetBlockFC(d_hidden, d_hidden, d_hidden, dtype))
        self.lin_out = Dense(d_hidden, d_out, init='kaiming', dtype=dtype)

    def forward(self, zx: Tensor) -> Tensor:
        z, x = zx[..., :self.d_latent], zx[..., self.d_latent:]
        x = self.lin_in(x)
        for i in range(self.n_blocks):
            tz = getattr(self, f'lin_z{i}')(z)
            x = getattr(self, f'block{i}')(x + tz)
        return self.lin_out(torch.relu(x))
