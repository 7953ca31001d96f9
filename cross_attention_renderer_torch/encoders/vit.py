"""Multi-view ViT-B/16 trunk with joint cross-view attention.

Port of ``cross_attention_renderer_tpu/encoders/vit.py``: per-view tokens
(a 1x1 projection of the R50 stage-2 features plus a cls token), the 14x14
position embedding resized bilinearly (align_corners=False) to the runtime
grid, a pose embedding ``Dense(16 -> width)`` of the flattened relative
cam2world added to every token, and all views concatenated into one
(B, V*(1+N), width) sequence that every block attends over jointly. The
two tap activations are returned. Attention is plain matmul + softmax, as
the JAX package leaves it to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from cross_attention_renderer_torch.layers import Dense, LayerNorm
from cross_attention_renderer_torch.utils.image import resize_bilinear

Tensor = torch.Tensor


class MultiHeadAttention(nn.Module):
    """``flax.linen.MultiHeadDotProductAttention`` (self-attention form):
    q/k/v projections, logits scaled by 1/sqrt(head_dim), softmax over the
    keys, output projection."""

    def __init__(self, width: int, heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.query = Dense(width, width, dtype=dtype)
        self.key = Dense(width, width, dtype=dtype)
        self.value = Dense(width, width, dtype=dtype)
        self.out = Dense(width, width, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        B, L, E = x.shape
        hd = E // self.heads

        # The projections' widths, not E, give the head count: under tensor
        # parallelism (``layers.py``) this rank holds a slice of whole heads
        # of q, k and v, and ``out`` the matching slice of its input.
        def split(t):
            return t.reshape(B, L, -1, hd).transpose(1, 2)

        q = split(self.query(x)) / torch.tensor(math.sqrt(hd), dtype=self.dtype)
        k, v = split(self.key(x)), split(self.value(x))
        w = torch.softmax(q @ k.transpose(-1, -2), dim=-1)
        o = (w @ v).transpose(1, 2).reshape(B, L, -1)
        return self.out(o)


class TransformerBlock(nn.Module):
    """Pre-LN ViT block: LN -> MHA -> residual, LN -> MLP(exact GELU) ->
    residual."""

    def __init__(self, width: int = 768, heads: int = 12,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(width, 1e-6, dtype)
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.norm2 = LayerNorm(width, 1e-6, dtype)
        self.mlp_fc1 = Dense(width, int(width * mlp_ratio), dtype=dtype)
        self.mlp_fc2 = Dense(int(width * mlp_ratio), width, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        x = x + self.attn(self.norm1(x))
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + h


class MultiViewViT(nn.Module):
    """Joint-attention ViT over V views of tokenized R50 features.

    Input: (B, V, Hg, Wg, C_in) grids and (B, V, 16) flattened relative
    poses. Output: the two tap activations, each (B*V, 1 + Hg*Wg, width),
    cls token first, view-major. With ``remat`` each block is recomputed
    in the backward pass instead of keeping its activations (JAX
    ``nn.remat``, vit.py:111-113)."""

    def __init__(self, d_in: int, width: int = 768, depth: int = 12,
                 heads: int = 12, taps: tuple[int, int] = (8, 11),
                 pretrain_grid: int = 14, dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        self.width, self.depth, self.taps = width, depth, taps
        self.remat = remat
        self.pretrain_grid, self.dtype = pretrain_grid, dtype
        self.patch_proj = Dense(d_in, width, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, width))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pretrain_grid ** 2, width))
        self.pose_embed = Dense(16, width, dtype=dtype)
        for i in range(depth):
            setattr(self, f'block{i}',
                    TransformerBlock(width, heads, dtype=dtype))

    def reset_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            self.cls_token.zero_()
            self.pos_embed.normal_(0.0, 0.02, generator=g)

    def forward(self, grids: Tensor, rel_pose16: Tensor
                ) -> tuple[Tensor, Tensor]:
        B, V, Hg, Wg, _ = grids.shape
        x = self.patch_proj(grids).reshape(B * V, Hg * Wg, self.width)
        cls = self.cls_token.to(x.dtype).expand(B * V, 1, self.width)
        x = torch.cat([cls, x], dim=1)

        n = self.pretrain_grid
        pos_cls, pos_grid = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        pos_grid = resize_bilinear(pos_grid.reshape(1, n, n, self.width),
                                   (Hg, Wg), align_corners=False)
        pos = torch.cat([pos_cls, pos_grid.reshape(1, Hg * Wg, self.width)],
                        dim=1).to(x.dtype)
        pose = self.pose_embed(rel_pose16).reshape(B * V, 1, self.width)
        x = x + pos + pose

        tokens = x.shape[1]
        x = x.reshape(B, V * tokens, self.width)
        taps = {}
        for i in range(self.depth):
            block = getattr(self, f'block{i}')
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
            if i in self.taps:
                taps[i] = x.reshape(B * V, tokens, self.width)
        return taps[self.taps[0]], taps[self.taps[1]]
