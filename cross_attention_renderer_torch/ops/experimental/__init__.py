"""Opt-in ops, where the JAX package keeps their counterparts:
``banded_gather`` (kernel K8). The JAX package's ``fused_mlp2`` (K9) is
re-exported from ``ops/fused_mlp.py``, where the port keeps it."""

from cross_attention_renderer_torch.ops.experimental.banded_gather import (
    grid_sample_banded,
)
from cross_attention_renderer_torch.ops.fused_mlp import fused_mlp2

__all__ = ['grid_sample_banded', 'fused_mlp2']
