"""Weight bridge: Flax parameters of the JAX package -> this port's state dict.

``params_from_jax(params)`` takes the Flax parameter tree of
``cross_attention_renderer_tpu``'s ``CrossAttentionRenderer`` as nested
dicts of numpy arrays (with or without the top-level ``'params'`` key) and
returns a state dict for :class:`~cross_attention_renderer_torch.models.
renderer.CrossAttentionRenderer`. The port's modules carry the Flax module
names, so keys map one to one; only layouts change:

  Dense kernel (in, out)              -> weight (out, in)
  Conv kernel HWIO                    -> weight OIHW
  MHA query/key/value (E, heads, hd)  -> weight (heads*hd, E), bias (heads*hd,)
  MHA out (heads, hd, E)              -> weight (E, heads*hd)
  Norm scale                          -> weight
  SplitDense kernel (in, out)         -> kernel, unchanged and whole
"""

from __future__ import annotations

import numpy as np
import torch

# Renderer-level modules that are SplitDense: their kernels keep the JAX
# layout, sliced at use as the JAX package slices them.
SPLIT_DENSE = frozenset({
    'query_encode_latent', 'query_encode_latent_2', 'latent_value',
    'key_map', 'key_map_2', 'query_embed', 'query_embed_2', 'encode_latent',
    'query_repeat_embed', 'query_repeat_embed_2'})


def _flatten(tree: dict, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert(path: tuple, a: np.ndarray) -> tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == 'kernel':
        if mods[0] in SPLIT_DENSE:
            return 'kernel', a
        if a.ndim == 4:
            return 'weight', a.transpose(3, 2, 0, 1)
        if a.ndim == 3 and mods[-1] == 'out':
            return 'weight', a.reshape(-1, a.shape[-1]).T
        if a.ndim == 3:
            return 'weight', a.reshape(a.shape[0], -1).T
        return 'weight', a.T
    if leaf == 'bias':
        return 'bias', a.reshape(-1) if a.ndim == 2 else a
    if leaf == 'scale':
        return 'weight', a
    return leaf, a


def params_from_jax(params: dict) -> dict[str, torch.Tensor]:
    """State dict of the port's renderer from Flax parameters (numpy)."""
    params = params.get('params', params)
    out = {}
    for path, a in _flatten(params):
        leaf, v = _convert(path, a)
        key = '.'.join(path[:-1] + (leaf,))
        out[key] = torch.from_numpy(np.ascontiguousarray(v, np.float32))
    return out
