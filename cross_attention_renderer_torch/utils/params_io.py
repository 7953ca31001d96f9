"""Flat ``.npz`` files of the port's parameters.

The port's counterpart of ``cross_attention_renderer_tpu/utils/
params_io.py``: one copyable file where a checkpoint directory
(``train/trainer.py``) is more than a tool needs. The keys are the state
dict's ('.'-joined module paths). :func:`load_params` also reads a file
that the JAX package's ``save_params`` wrote ('/'-joined Flax paths,
Flax layouts), through :func:`~cross_attention_renderer_torch.convert.
params_from_jax`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from cross_attention_renderer_torch.convert import params_from_jax


def save_params(path: str, params) -> None:
    """Writes a model's (or a state dict's) tensors to ``path``, f32 as
    they are stored."""
    state = params.state_dict() if isinstance(params, nn.Module) else params
    np.savez_compressed(path, **{k: v.detach().cpu().numpy()
                                 for k, v in state.items()})


def load_params(path: str) -> dict[str, torch.Tensor]:
    """The state dict in ``path``, for ``model.load_state_dict``: a file of
    :func:`save_params`, or of the JAX package's ``save_params`` (converted
    with ``params_from_jax``)."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    if not any('/' in k for k in arrays):
        return {k: torch.from_numpy(v) for k, v in arrays.items()}
    tree: dict = {}
    for key, v in arrays.items():
        node = tree
        *parents, leaf = key.split('/')
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return params_from_jax(tree)
