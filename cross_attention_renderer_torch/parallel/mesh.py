"""The (data, model, rays) mesh over ranks and the tensor-parallel rules.

Port of ``cross_attention_renderer_tpu/parallel/mesh.py``. JAX runs one
process a host and builds its mesh over devices; the port runs one process
(rank) a device, so its mesh is built over ranks: the JAX device at mesh
coordinate (d, m, r) is the rank at that coordinate, and a tensor-parallel
group is several processes.

  * axis ``data``  — data parallelism: each data coordinate trains on its
    rows of the global batch; gradients are averaged over the axis.
  * axis ``model`` — tensor parallelism (Megatron): a column-parallel layer
    holds a slice of the output features, the row-parallel layer after it
    the matching slice of the input features, and one all-reduce over the
    axis closes the pair (``layers.py``).
  * axis ``rays``  — ray-sharded rendering: each coordinate renders its
    slice of the query rays, gathered at the end
    (``train/evaluation.py:make_sharded_renderer``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` once the process
has joined a process group (:func:`~cross_attention_renderer_torch.
parallel.distributed.initialize`); without one the process is the 1x1x1
:class:`LocalMesh`, whose collectives are all skipped.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import torch
import torch.distributed as dist

AXES = ('data', 'model', 'rays')


class LocalMesh:
    """The 1x1x1 mesh of a process that has joined no process group: the
    part of ``DeviceMesh``'s interface the port reads, with no group on
    any axis."""

    mesh_dim_names = AXES
    shape = (1, 1, 1)

    def __init__(self, device_type: str = 'cuda'):
        self.device_type = device_type

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0

    def __repr__(self) -> str:
        return f'LocalMesh({self.device_type!r}, data=1, model=1, rays=1)'


def make_mesh(data: int = 0, model: int = 1, rays: int = 1,
              devices: Optional[Sequence[int]] = None,
              device_type: str = 'cuda'):
    """Build a (data, model, rays) mesh over ``devices`` (the world's
    ranks by default), ``data`` outermost; data=0 means 'all remaining'.
    ``device_type`` is where the ranks' tensors live ('cuda' or 'cpu').
    Every rank of the mesh calls it. Without a process group: the 1x1x1
    :class:`LocalMesh`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(devices) if devices is not None else list(range(world))
    n = len(devices)
    if data == 0:
        assert n % (model * rays) == 0, (n, model, rays)
        data = n // (model * rays)
    assert data * model * rays == n, (data, model, rays, n)
    if not dist.is_initialized():
        return LocalMesh(device_type)
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.tensor(devices, dtype=torch.int64).reshape(data, model,
                                                             rays)
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def mesh_device(mesh) -> torch.device:
    """The device of this rank's tensors: the current card, or the CPU."""
    if mesh.device_type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(mesh.device_type)


# --- parameter partitioning (tensor parallelism) --------------------------

# The JAX package's Megatron rules (mesh.py:50-76) in the port's parameter
# names and layouts: a Dense weight is (out, in) and a Conv weight (out, in,
# kh, kw), so a column-parallel layer shards dim 0 and a row-parallel one
# dim 1; a SplitDense kernel keeps Flax's (in, out), so there it is the
# other way round. The ViT's query / key / value weights are (heads * hd,
# width) with whole heads in contiguous rows, so a slice of dim 0 holds
# whole heads when ``model`` divides the head count. A spec is a tuple
# with one entry a dimension, 'model' on the sharded one (JAX's
# PartitionSpec); () is replicated.
_TP_RULES: tuple[tuple[str, tuple], ...] = (
    (r'vit\.block\d+\.attn\.(query|key|value)\.weight', ('model', None)),
    (r'vit\.block\d+\.attn\.(query|key|value)\.bias', ('model',)),
    (r'vit\.block\d+\.attn\.out\.weight', (None, 'model')),
    (r'vit\.block\d+\.mlp_fc1\.weight', ('model', None)),
    (r'vit\.block\d+\.mlp_fc1\.bias', ('model',)),
    (r'vit\.block\d+\.mlp_fc2\.weight', (None, 'model')),
    # DPT fusion RCUs: conv1 column-parallel (output channels), conv2
    # row-parallel (input channels); the residual add after conv2's
    # all-reduce stays replicated.
    (r'refinenet\d+\.rcu\d+\.conv1\.weight', ('model', None, None, None)),
    (r'refinenet\d+\.rcu\d+\.conv1\.bias', ('model',)),
    (r'refinenet\d+\.rcu\d+\.conv2\.weight', (None, 'model', None, None)),
    # The exchange's and the keys' projections, around each relu.
    (r'query_encode_latent\.kernel', (None, 'model')),
    (r'query_encode_latent\.bias', ('model',)),
    (r'query_encode_latent_2\.kernel', ('model', None)),
    (r'key_map\.kernel', (None, 'model')),
    (r'key_map\.bias', ('model',)),
    (r'key_map_2\.kernel', ('model', None)),
    # The light-field decoder's residual blocks.
    (r'phi\.block\d+\.fc_0\.weight', ('model', None)),
    (r'phi\.block\d+\.fc_0\.bias', ('model',)),
    (r'phi\.block\d+\.fc_1\.weight', (None, 'model')),
)


def param_spec(name: str, value) -> tuple:
    """The spec of parameter ``name`` (a state-dict key) of shape
    ``value.shape``: the first rule whose pattern the name matches and
    whose length is the parameter's rank, else () (replicated)."""
    for pattern, spec in _TP_RULES:
        if re.search(pattern, name) and len(spec) == len(value.shape):
            return spec
    return ()


def sharded_dim(spec: tuple) -> Optional[int]:
    """The dimension a spec shards over 'model', or None."""
    return spec.index('model') if 'model' in spec else None


def param_shardings(module: torch.nn.Module) -> dict[str, tuple]:
    """{name: spec} for every parameter of ``module``."""
    return {name: param_spec(name, p)
            for name, p in module.named_parameters()}


def shard_tensor(full: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's slice of ``full`` under ``spec`` (a copy; ``full``
    itself where the spec is replicated). Raises where ``model`` does not
    divide the sharded dimension."""
    dim = sharded_dim(spec)
    if dim is None:
        return full
    m = axis_size(mesh, 'model')
    if full.shape[dim] % m:
        raise ValueError(f'dimension {dim} of a {tuple(full.shape)} '
                         f'parameter does not divide by model={m}')
    size = full.shape[dim] // m
    return full.narrow(dim, mesh.get_local_rank('model') * size,
                       size).contiguous()


def scene_shardings(scene, mesh, batch_axis: str = 'data'):
    """The spec of every scene tensor: its leading (batch) dimension over
    ``batch_axis`` where the axis divides it, else replicated."""
    if isinstance(scene, dict):
        return {k: scene_shardings(v, mesh, batch_axis)
                for k, v in scene.items()}
    spec = [None] * scene.ndim
    if scene.ndim >= 1 and scene.shape[0] % axis_size(mesh,
                                                      batch_axis) == 0:
        spec[0] = batch_axis
    return tuple(spec)


def replicated(tree):
    """The replicated spec, (), for every leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: replicated(v) for k, v in tree.items()}
    return ()
