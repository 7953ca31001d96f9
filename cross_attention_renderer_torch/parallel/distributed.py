"""Multi-process runs: joining the process group, the global mesh, each
rank's rows of the batch, and the collectives the port uses.

Port of ``cross_attention_renderer_tpu/parallel/distributed.py``. JAX runs
one process a host, each driving that host's devices; the port runs one
process (rank) a device, so the tensor-parallel and ray groups are groups
of processes, and the ranks of one tensor-parallel group load the same
rows. The rendezvous is ``torch.distributed.init_process_group`` over TCP
(the reference's NCCL rendezvous, train_realestate10k.py:71): NCCL between
cards, gloo on the CPU or wherever the caller asks for it. The torchrun
variables (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``) play the role of ``JAX_COORDINATOR_ADDRESS``.

The collectives here (``all_reduce``, ``all_gather``) are the ones gloo
runs on CUDA tensors as well as NCCL does, so two ranks can share one card
over gloo. Low-precision tensors are summed in f32.

Single-process sessions pass through every helper unchanged, so the
trainer and the CLI call them unconditionally.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from cross_attention_renderer_torch.parallel.mesh import (
    axis_size, make_mesh, mesh_device)

Tensor = torch.Tensor


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None) -> None:
    """Join the multi-process job (no-op for single-process runs).

    ``coordinator_address`` is rank 0's ``host:port``; the arguments left
    out come from the torchrun variables. Where a card is present the rank
    takes ``cuda:<local_device_ids[0]>``, else ``cuda:<LOCAL_RANK (or the
    rank) % device_count>``, as its current device. ``backend``: NCCL
    where a card is present, else gloo; ``'gloo'`` runs several ranks on
    one card (NCCL refuses that)."""
    env = os.environ
    if (coordinator_address is None and num_processes is None
            and process_id is None and 'MASTER_ADDR' not in env):
        return  # single-process session
    if coordinator_address is None and 'MASTER_ADDR' in env:
        coordinator_address = (f'{env["MASTER_ADDR"]}:'
                               f'{env.get("MASTER_PORT", "29500")}')
    if num_processes is None and 'WORLD_SIZE' in env:
        num_processes = int(env['WORLD_SIZE'])
    if process_id is None and 'RANK' in env:
        process_id = int(env['RANK'])
    if num_processes is not None and num_processes <= 1:
        return
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError(
            'a multi-process run needs the coordinator address, the '
            'number of processes and this process\'s id (arguments or '
            f'MASTER_ADDR / WORLD_SIZE / RANK); got {coordinator_address!r}'
            f', {num_processes!r}, {process_id!r}')
    if torch.cuda.is_available():
        index = (local_device_ids[0] if local_device_ids
                 else int(env.get('LOCAL_RANK', process_id))
                 % torch.cuda.device_count())
        torch.cuda.set_device(index)
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    dist.init_process_group(backend,
                            init_method=f'tcp://{coordinator_address}',
                            world_size=num_processes, rank=process_id)


def rank_device(device: str = 'cuda') -> torch.device:
    """This rank's device of kind ``device``: its current card (set by
    :func:`initialize`) for 'cuda', else the CPU."""
    if torch.device(device).type == 'cuda':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)


def make_global_mesh(data: int = 0, model: int = 1, rays: int = 1,
                     device_type: str = 'cuda'):
    """The (data, model, rays) mesh over all ranks, ``data`` outermost
    (ranks are numbered host by host, so the data axis spans hosts and a
    model or ray group holds consecutive ranks); data=0 means 'all
    remaining'. JAX asserts that a model or ray group stays inside one
    process; here every process holds one device, so those groups are
    processes by design."""
    return make_mesh(data, model, rays, device_type=device_type)


def process_batch_slice(global_batch: int, mesh=None) -> tuple[int, int]:
    """(start, size) of this rank's rows of the global batch: the rows of
    its ``data`` coordinate on ``mesh``, the same for every rank of one
    model or ray group. Without a mesh every rank is a data coordinate of
    its own. The global batch must divide evenly."""
    if mesh is not None:
        index, count = mesh.get_local_rank('data'), axis_size(mesh, 'data')
    elif dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    assert global_batch % count == 0, (
        f'global batch {global_batch} must divide by {count} data shards')
    size = global_batch // count
    return index * size, size


def global_scene(scene_local: dict, mesh) -> dict:
    """This rank's part of the global scene: its rows (``scene_local``,
    :func:`process_batch_slice`'s) on the rank's device. The port keeps no
    global array; the gradients meet in the ``data`` all-reduce."""
    from cross_attention_renderer_torch.train.trainer import to_device
    return to_device(scene_local, mesh_device(mesh))


def is_primary() -> bool:
    """True on the logging / checkpoint-writing rank (reference rank-0
    semantics, training.py:60,82,105)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def all_reduce_sum(t: Tensor, group) -> Tensor:
    """The sum of ``t`` over ``group`` (a new tensor; ``t`` itself without
    a group). bf16 and f16 are summed in f32 and rounded once."""
    if group is None:
        return t
    low = t.dtype in (torch.bfloat16, torch.float16)
    out = t.float() if low else t.clone()
    dist.all_reduce(out, group=group)
    return out.to(t.dtype) if low else out


def all_gather_cat(t: Tensor, group, dim: int) -> Tensor:
    """The ``group``'s tensors concatenated along ``dim`` in rank order
    (``t`` itself without a group)."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)
