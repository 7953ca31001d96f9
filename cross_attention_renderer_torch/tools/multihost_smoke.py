"""One rank of an N-process train run: two data- and tensor-parallel steps.

  python -m cross_attention_renderer_torch.tools.multihost_smoke \\
      <rank> <world> <port> [--data D] [--model M] [--backend gloo|nccl] \\
      [--device cuda|cpu] [--weights state.pt]

Port of the JAX repository's ``tools/multihost_smoke.py``: start it once
for every rank 0..world-1 (rank 0 listens on ``localhost:<port>``). The
ranks form one (data, model) mesh (``--model`` 2 by default, ``--data`` 0:
all remaining ranks), every rank builds the same TINY model from seed 0
(or loads ``--weights``, a state dict of the whole model), keeps its data
coordinate's rows of the same global batch of 8 synthetic scenes
(``parallel.process_batch_slice``) and its slices of the parameters
(``train.shard_state``), and takes two steps at lr 1e-3. It prints
``MHOK <loss0> <loss1> <checksum>``, the checksum being the sum of squares
of the replicated ``phi.lin_out`` weight: every rank prints the same line,
equal to one process's step on the global batch.

``--device cpu`` runs the ranks on the CPU over gloo; on the card each
rank takes ``cuda:<rank modulo the card count>`` over NCCL, or over gloo
with ``--backend gloo`` (several ranks on one card).
"""

from __future__ import annotations

import argparse

import torch

TINY = dict(fusion_features=32, vit_width=64, vit_depth=2, vit_heads=2,
            resnet_layers=(1, 1, 1))
GLOBAL_BATCH = 8
LR = 1e-3


def take_rows(tree, start: int, size: int):
    """Rows [start, start + size) of every tensor of a nested scene."""
    if isinstance(tree, dict):
        return {k: take_rows(v, start, size) for k, v in tree.items()}
    return tree[start:start + size]


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('rank', type=int)
    p.add_argument('world', type=int)
    p.add_argument('port', type=int)
    p.add_argument('--data', type=int, default=0)
    p.add_argument('--model', type=int, default=2)
    p.add_argument('--backend', default=None, choices=['gloo', 'nccl'])
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    p.add_argument('--weights', default=None,
                   help="the whole model's state dict (torch.save); "
                        'default: the seed-0 parameters')
    return p


def main(argv=None) -> dict:
    """Runs the two steps and prints the MHOK line; returns the losses, the
    gradient norms, the checksum, the state and the mesh. The process group stays up for the
    caller (``torch.distributed.destroy_process_group`` ends it)."""
    opt = parser().parse_args(argv)
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from cross_attention_renderer_torch.parallel.distributed import (
        initialize, make_global_mesh, process_batch_slice, rank_device)
    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step, shard_state)

    backend = opt.backend or ('gloo' if opt.device == 'cpu' else None)
    initialize(f'localhost:{opt.port}', opt.world, opt.rank,
               backend=backend)
    device = rank_device(opt.device)
    mesh = make_global_mesh(data=opt.data, model=opt.model,
                            device_type=device.type)

    model = CrossAttentionRenderer(n_view=2, npoints=8, device=device, **TINY)
    if opt.weights:
        model.load_state_dict(torch.load(opt.weights, map_location=device,
                                         weights_only=True))
    cfg = TrainConfig(lr=LR)
    start, size = process_batch_slice(GLOBAL_BATCH, mesh)
    scenes = [take_rows(make_scene(s, batch=GLOBAL_BATCH, n_view=2, H=64,
                                   W=64, n_rays=16, device='cpu'),
                        start, size) for s in (0, 1)]
    state = shard_state(create_train_state(model, cfg), mesh)
    step = make_train_step(model, cfg, mesh)
    state, m0 = step(state, scenes[0])
    state, m1 = step(state, scenes[1])

    # phi.lin_out is replicated under the TP rules: whole on every rank
    checksum = float((model.phi.lin_out.weight.detach().float() ** 2).sum())
    losses = (float(m0['total_loss']), float(m1['total_loss']))
    print(f'MHOK {losses[0]:.8f} {losses[1]:.8f} {checksum:.8f}',
          flush=True)
    return {'losses': losses, 'checksum': checksum, 'state': state,
            'mesh': mesh, 'grad_norms': (float(m0['grad_norm']),
                                         float(m1['grad_norm']))}


if __name__ == '__main__':
    import torch.distributed as dist
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
