"""One rank of the multi-process cases of tests/test_torch_parallel.py.

  python tests/torch_parallel_cases.py <case> <rank> <world> <port> <dir>

Every rank runs on the CPU over gloo, in one intra-op thread, and prints
one line a result (a keyword, then JSON or numbers) for the test to read.
``<dir>`` holds the whole model's weights (``weights.pt``, a state dict)
and the corpus, and receives what the ranks write.

* ``train`` (world 4, DP 2 x TP 2): ``tools/multihost_smoke.py``'s two
  steps on those weights (its MHOK line, then their gradient norms: NORMS
  line); then the sharded resume: an
  uninterrupted 4-step ``fit`` on one repeated scene, a 2-step ``fit``
  saved, a fresh state restored from the checkpoint (every parameter and
  Adam moment must be this rank's slice of the whole file), and a resumed
  ``fit`` to step 4 (RESUME line).
* ``render`` (world 2, rays = 2): ``make_sharded_renderer`` on a 32x32
  image; each rank saves the gathered image to ``render<rank>.npz``.
* ``cli`` (world 2): ``cli.train`` with ``--tensor_parallel 2`` for 2
  steps on the corpus, with the val summary at step 2, each rank logging
  under ``rank<rank>/`` (CLI line: the returned log).
* ``fused`` (world 2, model = 2): the model sliced by ``shard_state``
  renders a 32x32 image through ``make_sharded_renderer`` on each fused
  route (``FUSED_ROUTES``: K2, K4 and K9's plain versions on the gathered
  weights); each rank saves the images to ``fused<rank>.npz``.
* ``kernels`` (world 4, DP 2 x TP 2, ``CAR_TRAIN_KERNELS=1``): one step
  of the kernel route (K2's plain version on the gathered weights, K1's);
  each rank saves its loss, gradient norm and the gradients of its
  sliced exchange weights to ``kernels<rank>.npz``, then the same with the
  gather's backward replaced by a sum over the model group (a
  reduce-scatter's) under the ``summed_`` keys.
"""

import itertools
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

TINY = dict(fusion_features=32, vit_width=64, vit_depth=2, vit_heads=2,
            resnet_layers=(1, 1, 1))
TINY_FLAGS = ['--fusion_features', '32', '--vit_width', '64',
              '--vit_depth', '2', '--vit_heads', '2',
              '--resnet_layers', '1', '1', '1', '--npoints', '8',
              '--device', 'cpu']
FRAME_HW = (64, 114)
RENDER_HW = 32
# the fused exchanges a sliced model renders through (the renderer's flags)
FUSED_ROUTES = {'k2': {}, 'k4': dict(fused_render=True),
                'k9': dict(fused_epilogue=False, fused_mlp=True)}
# the exchange's sliced weights (parallel/mesh.py _TP_RULES)
EXCHANGE_SLICED = ('query_encode_latent.kernel', 'query_encode_latent.bias',
                   'query_encode_latent_2.kernel', 'key_map.kernel',
                   'key_map.bias', 'key_map_2.kernel')


def _model(weights: Path, **kw):
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    model = CrossAttentionRenderer(n_view=2, npoints=8, device='cpu', **TINY,
                                   **kw)
    model.load_state_dict(torch.load(weights, weights_only=True))
    return model


def train(rank, world, port, out: Path) -> None:
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.parallel.distributed import (
        process_batch_slice)
    from cross_attention_renderer_torch.parallel.mesh import (
        param_spec, shard_tensor)
    from cross_attention_renderer_torch.tools import multihost_smoke as MH
    from cross_attention_renderer_torch.train import trainer as T

    weights = out / 'weights.pt'
    smoke = MH.main([str(rank), str(world), str(port), '--device', 'cpu',
                     '--data', '2', '--model', '2', '--weights',
                     str(weights)])
    print('NORMS ' + json.dumps(smoke['grad_norms']), flush=True)
    mesh = smoke['mesh']

    start, size = process_batch_slice(MH.GLOBAL_BATCH, mesh)
    scene = MH.take_rows(make_scene(0, batch=MH.GLOBAL_BATCH, n_view=2, H=64,
                                    W=64, n_rays=16, device='cpu'),
                         start, size)
    cfg = T.TrainConfig(lr=MH.LR, steps_til_summary=10 ** 6,
                        iters_til_checkpoint=10 ** 6)

    def run(steps, losses, **kw):
        return T.fit(_model(weights), cfg, itertools.repeat(scene), steps,
                     mesh=mesh, log_fn=lambda i, m: losses.append(
                         float(m['total_loss'])), **kw)

    ref, first, second = [], [], []
    run(4, ref)
    ckpt = out / 'ckpt'
    T.save_checkpoint(ckpt, run(2, first), 'current')

    whole = torch.load(ckpt / 'current.pt', weights_only=True)
    probe = T.shard_state(T.create_train_state(_model(weights), cfg), mesh)
    T.restore_checkpoint(ckpt, probe, 'current', restore_optimizer=True)
    moments = probe.optimizer.adam.state
    sliced, equal = 0, True
    for i, (name, p) in enumerate(probe.model.named_parameters()):
        spec = param_spec(name, p)
        sliced += bool(spec)
        full = whole['params'][name]
        equal &= (tuple(p.shape) != tuple(full.shape)) == bool(spec)
        equal &= torch.equal(p.detach(), shard_tensor(full, spec, mesh))
        for k in ('exp_avg', 'exp_avg_sq'):
            equal &= torch.equal(moments[p][k], shard_tensor(
                whole['optimizer']['state'][i][k], spec, mesh))

    state = run(4, second, ckpt_dir=str(ckpt), resume=True)
    print('RESUME ' + json.dumps({
        'ref': ref, 'losses': first + second, 'step': state.step,
        'restored_step': probe.step, 'sliced': sliced,
        'restored_slices': bool(equal)}), flush=True)


def render(rank, world, port, out: Path) -> None:
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.parallel.distributed import (
        initialize, make_global_mesh)
    from cross_attention_renderer_torch.train.evaluation import (
        make_sharded_renderer)

    initialize(f'localhost:{port}', world, rank, backend='gloo')
    mesh = make_global_mesh(data=1, model=1, rays=world, device_type='cpu')
    model = _model(out / 'weights.pt')
    scene = make_scene(6, H=RENDER_HW, W=RENDER_HW,
                       n_rays=RENDER_HW * RENDER_HW, full_image=True,
                       device='cpu')
    with torch.inference_mode():
        z = model.encode(scene)
    rgb, valid = make_sharded_renderer(model, mesh)(scene, z,
                                                    scene['query']['uv'])
    np.savez(out / f'render{rank}.npz', rgb=rgb.numpy(), valid=valid.numpy())
    print('RENDER', tuple(rgb.shape), flush=True)


def cli(rank, world, port, out: Path) -> None:
    from cross_attention_renderer_torch.cli import train as train_cli
    from cross_attention_renderer_torch.data import realestate as PR

    # the loaders cut to the corpus's frames, as tests/test_torch_cli.py
    PR.IMG_H, PR.IMG_W = FRAME_HW
    PR.CROP = FRAME_HW[0]
    frames, poses = out / 'corpus' / 'frames', out / 'corpus' / 'poses.mat'
    res = train_cli.main([
        '--img_root', str(frames), '--pose_root', str(poses),
        '--val_img_root', str(frames), '--val_pose_root', str(poses),
        '--logging_root', str(out / f'rank{rank}'),
        '--experiment_name', 'tp', '--batch_size', '1', '--max_steps', '2',
        '--num_workers', '0', '--query_sparsity', '16',
        '--steps_til_log', '1', '--steps_til_summary', '2',
        '--tensor_parallel', '2',
        '--coordinator_address', f'localhost:{port}',
        '--num_processes', str(world), '--process_id', str(rank),
        *TINY_FLAGS])
    print('CLI ' + json.dumps(
        [{k: v for k, v in r.items() if k != 'ms'} for r in res['log']]),
        flush=True)


def fused(rank, world, port, out: Path) -> None:
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.parallel.distributed import (
        initialize, make_global_mesh)
    from cross_attention_renderer_torch.train import trainer as T
    from cross_attention_renderer_torch.train.evaluation import (
        make_sharded_renderer)

    initialize(f'localhost:{port}', world, rank, backend='gloo')
    mesh = make_global_mesh(data=1, model=world, rays=1, device_type='cpu')
    scene = make_scene(6, H=RENDER_HW, W=RENDER_HW,
                       n_rays=RENDER_HW * RENDER_HW, full_image=True,
                       device='cpu')
    images = {}
    for route, kw in FUSED_ROUTES.items():
        model = _model(out / 'weights.pt', **kw)
        T.shard_state(T.create_train_state(model, T.TrainConfig()), mesh)
        assert model.key_map.tp is not None
        with torch.inference_mode():
            z = model.encode(scene)
            rgb, valid = make_sharded_renderer(model, mesh)(
                scene, z, scene['query']['uv'])
        images[f'{route}_rgb'], images[f'{route}_valid'] = rgb, valid
    np.savez(out / f'fused{rank}.npz',
             **{k: v.numpy() for k, v in images.items()})
    print('FUSED', sorted(images), flush=True)


def kernels(rank, world, port, out: Path) -> None:
    import os

    from cross_attention_renderer_torch import layers
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.parallel.distributed import (
        all_reduce_sum, initialize, make_global_mesh, process_batch_slice)
    from cross_attention_renderer_torch.tools import multihost_smoke as MH
    from cross_attention_renderer_torch.train import trainer as T

    os.environ['CAR_TRAIN_KERNELS'] = '1'
    initialize(f'localhost:{port}', world, rank, backend='gloo')
    mesh = make_global_mesh(data=2, model=2, device_type='cpu')
    start, size = process_batch_slice(MH.GLOBAL_BATCH, mesh)
    scene = MH.take_rows(make_scene(0, batch=MH.GLOBAL_BATCH, n_view=2,
                                    H=64, W=64, n_rays=16, device='cpu'),
                         start, size)

    def one_step(prefix):
        model = _model(out / 'weights.pt')
        cfg = T.TrainConfig(lr=MH.LR)
        state = T.shard_state(T.create_train_state(model, cfg), mesh)
        _, m = T.make_train_step(model, cfg, mesh)(state, scene)
        params = dict(model.named_parameters())
        got = {prefix + n: params[n].grad.numpy() for n in EXCHANGE_SLICED}
        got[prefix + 'loss'] = np.float32(m['total_loss'])
        got[prefix + 'grad_norm'] = np.float32(m['grad_norm'])
        return got

    res = one_step('')

    def summed_backward(ctx, grad):
        # what a reduce-scatter gives: the ranks' gradients summed, then
        # this rank's slice
        rank_ = torch.distributed.get_rank(ctx.group)
        total = all_reduce_sum(grad, ctx.group)
        return (total.narrow(ctx.dim, rank_ * ctx.size, ctx.size), None,
                None)

    layers._GatherFromGroup.backward = staticmethod(summed_backward)
    res.update(one_step('summed_'))
    np.savez(out / f'kernels{rank}.npz', **res,
             model_rank=np.int32(mesh.get_local_rank('model')))
    print('KERNELS', float(res['loss']), flush=True)


if __name__ == '__main__':
    torch.set_num_threads(1)
    case, rank, world, port, out = sys.argv[1:]
    try:
        {'train': train, 'render': render, 'cli': cli, 'fused': fused,
         'kernels': kernels}[case](
            int(rank), int(world), int(port), Path(out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
