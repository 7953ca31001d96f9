"""Training CLI.

Port of ``cross_attention_renderer_tpu/cli/train.py``, the replacement for
the reference's ``experiment_scripts/train_realestate10k.py`` /
``train_acid.py``. Usage:

  python -m cross_attention_renderer_torch.cli.train \\
      --experiment_name stage1 --img_root ... --pose_root ... \\
      --batch_size 12 --max_steps 200000
  # stage 2 fine-tune (README.md:56-58):
  ... --checkpoint_path logs/stage1/checkpoints --lpips --depth --batch_size 4

More than one process: start one per card (rank), each with
``--coordinator_address host:port --num_processes N --process_id <rank>``
(or under torchrun, which sets them). The ranks form a (data, model) mesh,
``--tensor_parallel`` ways of tensor parallelism and ``--data_parallel``
(0: all remaining ranks) of data parallelism; each rank loads its data
coordinate's rows of every global batch of ``--batch_size``. The primary
rank logs and writes the checkpoints. ``--device cpu`` runs the ranks on
the CPU over gloo.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch.distributed as dist

from cross_attention_renderer_torch.cli.common import (
    base_parser, build_model, restore_params, scene_batch)
from cross_attention_renderer_torch.data.realestate import (
    RealEstate10k, batch_iterator)
from cross_attention_renderer_torch.parallel.distributed import (
    initialize, is_primary, make_global_mesh, rank_device)
from cross_attention_renderer_torch.parallel.mesh import axis_size
from cross_attention_renderer_torch.train.trainer import (
    TrainConfig, create_train_state, fit)


def main(argv=None) -> dict:
    """Trains; returns {'state': the final train state, 'log': the printed
    steps' metrics and ms a step}."""
    p = base_parser('Train the cross-attention renderer')
    p.add_argument('--batch_size', type=int, default=12)
    p.add_argument('--num_workers', type=int, default=8,
                   help='prefetch worker threads (reference: 8 torch '
                        'DataLoader workers, train_realestate10k.py:81)')
    p.add_argument('--lr', type=float, default=5e-5)
    p.add_argument('--max_steps', type=int, default=200000)
    p.add_argument('--query_sparsity', type=int, default=192)
    p.add_argument('--lpips', action='store_true')
    p.add_argument('--depth', action='store_true')
    p.add_argument('--l2_coeff', type=float, default=1e-3)
    p.add_argument('--steps_til_summary', type=int, default=1000)
    p.add_argument('--iters_til_ckpt', type=int, default=10000)
    p.add_argument('--steps_til_log', type=int, default=50,
                   help='print the metrics and the ms since the last '
                        'printed step every this many steps')
    p.add_argument('--data_parallel', type=int, default=0,
                   help='DP ways (0 = all ranks the other axes leave)')
    p.add_argument('--tensor_parallel', type=int, default=1)
    # one process a card, joined over TCP (the reference's NCCL
    # rendezvous, train_realestate10k.py:71); torchrun's MASTER_ADDR,
    # WORLD_SIZE and RANK stand in for the three
    p.add_argument('--coordinator_address', type=str, default=None,
                   help='host:port of process 0 (multi-process runs)')
    p.add_argument('--num_processes', type=int, default=None)
    p.add_argument('--process_id', type=int, default=None)
    p.add_argument('--val_img_root', type=str, default=None)
    p.add_argument('--val_pose_root', type=str, default=None)
    opt = p.parse_args(argv)
    initialize(opt.coordinator_address, opt.num_processes, opt.process_id,
               backend='gloo' if opt.device == 'cpu' else None)
    opt.device = str(rank_device(opt.device))
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = None
    if world > 1 or opt.tensor_parallel > 1 or opt.data_parallel > 1:
        mesh = make_global_mesh(data=opt.data_parallel,
                                model=opt.tensor_parallel,
                                device_type=opt.device.split(':')[0])
        if is_primary():
            print(f'mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} '
                  f'over {world} process(es)', flush=True)
    shard = ((mesh.get_local_rank('data'), axis_size(mesh, 'data')) if mesh
             else (0, 1))

    log_dir = Path(opt.logging_root) / opt.experiment_name
    ckpt_dir = log_dir / 'checkpoints'
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    if opt.co3d_root:
        from cross_attention_renderer_torch.data.co3d import CO3Dv2Dataset
        dataset = CO3Dv2Dataset(opt.co3d_root, category=opt.co3d_category,
                                subset='fewview_train',
                                num_input_views=opt.views,
                                query_sparsity=opt.query_sparsity)
    else:
        dataset = RealEstate10k(
            opt.img_root, opt.pose_root, num_ctxt_views=opt.views,
            query_sparsity=opt.query_sparsity, lpips=opt.lpips, augment=True)
    data = batch_iterator(dataset, opt.batch_size,
                          num_workers=opt.num_workers, device=opt.device,
                          shard=shard)

    model = build_model(opt)
    cfg = TrainConfig(lr=opt.lr, depth=opt.depth, lpips=opt.lpips,
                      l2_weight=opt.l2_coeff,
                      steps_til_summary=opt.steps_til_summary,
                      iters_til_checkpoint=opt.iters_til_ckpt)

    lpips_fn = None
    if opt.lpips:
        # Stage-2 fine-tune (reference README.md:56-58): the LPIPS term is
        # the point of the stage, so missing weights are a hard error.
        from cross_attention_renderer_torch.losses.lpips import load_lpips
        lpips_fn = load_lpips(device=opt.device)

    state = None
    if opt.checkpoint_path:
        state = create_train_state(model, cfg)
        restore_params(state, opt.checkpoint_path)
        print(f'warm-started from {opt.checkpoint_path}')

    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        SummaryWriter = None
    # reference rank-0-only logging (training.py:60,82,105)
    writer = (SummaryWriter(str(log_dir / 'summaries'), flush_secs=10)
              if SummaryWriter is not None and is_primary() else None)

    last = [time.perf_counter(), 0]
    history = []

    def log_fn(step, metrics):
        # the ms since the last logged step, over the steps since: each
        # step's time and the wait for the next batch (the float() of the
        # metrics waits for the card); every rank keeps the log, the
        # primary prints it
        if step % opt.steps_til_log == 0:
            vals = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            ms = (now - last[0]) * 1e3 / max(step + 1 - last[1], 1)
            last[:] = [now, step + 1]
            history.append(dict(vals, step=step, ms=ms))
            if not is_primary():
                return
            line = ' '.join(f'{k}={v:.4f}' for k, v in vals.items())
            print(f'step {step}: {line} ({ms:.1f} ms a step)', flush=True)
            if writer is not None:
                for k, v in vals.items():
                    writer.add_scalar(k, v, step)

    # The primary renders the val image; with tensor parallelism every
    # rank does, since each holds a slice of the model.
    sliced = opt.tensor_parallel > 1
    val_fn = None
    if (opt.val_img_root and SummaryWriter is not None
            and (is_primary() or sliced)):
        val_fn = _make_val_fn(opt, model, writer)

    last[0] = time.perf_counter()
    state = fit(model, cfg, data, opt.max_steps, ckpt_dir=str(ckpt_dir),
                mesh=mesh, state=state, log_fn=log_fn, val_fn=val_fn,
                lpips_fn=lpips_fn)
    return {'state': state, 'log': history}


def _make_val_fn(opt, model, writer):
    """The held-out check written every ``steps_til_summary`` steps: a
    strided 128x128 grid of the first Vis scene's query frame rendered
    whole (``make_summary_renderer``), its PSNR and the summary images,
    written where ``writer`` is given. A model sliced for tensor
    parallelism renders on the same fused route, its exchange reading the
    sliced weights gathered over the model group (every rank renders).
    A failed diagnostic prints a warning and never stops the run."""
    import torch

    from cross_attention_renderer_torch.data.realestate import (
        RealEstate10kVis)
    from cross_attention_renderer_torch.train.evaluation import (
        make_summary_renderer)
    from cross_attention_renderer_torch.train.summaries import (
        write_summaries)
    val_ds = RealEstate10kVis(opt.val_img_root,
                              opt.val_pose_root or opt.pose_root,
                              num_ctxt_views=opt.views)
    summary_render = make_summary_renderer(model, n_chunks=4)

    def val_fn(state, step):
        try:
            scene = scene_batch(val_ds[0], opt.device)
            H, W = scene['context']['rgb'].shape[2:4]
            side, stride = 128, max(1, H // 128)
            uv = scene['query']['uv'].reshape(1, 1, H, W, 2)
            uv = uv[:, :, ::stride, ::stride][:, :, :side, :side]
            uv = uv.contiguous().reshape(1, 1, -1, 2)
            with torch.inference_mode():
                z = state.model.encode(scene)
            out = summary_render(scene, z, uv)
            s = dict(scene)
            s['query'] = dict(scene['query'], uv=uv)
            gt = scene['query']['rgb'].reshape(1, 1, H, W, 3)
            gt = gt[:, :, ::stride, ::stride][:, :, :side, :side]
            gt = gt.reshape(-1, 3).float().cpu().numpy()
            pred = out['rgb'].float().reshape(-1, 3).cpu().numpy()
            mse = float(np.mean((pred - gt) ** 2))
            psnr = 10.0 * np.log10(4.0 / max(mse, 1e-12))   # [-1, 1] range
            if writer is None:
                return
            writer.add_scalar('val_psnr', psnr, step)
            print(f'step {step}: val_psnr={psnr:.2f}', flush=True)
            write_summaries(writer, step, s, out, prefix='val_')
        except Exception as e:      # diagnostics are best-effort
            print(f'WARNING: val summary failed at step {step}: {e!r}',
                  flush=True)

    return val_fn


if __name__ == '__main__':
    try:
        main()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
