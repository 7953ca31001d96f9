"""On-disk training throughput on one NVIDIA card: the stage-1 recipe fed
from a corpus on disk through the native loader and threaded prefetch.

  python -m cross_attention_renderer_torch.tools.bench_ondisk --root DIR \\
      [--steps 500] [--workers 4] [--batch 12] [--iter-only] \\
      [--iter-batches 40] [--device cuda]

Port of the JAX repository's ``tools/bench_ondisk.py``. ``DIR`` is a
corpus written by the port's ``tools/make_corpus.py`` (``DIR/frames``,
``DIR/poses.mat``). It measures (a) the input pipeline alone: scenes/s
drained from ``data/realestate.py:batch_iterator`` (``--workers``
threads, 2 batches of prefetch; the frames decoded by
``data/native_loader.py`` where it builds, else its numpy route, which it
prints) over ``--iter-batches`` batches after a warm-up one; (b) unless
``--iter-only``, ``--steps`` train steps/s of the flagship 122M bf16
model (batch ``--batch``, 192 query rays, ``TrainConfig()``, the default
route) drawing each batch from the iterator, one step first as the
warm-up. Prints both rates and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

from cross_attention_renderer_torch.tools import _card


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--root', required=True)
    p.add_argument('--steps', type=int, default=500)
    p.add_argument('--workers', type=int, default=4)
    p.add_argument('--batch', type=int, default=12)
    p.add_argument('--iter-only', action='store_true')
    p.add_argument('--iter-batches', type=int, default=40)
    _card.add_device_flag(p)
    return p


def measure(opt, dev, **model_kw) -> dict:
    from cross_attention_renderer_torch.data.realestate import (
        RealEstate10k, batch_iterator)
    ds = RealEstate10k(f'{opt.root}/frames', f'{opt.root}/poses.mat',
                       num_ctxt_views=2, query_sparsity=192, augment=True,
                       lpips=False, seed=0)
    print(f'{len(ds)} scenes on disk', flush=True)
    it = batch_iterator(ds, opt.batch, seed=0, num_workers=opt.workers,
                        device=dev)
    batch = next(it)               # warms the prefetch pipeline
    t0 = time.perf_counter()
    for _ in range(opt.iter_batches):
        batch = next(it)
    dt = time.perf_counter() - t0
    out = {'scenes_per_s': opt.iter_batches * opt.batch / dt}
    print(f'iterator: {out["scenes_per_s"]:.1f} scenes/s '
          f'({opt.iter_batches} batches of {opt.batch}, '
          f'workers={opt.workers})', flush=True)
    if opt.iter_only:
        return out

    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, create_train_state, make_train_step)
    model = _card.flagship(2, dev, **model_kw).train()
    cfg = TrainConfig()
    state = create_train_state(model, cfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f'params: {n_params / 1e6:.1f}M  (bf16 compute)', flush=True)
    step = make_train_step(model, cfg)
    state, metrics = step(state, batch)               # warm-up
    float(metrics['total_loss'])
    t0 = time.perf_counter()
    for _ in range(opt.steps):
        state, metrics = step(state, next(it))
    tot = float(metrics['total_loss'])                # sync
    dt = time.perf_counter() - t0
    out.update(steps_per_s=opt.steps / dt, loss=tot)
    print(f'on-disk training: {out["steps_per_s"]:.2f} steps/s '
          f'({opt.steps} steps, loss {tot:.3f})', flush=True)
    return out


def main(argv=None) -> dict:
    opt = parser().parse_args(argv)
    dev = _card.device('bench_ondisk', opt.device)
    _card.print_card(dev)
    return measure(opt, dev)


if __name__ == '__main__':
    main()
