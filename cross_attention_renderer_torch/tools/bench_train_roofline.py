"""Train-step roofline: the flagship stage-1 step split on one NVIDIA card.

  python -m cross_attention_renderer_torch.tools.bench_train_roofline \\
      [--vit_depth 12] [--no_high_freq] [--batch 12] [--remat] \\
      [--iters 10] [--device cuda]

Port of the JAX repository's ``tools/bench_train_roofline.py``: the
flagship V=2 model (bf16 compute, seed-0 parameters), ``batch`` synthetic
256x256 scenes of 192 query rays, ``TrainConfig()``, on the trainer's
default route (plain attention, unfused exchange). It times, each the mean
of ``--iters`` calls after one warm-up between CUDA events:

  full step            = forward + backward + optimizer update
  forward              = encoder forward + render forward + loss
  fwd+bwd              = forward and backward, no update
  render-only f+b      = forward and backward with the encoder's output z
                         computed once and held constant: the epipolar
                         gather, exchange, attention and decoder's share
  encoder f+b          = (fwd+bwd) - (render-only f+b)
  encoder forward      = ``encode`` alone

and derives backward = (fwd+bwd) - forward and optimizer+clip = step -
(fwd+bwd). FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``
over one forward and backward: the products and convolutions it sees
(attention's and the elementwise work are not in the count), over the
H100's 989 TFLOP/s dense bf16 peak. The optimizer's bound is the bytes
it must move (the f32 parameters, gradients and Adam's two moments read,
the parameters and moments written) at 3.35 TB/s. Prints the card's name
and power limit.
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch

from cross_attention_renderer_torch.tools import _card

RAYS = 192
BF16_PEAK = 989e12          # H100 SXM dense bf16, published
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--vit_depth', type=int, default=12)
    p.add_argument('--no_high_freq', action='store_true')
    p.add_argument('--batch', type=int, default=12)
    p.add_argument('--remat', action='store_true',
                   help='checkpoint the encoder (trade FLOPs for memory)')
    p.add_argument('--iters', type=int, default=10)
    _card.add_device_flag(p)
    return p


def render_loss_fn(model, cfg) -> Callable:
    """``loss(scene, z)``: the train model's total loss rendered from a
    given pyramid ``z``, which the caller holds constant (computed under
    ``no_grad``): its gradient reaches every parameter but the
    encoder's."""
    from cross_attention_renderer_torch.losses.lf_loss import (
        LFLoss, total_loss)
    from cross_attention_renderer_torch.train.trainer import _train_model
    tm = _train_model(model)
    loss = LFLoss(l2_weight=cfg.l2_weight, depth=cfg.depth, lpips_fn=None)

    def fn(scene, z):
        return total_loss(loss(tm(scene, z=z), scene['query']))

    return fn


def encode_const(model, scene):
    """The train model's pyramid of ``scene``, without a gradient."""
    from cross_attention_renderer_torch.train.trainer import _train_model
    with torch.no_grad():
        return tuple(_train_model(model).encode(scene))


def split_fns(model, cfg, state, scene) -> dict:
    """The measured parts as callables of no argument: 'step', 'forward',
    'fwd_bwd', 'render_fb', 'encoder_fwd'."""
    from cross_attention_renderer_torch.train.trainer import (
        make_loss_fn, make_train_step)
    loss_fn = make_loss_fn(model, cfg)
    step = make_train_step(model, cfg)
    render_loss = render_loss_fn(model, cfg)
    z = encode_const(model, scene)
    params = [p for p in model.parameters() if p.requires_grad]

    def zero():
        for p in params:
            p.grad = None

    def forward():
        with torch.no_grad():
            return loss_fn(scene)[0]

    def fwd_bwd():
        zero()
        loss_fn(scene)[0].backward()

    def render_fb():
        zero()
        render_loss(scene, z).backward()

    def encoder_fwd():
        with torch.no_grad():
            return encode_const(model, scene)

    return {'step': lambda: step(state, scene), 'forward': forward,
            'fwd_bwd': fwd_bwd, 'render_fb': render_fb,
            'encoder_fwd': encoder_fwd}


def count_flops(model, cfg, scene) -> int:
    """FLOPs of one forward and backward of the train loss, as
    ``FlopCounterMode`` counts them (products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode

    from cross_attention_renderer_torch.train.trainer import make_loss_fn
    loss_fn = make_loss_fn(model, cfg)
    counter = FlopCounterMode(display=False)
    with counter:
        loss_fn(scene)[0].backward()
    for p in model.parameters():
        p.grad = None
    return counter.get_total_flops()


def optimizer_bytes(model) -> int:
    """Bytes an Adam step with its clip must move at least: each f32
    parameter, gradient and both moments read, the parameter and both
    moments written."""
    n = sum(p.numel() for p in model.parameters() if p.requires_grad)
    return n * 4 * 7


def measure(opt, dev, hw: int = _card.H, rays: int = RAYS,
            **model_kw) -> dict:
    """The split on ``dev``: ms of each part, the derived parts, FLOPs and
    the optimizer's byte bound. ``hw``, ``rays`` and ``model_kw`` (the
    model's widths) default to the flagship's (the tests' tiny config)."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, create_train_state)
    kw = dict(model_kw)
    if opt.vit_depth != 12:
        kw['vit_depth'] = opt.vit_depth
    model = _card.flagship(2, dev, no_high_freq=opt.no_high_freq,
                           remat=opt.remat, **kw).train()
    scene = make_scene(0, batch=opt.batch, n_view=2, H=hw, W=hw,
                       n_rays=rays, device=dev)
    cfg = TrainConfig()
    state = create_train_state(model, cfg)
    fns = split_fns(model, cfg, state, scene)
    t = {k: _card.mean_ms(f, opt.iters, dev) for k, f in fns.items()}
    flops = count_flops(model, cfg, scene)
    t['backward'] = t['fwd_bwd'] - t['forward']
    t['optimizer'] = t['step'] - t['fwd_bwd']
    t['encoder_fb'] = t['fwd_bwd'] - t['render_fb']
    nbytes = optimizer_bytes(model)
    return {'ms': t, 'flops': flops,
            'tflop_per_s': flops / (t['fwd_bwd'] * 1e-3) / 1e12,
            'mfu_pct': flops / (t['step'] * 1e-3) / BF16_PEAK * 100,
            'optimizer_bytes': nbytes,
            'optimizer_bound_ms': nbytes / HBM_BYTES_PER_S * 1e3}


def main(argv=None) -> dict:
    opt = parser().parse_args(argv)
    dev = _card.device('bench_train_roofline', opt.device)
    _card.print_card(dev)
    r = measure(opt, dev)
    t = r['ms']
    print(f'full step        : {t["step"]:8.1f} ms   '
          f'{1e3 / t["step"]:.2f} steps/s')
    print(f'  forward        : {t["forward"]:8.1f} ms')
    print(f'  backward       : {t["backward"]:8.1f} ms')
    print(f'  optimizer+clip : {t["optimizer"]:8.1f} ms   (bound '
          f'{r["optimizer_bound_ms"]:.2f} ms: '
          f'{r["optimizer_bytes"] / 1e9:.2f} GB at 3.35 TB/s)')
    print('fwd+bwd split    :')
    print(f'  render-only f+b: {t["render_fb"]:8.1f} ms  (z const)')
    print(f'  encoder f+b    : {t["encoder_fb"]:8.1f} ms  (by difference)')
    print(f'  encoder fwd    : {t["encoder_fwd"]:8.1f} ms')
    print(f'FLOP counter     : {r["flops"] / 1e12:.2f} TFLOP/step '
          '(products and convolutions, forward and backward)')
    print(f'MFU (H100 bf16)  : {r["mfu_pct"]:.1f}%  of 989 TFLOP/s over the '
          f'step ({r["tflop_per_s"]:.1f} TFLOP/s over fwd+bwd)', flush=True)
    return r


if __name__ == '__main__':
    main()
