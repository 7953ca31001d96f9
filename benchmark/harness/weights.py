"""The model's weights, drawn on the device from the seed in a few large
calls, in f32 (the program keeps f32 parameters and computes in its
configured type). The same tensors load into the program and into the
reference. Every layer is drawn, ``phi``'s last layers too, so that every
layer reaches the image."""

from __future__ import annotations

import math

import torch

from harness.seeds import generator
from reference.model import fan_in, param_specs


# The last product (or norm) of every residual branch is drawn at this
# share of its layer's scale, as trained residual networks hold it: with
# every branch at full scale the random network is chaotic, and the f32
# reference and a bf16 run part by a tenth of the image (R50's third
# stage alone takes the rounding from 5% to 28%).
BRANCH = 0.1


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{name: f32 tensor} for every parameter of ``cfg``'s model."""
    specs = param_specs(cfg)
    counts = [math.prod(shape) for _, shape, _ in specs]
    std, mean = [], []
    for name, shape, draw in specs:
        if draw in ('fan_in', 'branch'):
            std.append(1.0 / math.sqrt(fan_in(name, shape))
                       * (BRANCH if draw == 'branch' else 1.0))
        elif draw == 'branch_scale':
            std.append(0.1 * BRANCH)
        else:
            std.append(0.02 if draw == 'embed' else 0.1)
        mean.append({'scale': 1.0, 'branch_scale': BRANCH}.get(draw, 0.0))
    sizes = torch.tensor(counts, device=device)
    flat = torch.randn(sum(counts), generator=generator(seed, 'weights',
                                                        device),
                       device=device)
    flat.mul_(torch.repeat_interleave(torch.tensor(std, device=device),
                                      sizes))
    flat.add_(torch.repeat_interleave(torch.tensor(mean, device=device),
                                      sizes))
    out, offset = {}, 0
    for (name, shape, _), n in zip(specs, counts):
        out[name] = flat[offset:offset + n].view(shape)
        offset += n
    return out
