"""The model's operations (products and convolutions, multiply-add as two)
from the configuration's shapes: the encode of one scene by the
configuration's encoder (``model``), the render of one whole image, and
one stage-1 train step (forward and backward, taken as three forwards).
Elementwise work (norms, pooling, softmax, interpolation, geometry) is
not counted."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location(
    'bench_work_shapes', Path(__file__).with_name('shapes.py'))
shapes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(shapes)


def conv(k, cin, cout, h, w):
    return 2 * k * k * cin * cout * h * w


def encode_ops(cfg: dict) -> float:
    """The pyramid of one scene (all its views)."""
    return {'midas_vit': _dpt_ops, 'resnet': _resnet34_ops,
            'unet': _unet_ops}[shapes.ref.encoder(cfg)](cfg)


def _resnet34_ops(cfg: dict) -> float:
    """ResNet34's conv1 .. layer3 (the 7x7 stem and the 3x3 convs of
    stride 2 round their output up)."""
    s = shapes.sizes(cfg)
    h, w = -(-s['H'] // 2), -(-s['W'] // 2)
    ops = conv(7, 3, 64, h, w)
    for _, d_in, ch, stride, _ in shapes.ref.resnet34_blocks():
        if stride == 2:
            h, w = -(-h // 2), -(-w // 2)
        ops += conv(3, d_in, ch, h, w) + conv(3, ch, ch, h, w)
        if d_in != ch or stride != 1:
            ops += conv(1, d_in, ch, h, w)
    return float(s['V'] * ops)


def _unet_ops(cfg: dict) -> float:
    """The U-Net's down path: down1 at full resolution, each later conv
    after a 2x2 pool."""
    s = shapes.sizes(cfg)
    h, w = s['H'], s['W']
    ops = conv(7, 3, 32, h, w)
    d_in = 32
    for ch, k in shapes.ref.UNET_DOWN:
        h, w = h // 2, w // 2
        ops += conv(k, d_in, ch, h, w)
        d_in = ch
    return float(s['V'] * ops)


def _dpt_ops(cfg: dict) -> float:
    """The R50 stem, the joint ViT, the DPT fusion and the
    full-resolution conv."""
    s = shapes.sizes(cfg)
    H, W, V, ff, w = s['H'], s['W'], s['V'], s['ff'], s['w']
    ops = conv(7, 3, 64, H // 2, W // 2)                 # R50 stem
    d_in, res = 64, H // 4
    for st, n in enumerate(cfg['resnet_layers']):
        ch, mid = 256 * 2 ** st, 64 * 2 ** st
        for b in range(n):
            stride = 2 if (b == 0 and st > 0) else 1
            out = res // stride
            ops += conv(1, d_in, mid, res, res) + conv(3, mid, mid, out, out)
            ops += conv(1, mid, ch, out, out)
            if d_in != ch or stride == 2:
                ops += conv(1, d_in, ch, out, out)
            d_in, res = ch, out
    N = (H // 16) * (W // 16)
    T = V * (1 + N)                                       # joint tokens
    vit = V * N * 2 * 1024 * w + V * 2 * 16 * w
    vit += s['depth'] * (2 * T * w * w * 4 + 4 * T * T * w
                         + 2 * T * w * 4 * w * 2)
    vit += 2 * V * N * 2 * (2 * w) * w                    # readouts
    dpt = (2 * conv(1, w, w, H // 16, W // 16) + conv(3, w, w, H // 32, W // 32)
           + conv(3, 256, ff, H // 4, W // 4) + conv(3, 512, ff, H // 8, W // 8)
           + conv(3, w, ff, H // 16, W // 16) + conv(3, w, ff, H // 32, W // 32))
    for units, res_in in ((1, H // 32), (2, H // 16), (2, H // 8), (2, H // 4)):
        dpt += units * 2 * conv(3, ff, ff, res_in, res_in)
        dpt += conv(1, ff, ff, 2 * res_in, 2 * res_in)
    full = conv(7, 3, 64, H, W)
    return float(V * (ops + dpt + full) + vit)


def ray_ops(cfg: dict) -> float:
    """One query ray: the exchange, the query MLPs, both attention
    rounds, the round-2 latent embedding and phi."""
    s = shapes.sizes(cfg)
    V, P, F, O, K = s['V'], s['P'], s['F'], s['O'], s['K']
    m = V * P                                             # samples a ray
    macs = m * (V * ((F + 3) * F + F * O) + V * O * O + V * O * K + K * K)
    macs += m * (16 * K + K * K)                          # query MLP
    macs += 2 * m * (K + O)                               # two rounds
    macs += V * O * K                                     # encode_latent
    macs += m * ((K + 16) * K + K * K)                    # repeat query
    h, n = s['phi_hidden'], s['phi_blocks']                # phi
    macs += 9 * V * h + n * (V * O * h + 2 * h * h) + h * 3
    return 2.0 * macs


def render_ops(cfg: dict) -> float:
    """One whole image with its scene's encode."""
    return encode_ops(cfg) + shapes.sizes(cfg)['R'] * ray_ops(cfg)


def train_ops(cfg: dict, traffic: dict) -> float:
    """One train step of ``batch`` scenes of ``rays`` rays each."""
    forward = traffic['batch'] * (encode_ops(cfg)
                                  + traffic['rays'] * ray_ops(cfg))
    return 3.0 * forward
