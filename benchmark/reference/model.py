"""Plain PyTorch reference of the cross-attention renderer, for the
benchmark's correctness check.

The architecture of Du et al., "Learning to Render Novel Views from
Wide-Baseline Stereo Pairs" (CVPR 2023, arXiv 2304.08463; upstream
``models.py:42-626``), as one set of functions over a dict of parameters
named as the program names them, so that one set of weights loads into
both. Nothing here imports the program: the encoder, the epipolar
geometry, the latent exchange between views, the two rounds of joint
(view, sample) attention and the ResNet-FC decoder ``phi`` are written out
again from the description, channel-last. The configuration's ``model``
names the encoder, one of the three upstream takes (models.py:63-99):

* ``midas_vit``: the DPT hybrid (an R50 stem, a multi-view ViT-B/16 over
  the views' tokens jointly, the RefineNet fusion cut at the two finest
  maps) and a 7x7 full-resolution conv; 3 levels, 2 * fusion_features + 64
  wide;
* ``resnet``: ResNet34's conv1 .. layer3 without the first max-pool
  (upstream encoder.py:12-104, pixelNeRF's ``SpatialEncoder``), its four
  taps coarsest first; 4 levels, 512 wide;
* ``unet``: the down path of upstream's ``UNetEncoder`` (encoder.py:
  178-206), a 7x7 conv to 32 channels and a 2x2 max-pool, then conv + ReLU
  to 64 (5x5), 128, 256 and 512 (3x3) with a pool between; 4 levels, 960
  wide.

One departure, the port's own (``DEVIATIONS.md``): ResNet34 normalises
with GroupNorm(32, eps 1e-6) where upstream takes BatchNorm's running
statistics. Every encoder sees the ImageNet-normalised image, as upstream
normalises it for each (models.py:164-170).

Every product and convolution takes its operands through ``nx.q`` (a
:class:`Numerics`): the reference runs in f32 with TF32 off, and its
control rounds the operands to fp8 (e4m3 with a per-tensor scale, and
e5m2 for the gradients), the precision below the configuration's bf16.
The geometry runs in f32 in both, as the configuration states.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

HIDDEN = 128          # attention width (models.py:114)
PHI_HIDDEN = 128      # phi's width and residual blocks (models.py:596-612)
PHI_BLOCKS = 3
QUERY_FEAT = 16       # per-sample query features (models.py:528)
ATTN_SCALE = 1.0 / 16.0
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
ENCODERS = ('midas_vit', 'resnet', 'unet')
# ResNet34's (channels, blocks) of layer1 .. layer3, and its norms' eps
RESNET34_LAYERS = ((64, 3), (128, 4), (256, 6))
RESNET34_GN_EPS = 1e-6
# the U-Net's (channels, kernel size) of down2 .. down5
UNET_DOWN = ((64, 5), (128, 3), (256, 3), (512, 3))


# ---------------------------------------------------------------------------
# Numerics: f32, or fp8 with a per-tensor scale (the control)
# ---------------------------------------------------------------------------

def _fp8(x: Tensor, dtype: torch.dtype) -> Tensor:
    top = torch.finfo(dtype).max
    s = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return ((x.float() / s).clamp(-top, top).to(dtype).float() * s).to(
        x.dtype)


class _Fp8Round(torch.autograd.Function):
    """e4m3 forward, e5m2 gradient: what an fp8 product sees."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Numerics:
    """``kind`` 'f32' (operands as they are) or 'fp8' (rounded)."""

    def __init__(self, kind: str = 'f32'):
        if kind not in ('f32', 'fp8'):
            raise ValueError(f'numerics f32 or fp8, got {kind!r}')
        self.kind = kind

    def q(self, x: Tensor) -> Tensor:
        return x if self.kind == 'f32' else _Fp8Round.apply(x)


F32 = Numerics('f32')


# ---------------------------------------------------------------------------
# Parameters: names, shapes and how each is drawn
# ---------------------------------------------------------------------------

def _stages(cfg: dict) -> list[tuple[int, int, int, int]]:
    """(stage, block, d_in, out) of every R50 bottleneck."""
    out, d_in = [], 64
    for s, n in enumerate(cfg['resnet_layers']):
        ch = 256 * 2 ** s
        for b in range(n):
            out.append((s, b, d_in, ch))
            d_in = ch
    return out


def encoder(cfg: dict) -> str:
    """The configuration's encoder, its ``model``; raises ValueError for
    one the benchmark does not know, so that nothing reads another
    encoder's parameters, arithmetic or work in its place."""
    model = cfg.get('model')
    if model not in ENCODERS:
        raise ValueError(f'the configuration names the encoder {model!r}; '
                         f'the benchmark knows {", ".join(ENCODERS)}')
    return model


def pyramid_levels(cfg: dict) -> list[tuple[int, int]]:
    """(channels, downscale) of each level of the pyramid, in the order
    :func:`encode` returns them and the exchange concatenates them."""
    model = encoder(cfg)
    if model == 'midas_vit':
        ff = cfg['fusion_features']
        return [(ff, 4), (ff, 2), (64, 1)]
    if model == 'resnet':
        return [(256, 8), (128, 4), (64, 2), (64, 2)]
    return [(ch, 2 ** i) for i, (ch, _) in enumerate(UNET_DOWN, 1)]


def pyramid_width(cfg: dict) -> int:
    return sum(ch for ch, _ in pyramid_levels(cfg))


def latent_width(cfg: dict) -> int:
    return pyramid_width(cfg) // 2


class _Specs(list):
    """(name, shape, draw) of parameters, in the order they are added."""

    def add(self, name, shape, draw='fan_in'):
        self.append((name, tuple(shape), draw))

    def norm(self, name, c, draw='scale'):
        self.add(f'{name}.weight', (c,), draw)
        self.add(f'{name}.bias', (c,), 'shift')

    def dense(self, name, d_in, d_out, bias=True, draw='fan_in'):
        self.add(f'{name}.weight', (d_out, d_in), draw)
        if bias:
            self.add(f'{name}.bias', (d_out,), 'shift')

    def conv(self, name, d_in, d_out, k, bias=True, draw='fan_in'):
        self.add(f'{name}.weight', (d_out, d_in, k, k), draw)
        if bias:
            self.add(f'{name}.bias', (d_out,), 'shift')

    def kernel(self, name, d_in, d_out):
        self.add(f'{name}.kernel', (d_in, d_out))
        self.add(f'{name}.bias', (d_out,), 'shift')


def _dpt_specs(specs: _Specs, cfg: dict) -> None:
    """The DPT hybrid's parameters and the full-resolution conv's."""
    ff, w = cfg['fusion_features'], cfg['vit_width']
    conv, norm, dense = specs.conv, specs.norm, specs.dense
    e = 'encoder'
    conv(f'{e}.backbone.stem_conv', 3, 64, 7, bias=False)
    norm(f'{e}.backbone.stem_norm.GroupNorm_0', 64)
    for s, b, d_in, ch in _stages(cfg):
        p = f'{e}.backbone.stage{s}_block{b}'
        if d_in != ch or (b == 0 and s > 0):
            conv(f'{p}.downsample_conv', d_in, ch, 1, bias=False)
            norm(f'{p}.downsample_norm.GroupNorm_0', ch)
        mid = ch // 4
        for i, (a, c, k) in enumerate(((d_in, mid, 1), (mid, mid, 3),
                                        (mid, ch, 1)), 1):
            conv(f'{p}.conv{i}', a, c, k, bias=False)
            norm(f'{p}.norm{i}.GroupNorm_0', c,
                 'branch_scale' if i == 3 else 'scale')
    g = cfg['pretrain_grid']
    specs.add(f'{e}.vit.cls_token', (1, 1, w), 'embed')
    specs.add(f'{e}.vit.pos_embed', (1, 1 + g * g, w), 'embed')
    dense(f'{e}.vit.patch_proj', 1024, w)
    dense(f'{e}.vit.pose_embed', 16, w)
    for i in range(cfg['vit_depth']):
        p = f'{e}.vit.block{i}'
        norm(f'{p}.norm1', w)
        for n in ('query', 'key', 'value', 'out'):
            dense(f'{p}.attn.{n}', w, w,
                  draw='branch' if n == 'out' else 'fan_in')
        norm(f'{p}.norm2', w)
        dense(f'{p}.mlp_fc1', w, 4 * w)
        dense(f'{p}.mlp_fc2', 4 * w, w, draw='branch')
    for i in range(2):
        dense(f'{e}.ProjectReadout_{i}.project', 2 * w, w)
    conv(f'{e}.post3_conv', w, w, 1)
    conv(f'{e}.post4_conv1', w, w, 1)
    conv(f'{e}.post4_conv2', w, w, 3)
    for i, d_in in enumerate((256, 512, w, w), 1):
        conv(f'{e}.layer{i}_rn', d_in, ff, 3, bias=False)
    for i in range(1, 5):
        p = f'{e}.refinenet{i}'
        for unit in (('rcu1', 'rcu2') if i != 4 else ('rcu2',)):
            conv(f'{p}.{unit}.conv1', ff, ff, 3)
            conv(f'{p}.{unit}.conv2', ff, ff, 3, draw='branch')
        conv(f'{p}.out_conv', ff, ff, 1)
    conv('conv_map', 3, 64, 7)


def resnet34_blocks():
    """(name, d_in, channels, stride, last of its layer) of every ResNet34
    basic block."""
    d_in = 64
    for layer, (ch, n) in enumerate(RESNET34_LAYERS, 1):
        for b in range(n):
            yield (f'encoder.layer{layer}_b{b}', d_in, ch,
                   2 if b == 0 and layer > 1 else 1, b == n - 1)
            d_in = ch


def _resnet34_specs(specs: _Specs, cfg: dict) -> None:
    """ResNet34's; each block's second norm, the last of its residual
    branch, drawn as such."""
    specs.conv('encoder.conv1', 3, 64, 7, bias=False)
    specs.norm('encoder.norm1', 64)
    for p, d_in, ch, stride, _ in resnet34_blocks():
        specs.conv(f'{p}.conv1', d_in, ch, 3, bias=False)
        specs.norm(f'{p}.norm1', ch)
        specs.conv(f'{p}.conv2', ch, ch, 3, bias=False)
        specs.norm(f'{p}.norm2', ch, 'branch_scale')
        if d_in != ch or stride != 1:
            specs.conv(f'{p}.proj', d_in, ch, 1, bias=False)
            specs.norm(f'{p}.proj_norm', ch)


def _unet_specs(specs: _Specs, cfg: dict) -> None:
    """The U-Net's down path: no residual branch."""
    specs.conv('encoder.down1', 3, 32, 7)
    d_in = 32
    for i, (ch, k) in enumerate(UNET_DOWN, 2):
        specs.conv(f'encoder.down{i}', d_in, ch, k)
        d_in = ch


_ENCODER_SPECS = {'midas_vit': _dpt_specs, 'resnet': _resnet34_specs,
                  'unet': _unet_specs}


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str]]:
    """Every parameter as (name, shape, draw): 'fan_in' (normal with
    variance 1 / fan-in), 'branch' (the last product of a residual
    branch: a tenth of that), 'embed' (normal, std 0.02), 'scale' (1 +
    normal 0.1), 'branch_scale' (the last norm of a residual branch: a
    tenth of that) or 'shift' (normal 0.1). The configuration's encoder,
    then the renderer's."""
    V = cfg['n_view']
    base, ld = pyramid_width(cfg), latent_width(cfg)
    specs = _Specs()
    _ENCODER_SPECS[encoder(cfg)](specs, cfg)
    kernel = specs.kernel
    kernel('query_encode_latent', base + 3, base)
    kernel('query_encode_latent_2', base, ld)
    kernel('latent_value', ld * V, ld)
    kernel('key_map', ld * V, HIDDEN)
    kernel('key_map_2', HIDDEN, HIDDEN)
    kernel('query_embed', QUERY_FEAT, HIDDEN)
    kernel('query_embed_2', HIDDEN, HIDDEN)
    kernel('encode_latent', ld, HIDDEN)
    kernel('query_repeat_embed', HIDDEN + QUERY_FEAT, HIDDEN)
    kernel('query_repeat_embed_2', HIDDEN, HIDDEN)
    h = PHI_HIDDEN
    specs.dense('phi.lin_in', 9 * V, h)
    for i in range(PHI_BLOCKS):
        specs.dense(f'phi.lin_z{i}', ld * V, h)
        specs.dense(f'phi.block{i}.fc_0', h, h)
        specs.dense(f'phi.block{i}.fc_1', h, h, draw='branch')
    specs.dense('phi.lin_out', h, 3)
    return list(specs)


def fan_in(name: str, shape: tuple[int, ...]) -> int:
    """A weight's fan-in: a ``kernel`` is (in, out), a weight (out, in,
    ...)."""
    if name.endswith('.kernel'):
        return shape[0]
    return math.prod(shape[1:])


# ---------------------------------------------------------------------------
# Leaf operations
# ---------------------------------------------------------------------------

def dense(nx, P, name, x):
    b = P.get(f'{name}.bias')
    return F.linear(nx.q(x), nx.q(P[f'{name}.weight']), b)


def kernel(nx, P, name, *parts):
    """x @ kernel + bias over the channel concatenation of ``parts``."""
    x = torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]
    return nx.q(x) @ nx.q(P[f'{name}.kernel']) + P[f'{name}.bias']


def conv(nx, x, w, b=None, stride=1, pad=0):
    """NHWC input, OIHW weight; ``pad`` an int or (top, bottom, left,
    right)."""
    x = x.permute(0, 3, 1, 2)
    if isinstance(pad, tuple):
        x = F.pad(x, (pad[2], pad[3], pad[0], pad[1]))
        pad = 0
    y = F.conv2d(nx.q(x), nx.q(w), b, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def conv_p(nx, P, name, x, stride=1, pad=0):
    return conv(nx, x, P[f'{name}.weight'], P.get(f'{name}.bias'), stride,
                pad)


def group_norm(P, name, x, eps=1e-5):
    y = F.group_norm(x.permute(0, 3, 1, 2), 32, P[f'{name}.weight'],
                     P[f'{name}.bias'], eps)
    return y.permute(0, 2, 3, 1)


def layer_norm(P, name, x, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], P[f'{name}.weight'],
                        P[f'{name}.bias'], eps)


def same_pads(size, k, s):
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def std_conv(nx, P, name, x, stride=1, eps=1e-8):
    """Weight-standardised conv, TF-SAME padding, no bias."""
    w = P[f'{name}.weight']
    w = (w - w.mean(dim=(1, 2, 3), keepdim=True)) / torch.sqrt(
        w.var(dim=(1, 2, 3), unbiased=False, keepdim=True) + eps)
    k = w.shape[-1]
    pads = same_pads(x.shape[1], k, stride) + same_pads(x.shape[2], k,
                                                        stride)
    return conv(nx, x, w, None, stride, pads)


def resize(x, out_hw, align_corners):
    """Bilinear resize of (N, H, W, C)."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=out_hw, mode='bilinear',
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _backbone(nx, P, cfg, x):
    e = 'encoder.backbone'
    x = torch.relu(group_norm(P, f'{e}.stem_norm.GroupNorm_0',
                              std_conv(nx, P, f'{e}.stem_conv', x, 2,
                                       1e-6)))
    top, bottom = same_pads(x.shape[1], 3, 2)
    left, right = same_pads(x.shape[2], 3, 2)
    x = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom),
              value=-1e30)
    x = F.max_pool2d(x, 3, 2).permute(0, 2, 3, 1)
    outs = []
    stages = _stages(cfg)
    for s, b, d_in, ch in stages:
        p = f'{e}.stage{s}_block{b}'
        stride = 2 if (b == 0 and s > 0) else 1
        if f'{p}.downsample_conv.weight' in P:
            short = group_norm(P, f'{p}.downsample_norm.GroupNorm_0',
                               std_conv(nx, P, f'{p}.downsample_conv', x,
                                        stride))
        else:
            short = x
        y = torch.relu(group_norm(P, f'{p}.norm1.GroupNorm_0',
                                  std_conv(nx, P, f'{p}.conv1', x)))
        y = torch.relu(group_norm(P, f'{p}.norm2.GroupNorm_0',
                                  std_conv(nx, P, f'{p}.conv2', y, stride)))
        y = group_norm(P, f'{p}.norm3.GroupNorm_0',
                       std_conv(nx, P, f'{p}.conv3', y))
        x = torch.relu(y + short)
        if b == cfg['resnet_layers'][s] - 1:
            outs.append(x)
    return outs


def _vit(nx, P, cfg, grids, rel16):
    """Joint ViT over the V views' tokens; the two taps."""
    B, V, Hg, Wg, _ = grids.shape
    w, heads = cfg['vit_width'], cfg['vit_heads']
    e = 'encoder.vit'
    x = dense(nx, P, f'{e}.patch_proj', grids).reshape(B * V, Hg * Wg, w)
    x = torch.cat([P[f'{e}.cls_token'].expand(B * V, 1, w), x], dim=1)
    n = cfg['pretrain_grid']
    pos = P[f'{e}.pos_embed']
    grid = resize(pos[:, 1:].reshape(1, n, n, w), (Hg, Wg), False)
    pos = torch.cat([pos[:, :1], grid.reshape(1, Hg * Wg, w)], dim=1)
    x = x + pos + dense(nx, P, f'{e}.pose_embed', rel16).reshape(B * V, 1, w)
    T = x.shape[1]
    x = x.reshape(B, V * T, w)
    depth = cfg['vit_depth']
    taps = (8, 11) if depth == 12 else (max(depth * 3 // 4 - 1, 0),
                                        depth - 1)
    out = []
    hd = w // heads
    for i in range(depth):
        p = f'{e}.block{i}'
        h = layer_norm(P, f'{p}.norm1', x)

        def split(t):
            return t.reshape(B, V * T, heads, hd).transpose(1, 2)

        q = split(dense(nx, P, f'{p}.attn.query', h)) / math.sqrt(hd)
        k = split(dense(nx, P, f'{p}.attn.key', h))
        v = split(dense(nx, P, f'{p}.attn.value', h))
        a = torch.softmax(nx.q(q) @ nx.q(k).transpose(-1, -2), dim=-1)
        o = (nx.q(a) @ nx.q(v)).transpose(1, 2).reshape(B, V * T, w)
        x = x + dense(nx, P, f'{p}.attn.out', o)
        h = layer_norm(P, f'{p}.norm2', x)
        x = x + dense(nx, P, f'{p}.mlp_fc2',
                      F.gelu(dense(nx, P, f'{p}.mlp_fc1', h)))
        if i in taps:
            out.append(x.reshape(B * V, T, w))
    return out


def _rcu(nx, P, name, x):
    y = conv_p(nx, P, f'{name}.conv1', torch.relu(x), pad=1)
    return conv_p(nx, P, f'{name}.conv2', torch.relu(y), pad=1) + x


def _fusion(nx, P, name, x, skip=None):
    if skip is not None:
        x = x + _rcu(nx, P, f'{name}.rcu1', skip)
    x = _rcu(nx, P, f'{name}.rcu2', x)
    x = resize(x, (2 * x.shape[1], 2 * x.shape[2]), True)
    return conv_p(nx, P, f'{name}.out_conv', x)


def _dpt(nx, P, cfg, flat, cam2world, B, V):
    """The DPT hybrid's two fused maps and the full-resolution conv's."""
    c2w = cam2world.float()
    rel16 = (torch.linalg.inv(c2w[:, 0])[:, None] @ c2w).reshape(B, V, 16)
    s0, s1, s2 = _backbone(nx, P, cfg, flat)
    Hg, Wg = s2.shape[1], s2.shape[2]
    tap3, tap4 = _vit(nx, P, cfg, s2.reshape(B, V, Hg, Wg, -1), rel16)
    w = cfg['vit_width']
    e = 'encoder'

    def readout(i, tokens):
        t = torch.cat([tokens[:, 1:], tokens[:, :1].expand_as(tokens[:, 1:])],
                      dim=-1)
        return F.gelu(dense(nx, P, f'{e}.ProjectReadout_{i}.project', t)
                      ).reshape(B * V, Hg, Wg, w)

    l3 = conv_p(nx, P, f'{e}.post3_conv', readout(0, tap3))
    l4 = conv_p(nx, P, f'{e}.post4_conv2',
                conv_p(nx, P, f'{e}.post4_conv1', readout(1, tap4)),
                stride=2, pad=1)
    rn = [conv_p(nx, P, f'{e}.layer{i}_rn', t, pad=1)
          for i, t in enumerate((s0, s1, l3, l4), 1)]
    p4 = _fusion(nx, P, f'{e}.refinenet4', rn[3])
    p3 = _fusion(nx, P, f'{e}.refinenet3', p4, rn[2])
    p2 = _fusion(nx, P, f'{e}.refinenet2', p3, rn[1])
    p1 = _fusion(nx, P, f'{e}.refinenet1', p2, rn[0])
    zc = conv_p(nx, P, 'conv_map', flat, pad=3)
    return p2, p1, zc


def _resnet34(nx, P, x):
    """The stem's map and layer1 .. layer3's, coarsest first."""
    eps = RESNET34_GN_EPS
    x = torch.relu(group_norm(P, 'encoder.norm1',
                              conv_p(nx, P, 'encoder.conv1', x, 2, 3), eps))
    taps = [x]
    for p, _, _, stride, last in resnet34_blocks():
        y = torch.relu(group_norm(P, f'{p}.norm1',
                                  conv_p(nx, P, f'{p}.conv1', x, stride, 1),
                                  eps))
        y = group_norm(P, f'{p}.norm2', conv_p(nx, P, f'{p}.conv2', y, pad=1),
                       eps)
        if f'{p}.proj.weight' in P:
            x = group_norm(P, f'{p}.proj_norm',
                           conv_p(nx, P, f'{p}.proj', x, stride), eps)
        x = torch.relu(y + x)
        if last:
            taps.append(x)
    return tuple(reversed(taps))


def _max_pool(x):
    """2x2 max-pool, stride 2, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _unet(nx, P, x):
    """The four maps of the down path after down2 .. down5, finest
    first."""
    x = _max_pool(torch.relu(conv_p(nx, P, 'encoder.down1', x, pad=3)))
    outs = []
    for i, (_, k) in enumerate(UNET_DOWN, 2):
        if outs:
            x = _max_pool(x)
        x = torch.relu(conv_p(nx, P, f'encoder.down{i}', x, pad=k // 2))
        outs.append(x)
    return tuple(outs)


def encode(P: dict, cfg: dict, rgb: Tensor, cam2world: Tensor,
           nx: Numerics = F32) -> tuple[Tensor, ...]:
    """The feature pyramid of (B, V, H, W, 3) context images in [-1, 1]
    with (B, V, 4, 4) poses, each level (B*V, H/s, W/s, C) as
    :func:`pyramid_levels` lists them: for the DPT its H/4 and H/2 maps at
    fusion_features and the (B*V, H, W, 64) full-resolution conv map."""
    B, V, H, W, _ = rgb.shape
    model = encoder(cfg)
    mean = torch.tensor(IMAGENET_MEAN, device=rgb.device)
    std = torch.tensor(IMAGENET_STD, device=rgb.device)
    x = ((rgb.float() + 1.0) * 0.5 - mean) / std
    flat = x.reshape(B * V, H, W, 3)
    if model == 'resnet':
        return _resnet34(nx, P, flat)
    if model == 'unet':
        return _unet(nx, P, flat)
    return _dpt(nx, P, cfg, flat, cam2world, B, V)


# ---------------------------------------------------------------------------
# Geometry (f32): rays, epipolar segments, the points on the query ray
# ---------------------------------------------------------------------------

def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _normalize(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(
        1e-12)


def _finite(x, value):
    return torch.where(torch.isfinite(x), x, torch.full_like(x, value))


def _lift(x, y, z, K):
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    return torch.stack([(x - cx) / fx * z, (y - cy) / fy * z, z], dim=-1)


def _transform(pts, T):
    t = T[..., :3, :]
    return (pts[..., 0:1] * t[..., 0] + pts[..., 1:2] * t[..., 1]
            + pts[..., 2:3] * t[..., 2] + t[..., 3])


def _project(xyz, K):
    fx, fy = K[..., 0, 0, None], K[..., 1, 1, None]
    cx, cy = K[..., 0, 2, None], K[..., 1, 2, None]
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    out = torch.stack([fx * x / (z + 1e-12) + cx, fy * y / (z + 1e-12) + cy,
                       z], dim=-1)
    return _finite(out, 1e10)


def _to_ndc(xy, H, W):
    return torch.stack([xy[..., 0] / (W - 1) * 2 - 1,
                        xy[..., 1] / (H - 1) * 2 - 1], dim=-1)


def _to_pixel(xy, H, W):
    return torch.stack([(xy[..., 0] + 1) * 0.5 * (W - 1),
                        (xy[..., 1] + 1) * 0.5 * (H - 1)], dim=-1)


def _plucker(c2w, uv, K):
    """(direction, origin x direction) of the rays through pixels uv."""
    ones = torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)
    pts = _transform(_lift(uv[..., 0], uv[..., 1], ones, K),
                     c2w[..., None, :, :])
    origin = c2w[..., :3, 3]
    d = _normalize(pts - origin[..., None, :])
    return torch.cat([d, _cross(origin[..., None, :].expand_as(d), d)],
                     dim=-1)


def _in_bounds(xy, eps=1e-6):
    return ((xy >= -eps) & (xy <= 1.0 + eps)).all(dim=-1)


def _project_unit(xyz, K, eps=1e-8):
    return ((xyz / (xyz[..., -1:] + eps)) @ K.transpose(-1, -2))[..., :2]


def _border(K, o, d, dim, value):
    """The ray's crossing of the image border x (dim 0) or y (dim 1) =
    value: (t, xy, valid)."""
    other = 1 - dim
    fs, fo = K[..., None, dim, dim], K[..., None, other, other]
    cs, co = K[..., None, dim, 2], K[..., None, other, 2]
    os_, oo, ds, do = o[..., dim], o[..., other], d[..., dim], d[..., other]
    oz, dz = o[..., 2], d[..., 2]
    c = (value - cs) / fs
    t = (c * oz - os_) / (ds - c * dz)
    co_ = co + fo * (oo * (c * dz - ds) + do * (os_ - c * oz)) / (
        dz * os_ - ds * oz)
    same = torch.full_like(co_, value)
    xy = torch.stack([same, co_] if dim == 0 else [co_, same], dim=-1)
    xyz = o + t[..., None] * d
    return t, xy, _in_bounds(xy) & (xyz[..., -1] > -1e-6)


def _pick(cands, lowest):
    t = torch.stack([c[0] for c in cands])
    xy = torch.stack([c[1] for c in cands])
    ok = torch.stack([c[2] for c in cands])
    tm = torch.where(ok, t, torch.full_like(t, lowest))
    sel = (tm.argmin(0) if lowest > 0 else tm.argmax(0))[None]
    xy = torch.gather(xy, 0, sel[..., None].expand(1, *xy.shape[1:]))[0]
    return xy, torch.gather(ok, 0, sel)[0]


def epipolar_segments(origins, dirs, K_unit):
    """Clipped epipolar segments of rays (given in the camera's frame) in
    a camera with 0..1 intrinsics: (start, end) in ndc and the overlap
    flag, as upstream's ``get_epipolar_lines`` (models.py:238-258)."""
    K = K_unit[..., :3, :3]
    cands = [_border(K, origins, dirs, dim, v) for dim in (0, 1)
             for v in (0.0, 1.0)]
    xy_lo, ok_lo = _pick(cands, float('inf'))
    xy_hi, ok_hi = _pick(cands, float('-inf'))
    at_cam = torch.linalg.vector_norm(origins, dim=-1) < 1e-6
    behind = origins[..., -1] < 1e-6
    o_proj = torch.where(at_cam[..., None], dirs, origins)
    xy0 = _project_unit(o_proj, K)
    ok0 = (_in_bounds(xy0) & (o_proj[..., -1] > -1e-6)
           & ~(behind & ~at_cam))
    xyi = _project_unit(dirs, K)
    oki = _in_bounds(xyi) & (dirs[..., -1] > -1e-6)
    start = torch.where(ok0[..., None], xy0, xy_lo)
    end = torch.where(oki[..., None], xyi, xy_hi)
    valid = (ok0 | ok_lo) & (oki | ok_hi)
    start = _finite((start - 0.5) * 2.0, 0.0)
    end = _finite((end - 0.5) * 2.0, 0.0)
    return start, end, valid.float()


def _closest_points(q, c):
    """The point of line q closest to line c (Plücker lines)."""
    l1, m1, l2, m2 = q[..., :3], q[..., 3:], c[..., :3], c[..., 3:]
    n = _cross(l1, l2)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True).clamp_min(1e-12)
    nh = n / nn
    p1 = (-_cross(m1, _cross(l2, nh)) + (m2 * nh).sum(-1, keepdim=True) * l1
          ) / nn
    return _finite(p1, 0.0)


# ---------------------------------------------------------------------------
# Rendering
# ---------------------------------------------------------------------------

def _sample(nx, levels, coords, padding):
    """Bilinear samples (align_corners False) of every level of the
    pyramid at (N, S, 2) ndc coordinates: (N, S, sum C)."""
    grid = coords[:, :, None, :]
    out = [F.grid_sample(nx.q(fm).permute(0, 3, 1, 2), grid, mode='bilinear',
                         padding_mode=padding, align_corners=False)
           for fm in levels]
    return torch.cat([o[..., 0].permute(0, 2, 1) for o in out], dim=-1)


def _attend(nx, q, k, v):
    """Joint softmax over (view, sample) of each ray: (B, R, C) and the
    weights (B, V, R, P)."""
    B, V, R, P, _ = q.shape
    dots = (nx.q(q) * nx.q(k)).sum(-1) * ATTN_SCALE
    wt = torch.softmax(dots.permute(0, 2, 1, 3).reshape(B, R, V * P), -1)
    wt = wt.reshape(B, R, V, P).permute(0, 2, 1, 3)
    return torch.einsum('bvrp,bvrpc->brc', nx.q(wt), nx.q(v)), wt


def render(P: dict, cfg: dict, pyramid, scene: dict,
           nx: Numerics = F32) -> tuple[Tensor, Tensor]:
    """RGB (B, R, 3) and the valid mask (B, R) of the query rays of
    ``scene`` (the program's scene dict) from the pyramid of
    :func:`encode`."""
    ctx, qry = scene['context'], scene['query']
    B, V, H, W, _ = ctx['rgb'].shape
    Pn = cfg['n_samples']
    R = qry['uv'].shape[2]
    dev = ctx['rgb'].device
    c2w = ctx['cam2world'].float()
    Kc = ctx['intrinsics'].float()
    q2c = torch.linalg.inv(c2w) @ qry['cam2world'].float()   # (B, V, 4, 4)
    uv = qry['uv'][:, 0].float()[:, None].expand(B, V, R, 2)
    Kq = qry['intrinsics'].float().expand(B, V, 4, 4)
    rays = _plucker(q2c.reshape(B * V, 4, 4), uv.reshape(B * V, R, 2),
                    Kq.reshape(B * V, 4, 4))                 # (BV, R, 6)
    Kf = Kc.reshape(B * V, 4, 4)
    origins = q2c[..., :3, 3].reshape(B * V, 1, 3).expand(B * V, R, 3)
    d = rays[..., :3]
    K_unit = torch.cat([Kf[:, :2] / H, Kf[:, 2:]], dim=1)
    start, end, valid = epipolar_segments(origins, d, K_unit)
    t = torch.linspace(0.0, 1.0, Pn, device=dev)[:, None]
    pix = start[..., None, :] + (end - start)[..., None, :] * t  # (BV,R,P,2)

    # the sample's point on the query ray, in its context frame
    cam_pix = _to_pixel(pix, H, W).reshape(B * V, R * Pn, 2)
    eye = torch.eye(4, device=dev).expand(B * V, 4, 4)
    ctx_rays = _plucker(eye, cam_pix, Kf).reshape(B * V, R, Pn, 6)
    pt = _closest_points(rays[:, :, None].expand_as(ctx_rays), ctx_rays)
    pt = pt.reshape(B, V, R, Pn, 3)

    # the exchange: view k's maps at view v's samples, in frame k
    rel = torch.linalg.inv(c2w)[:, :, None] @ c2w[:, None]   # (B, K, V)
    pt_in = _finite(_transform(pt[:, None], rel[:, :, :, None, None]), 0.0)
    levels = [fm.reshape(B, V, *fm.shape[1:]) for fm in pyramid]

    def fuse(feat, points):
        t5 = torch.tanh(points / 5.0)
        h = torch.relu(kernel(nx, P, 'query_encode_latent', feat, t5))
        return kernel(nx, P, 'query_encode_latent_2', h)

    per_view = []
    for v in range(V):
        blocks = {}
        own = _sample(nx, [fm[:, v] for fm in levels],
                      pix.reshape(B, V, R * Pn, 2)[:, v], 'border')
        blocks[v] = fuse(own, pt_in[:, v, v].reshape(B, R * Pn, 3))
        for k in range(V):
            if k == v:
                continue
            proj = _project(pt_in[:, k, v].reshape(B, R * Pn, 3), Kc[:, k])
            xy = _to_ndc(proj[..., :2], H, W)
            feat = _sample(nx, [fm[:, k] for fm in levels], xy, 'zeros')
            blocks[k] = fuse(feat, pt_in[:, k, v].reshape(B, R * Pn, 3))
        # two views: the blocks in frame order; more: own view first
        order = [0, 1] if V == 2 else [v] + [k for k in range(V) if k != v]
        per_view.append(torch.cat([blocks[k] for k in order], dim=-1))
    interp = torch.stack(per_view, dim=1).reshape(B, V, R, Pn, -1)
    latent = kernel(nx, P, 'latent_value', interp)
    keys = kernel(nx, P, 'key_map_2',
                  torch.relu(kernel(nx, P, 'key_map', interp)))

    # per-sample query features (models.py:494-528)
    Kb = Kf[:, None]
    pxy = _to_pixel(pix, H, W)
    ones = torch.ones(pxy.shape[:-1], device=dev)
    cam_rays = _normalize(_lift(pxy[..., 0], pxy[..., 1], ones, Kb)
                          ).reshape(B, V, R, Pn, 3)
    q_orig = q2c[..., :3, 3]
    qo = q_orig[:, :, None, None, :].expand_as(cam_rays)
    depth = torch.linalg.vector_norm(pt - q_orig[:, :, None, None, :],
                                     dim=-1, keepdim=True)
    depth = _finite(depth, 1e6)
    local = torch.cat([cam_rays, torch.zeros_like(qo),
                       d.reshape(B, V, R, 1, 3).expand_as(cam_rays),
                       torch.tanh(depth), torch.tanh(depth / 10.0),
                       torch.tanh(depth / 100.0), torch.tanh(depth / 1000.0),
                       qo], dim=-1)

    # two rounds of joint attention (models.py:528-565)
    qe = kernel(nx, P, 'query_embed_2',
                torch.relu(kernel(nx, P, 'query_embed', local)))
    z1, _ = _attend(nx, qe, keys, latent)                      # (B, R, C)
    ze = kernel(nx, P, 'encode_latent', z1)                    # (B, R, 128)
    ze = ze[:, None, :, None, :].expand(B, V, R, Pn, HIDDEN)
    q2 = kernel(nx, P, 'query_repeat_embed_2',
                torch.relu(kernel(nx, P, 'query_repeat_embed', ze, local)))
    z2, _ = _attend(nx, q2, qe, latent)
    z = z2 + V * z1

    # phi (models.py:596-612) and the whiteout of rays no view sees
    coords = torch.cat([rays.reshape(B, V, R, 6),
                        q_orig[:, :, None, :].expand(B, V, R, 3)], dim=-1)
    coords = coords.permute(0, 2, 1, 3).reshape(B, R, V * 9)
    zz = z[:, :, None, :].expand(B, R, V, z.shape[-1]).reshape(B, R, -1)
    x = dense(nx, P, 'phi.lin_in', coords)
    for i in range(PHI_BLOCKS):
        x = x + dense(nx, P, f'phi.lin_z{i}', zz)
        x = x + dense(nx, P, f'phi.block{i}.fc_1', torch.relu(
            dense(nx, P, f'phi.block{i}.fc_0', torch.relu(x))))
    rgb = dense(nx, P, 'phi.lin_out', torch.relu(x))
    seen = valid.reshape(B, V, R).amax(dim=1)
    rgb = rgb * seen[..., None] + (1.0 - seen[..., None])
    return rgb, seen


def render_blocks(P, cfg, pyramid, scene, rays_per_block: int,
                  nx: Numerics = F32) -> tuple[Tensor, Tensor]:
    """:func:`render` over the query rays in blocks of
    ``rays_per_block``, so that the f32 reference fits beside what is
    kept: (B, R, 3) and (B, R)."""
    uv = scene['query']['uv']
    rgbs, seens = [], []
    for i in range(0, uv.shape[2], rays_per_block):
        s = dict(scene, query=dict(scene['query'],
                                   uv=uv[:, :, i:i + rays_per_block]))
        rgb, seen = render(P, cfg, pyramid, s, nx)
        rgbs.append(rgb)
        seens.append(seen)
    return torch.cat(rgbs, dim=1), torch.cat(seens, dim=1)


def image_loss(P, cfg, scene, nx: Numerics = F32) -> Tensor:
    """The stage-1 loss: the mean absolute error of the query rays' RGB
    (upstream loss_functions.py:74-80)."""
    ctx = scene['context']
    pyr = encode(P, cfg, ctx['rgb'], ctx['cam2world'], nx)
    rgb, _ = render(P, cfg, pyr, scene, nx)
    gt = torch.nan_to_num(scene['query']['rgb'][:, 0].float(), nan=0.0)
    return (gt - torch.nan_to_num(rgb, nan=0.0)).abs().mean()
