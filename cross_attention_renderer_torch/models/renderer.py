"""Cross-attention light-field renderer (the flagship model), any number of
context views.

Port of ``cross_attention_renderer_tpu/models/renderer.py``, every
encoder (``model``: the DPT hybrid, the ResNet34 taps or the U-Net down
path) and ablation flag of it (JAX renderer.py:94-109, after the
reference's models.py:43 and train_realestate10k.py:51-55), along these
branches (renderer.py:295-528):

* V=2, default: the fused exchange epilogue (kernel K2, renderer.py:354-361)
  and both attention rounds (kernel K1);
* V=2 with ``fused_render``: the fully fused render core (kernel K4,
  renderer.py:350-353, :458-467, :769-819), which runs the exchange and
  both attention rounds in one kernel;
* V=2 with ``fused_epilogue=False``: the unfused exchange
  (renderer.py:362-388, :857-883);
* V>=3, default: the multi-stream fused epilogue (kernel K3 with S = V
  streams, any count, renderer.py:389-401, :690-767);
* V>=3 with ``reference_exchange_compat`` or ``fused_epilogue=False``: the
  unfused exchange (renderer.py:402-434, :1056-1112), whose pyramid gathers
  run as kernel K7 or K8 under ``gather`` (ops/pallas_gather.py:163-184);
* ``sorted_stream``, at V>=2: both pyramid gathers on a sample stream
  sorted by image row, through kernel K5 (renderer.py:336-343, :402-408,
  :919-1054); it takes precedence over every fused branch;
* V=1, and any V under ``no_latent_concat``: no exchange. The pyramid's
  samples (with tanh-encoded points through ``update_val_merge`` at V=1)
  feed the latent and key projections (renderer.py:409-434).

With the ResNet34 and U-Net encoders the pyramid has four levels, and K2,
K3 and K4 take their 4-level mode, which computes the JAX package's
unfused exchange (``ops/gather_epilogue.py``, ROADMAP.md Queue C).

The unfused and sorted exchanges' fuse MLP runs as kernel K9 when
``fused_mlp`` is set (renderer.py:835-853).

Fast evaluation (``train/evaluation.py``) renders through the same paths:
``forward(t_vals=...)`` places each ray's samples on its segment,
``narrow_features`` narrows the pyramid the exchange gathers, and
:meth:`CrossAttentionRenderer.clone` gives the renderers a sibling of the
model on the same weights.

  1. ``encode``: DPT-hybrid multi-view encoder + full-res 7x7 conv branch
     -> feature pyramid z (models.py:148-188).
  2. Query rays -> Plücker coords in each context frame; epipolar segment
     per (ray, view) and ``npoints`` uniform samples; the 3D point on the
     query ray at each sample (models.py:213-283).
  3. Latent exchange: for the rays of view v, the self stream samples view
     v's maps on its segment; each cross stream samples another view k's
     maps at the sample's 3D point reprojected into frame k. Each stream's
     features pass the shared fuse MLP, and the per-view concatenation feeds
     the latent and key projections -> joint latent and key per sample
     (models.py:278-475,491,529).
  4. Two rounds of joint (view, sample) attention (kernel K1), the depth
     head and the ResnetFC decode with the valid-mask whiteout
     (models.py:487-617).

Scene dict layout (channel-last), as in the JAX package:
  context: rgb (B, V, H, W, 3) in [-1, 1]; cam2world (B, V, 4, 4);
           intrinsics (B, V, 4, 4) in pixel units.
  query:   cam2world (B, 1, 4, 4); intrinsics (B, 1, 4, 4);
           uv (B, 1, R, 2) in pixel units.
Geometry runs in f32; the network in ``dtype``.

Gradients: every kernel's gradients are its plain version's
(``ops/_autograd.py``). The JAX renderer's ``stop_gradient``s
(renderer.py:449, :649, :731, :831) act only on camera geometry, and no
camera input here ever requires a gradient, so the port needs no
``detach`` in their place.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence

import torch
from torch import nn

from cross_attention_renderer_torch.encoders.dpt import DPTHybridEncoder
from cross_attention_renderer_torch.encoders.spatial import SpatialEncoder
from cross_attention_renderer_torch.encoders.unet import UNetEncoder
from cross_attention_renderer_torch.geometry import epipolar as E
from cross_attention_renderer_torch.geometry import rays as G
from cross_attention_renderer_torch.layers import (Conv, Dense,
                                                   gather_from_group,
                                                   init_parameters,
                                                   lecun_normal_,
                                                   parallel_product)
from cross_attention_renderer_torch.models.resnet_fc import ResnetFC
from cross_attention_renderer_torch.ops.epipolar_attention import (
    epipolar_attention, epipolar_attention_reference)
from cross_attention_renderer_torch.ops.fused_mlp import fused_mlp2
from cross_attention_renderer_torch.ops.fused_render import fused_render_core
from cross_attention_renderer_torch.ops.gather_epilogue import (
    fused_exchange_epilogue, fused_exchange_epilogue_multi)
from cross_attention_renderer_torch.ops.grid_sample import (
    grid_sample_pyramid, grid_sample_pyramid_packed, pack_pyramid)
from cross_attention_renderer_torch.ops.pallas_gather import GATHERS
from cross_attention_renderer_torch.ops.sorted_gather import (
    grid_sample_pyramid_sorted, grid_sample_sorted, sort_stream, unsort)
from cross_attention_renderer_torch.ops.stream_takes import (
    exchange_points, stream_takes)
from cross_attention_renderer_torch.parallel.mesh import param_spec, sharded_dim
from cross_attention_renderer_torch.utils.image import normalize_imagenet
from cross_attention_renderer_torch.utils.profiling import span

Tensor = torch.Tensor

HIDDEN_DIM = 128          # attention hidden width (models.py:114)
# The encoders (``model``): pyramid width and levels (JAX renderer.py:
# 156-170; encoders/spatial.py:5-7, encoders/unet.py:4-6). The DPT
# pyramid's width is 2 * fusion_features + 64.
ENCODERS = {'midas_vit': (None, 3), 'resnet': (512, 4), 'unet': (960, 4)}
QUERY_FEAT_DIM = 16       # cam_rays 3 + zeros 3 + ray_dir 3 + depth 4
                          # + query origin 3 (models.py:528)


class SplitDense(nn.Module):
    """Dense layer over an input given as channel segments.

    ``SplitDense(f, d)(a, b)`` is ``Dense(f)(cat([a, b]))`` computed by
    slicing the kernel, so the wide concatenation never exists. The kernel
    keeps the JAX (d_in, features) layout whole; the fused epilogue reads
    it directly. Under tensor parallelism (``tp``, ``layers.py``) the
    kernel is this rank's slice: of its columns in a column-parallel layer
    (and of the bias), of its rows in a row-parallel one."""

    def __init__(self, d_in: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype
        self.tp = None

    def reset_parameters(self, g: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], g)
        nn.init.zeros_(self.bias)

    def forward(self, *parts: Tensor) -> Tensor:
        if sum(p.shape[-1] for p in parts) != self.kernel.shape[0]:
            raise ValueError(f'SplitDense: inputs {[p.shape for p in parts]}'
                             f' do not sum to {self.kernel.shape[0]}')
        k = self.kernel.to(self.dtype)

        def product(*parts):
            out, off = None, 0
            for p in parts:
                w = k[off:off + p.shape[-1]]
                off += p.shape[-1]
                t = p.to(self.dtype) @ w
                out = t if out is None else out + t
            return out

        if self.tp is not None:
            return parallel_product(self.tp, product, parts,
                                    self.bias.to(self.dtype))
        return product(*parts) + self.bias.to(self.dtype)


class CrossAttentionRenderer(nn.Module):
    """The flagship renderer at any number of context views (see the module
    docstring).

    Sizes default to the reference configuration (the 122M DPT-hybrid);
    smaller encoder settings keep the architecture for CPU tests. The
    parameters are drawn from ``seed`` (Flax's initialisers, see
    :func:`~cross_attention_renderer_torch.layers.init_parameters`) and
    placed on ``device``.

    Args:
      n_view: context views, any count from 1.
      npoints: epipolar samples per view; 0 takes the reference's default,
        64 at V <= 2 and 48 above (models.py:47-54).
      model: the encoder, ``'midas_vit'`` (the DPT hybrid and the 7x7
        full-resolution conv, a 3-level pyramid 2 * fusion_features + 64
        wide), ``'resnet'`` (the ResNet34 taps, 4 levels, 512 wide) or
        ``'unet'`` (the U-Net down path, 4 levels, 960 wide).
      no_sample: sample ``n_samples`` depths, linear in [0.1, 10], along
        each query ray (``geometry.epipolar.volumetric_epipolar_lines``) in
        place of the epipolar segment; refuses ``t_vals``.
      no_latent_concat: no latent exchange: each view's samples feed the
        latent and key projections at the pyramid's full width.
      no_multiview: the DPT encoder sees zero relative poses.
      no_high_freq: the DPT pyramid's full-resolution conv level is zeros.
      fused_attention: run both attention rounds as kernel K1. ``None``
        (the default) and ``True`` take the kernel on the card and its
        plain version on the CPU; ``False`` takes the plain version
        everywhere (the JAX ``fused_attention``; the trainer's clone sets
        it, ``train/trainer.py:_train_model``).
      fused_epilogue: take the fused exchange epilogue (K2 at V=2, K3 at
        V>=3); ``None`` (the default) as ``True``, which on the CPU
        runs the epilogue's plain version. ``False`` takes the unfused
        exchange (the JAX ``fused_epilogue``; the trainer's clone sets it).
      reference_exchange_compat: reproduce the reference's 3-view exchange
        index swap (DEVIATIONS.md), which the fused V=3 epilogue does not
        implement: at V=3 it implies the unfused exchange. No effect at V=2.
      fused_mlp: run the unfused exchange's fuse MLP as kernel K9 (the JAX
        package's ``CAR_FUSED_MLP`` switch).
      fused_render: at V=2, run the exchange and both attention rounds as
        the fully fused render core K4 (the JAX package's
        ``CAR_FUSED_RENDER`` switch); it takes precedence over
        ``fused_epilogue``. V=2 with the latent exchange only.
      repeat_attention: run the second attention round, queried by the
        first round's output (models.py:547-565). Without it the model has
        no ``encode_latent`` and ``query_repeat_embed(_2)``, as the JAX
        parameter tree has none.
      sorted_stream: sample both pyramid gathers on a stream sorted by
        image row through K5 (the JAX ``sorted_stream=True``; its auto mode
        resolves to False). It takes precedence over ``fused_render`` and
        ``fused_epilogue``, and runs both attention rounds as K1.
      gather: the pyramid gather of the unfused V=3 exchange: ``'take'``
        (the packed-cell take path), ``'onehot'`` (K7, the JAX
        ``CAR_PALLAS_GATHER`` switch) or ``'banded'`` (K8 on levels whose
        bf16 table is at most 4 MiB, else the take path; the JAX
        ``CAR_BANDED_GATHER`` switch).
      remat: recompute each ViT block in the backward pass
        (``torch.utils.checkpoint``; the JAX ``remat``): less activation
        memory for a second forward of the blocks.
      narrow_features: the widths of the pyramid's levels as the
        exchange gathers them, after a per-scene projection
        (``train/evaluation.py:narrow_pyramid``); only
        ``query_encode_latent`` changes, to ``sum(narrow_features) + 3``
        input rows (JAX renderer.py:139, :193-199). ``None``: the full
        widths. Only with the latent exchange, which alone reads them.
    """

    def __init__(self, n_view: int = 2, npoints: int = 0,
                 model: str = 'midas_vit', no_sample: bool = False,
                 no_latent_concat: bool = False, no_multiview: bool = False,
                 no_high_freq: bool = False,
                 fusion_features: int = 256, vit_width: int = 768,
                 vit_depth: int = 12, vit_heads: int = 12,
                 resnet_layers: tuple[int, int, int] = (3, 4, 9),
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device='cuda', fused_attention: Optional[bool] = None,
                 fused_epilogue: Optional[bool] = None,
                 reference_exchange_compat: bool = False,
                 fused_mlp: bool = False, fused_render: bool = False,
                 repeat_attention: bool = True, sorted_stream: bool = False,
                 gather: str = 'take', remat: bool = False,
                 narrow_features: Optional[Sequence[int]] = None):
        super().__init__()
        if n_view < 1:
            raise ValueError(f'n_view must be at least 1, got {n_view}')
        if model not in ENCODERS:
            raise ValueError(f'model must be one of {tuple(ENCODERS)}, got '
                             f'{model!r}')
        multiview = n_view > 1 and not no_latent_concat
        if fused_render and not (multiview and n_view == 2):
            raise ValueError('the fused render core renders 2 context '
                             f'views with the latent exchange, got n_view='
                             f'{n_view}, no_latent_concat={no_latent_concat}')
        if gather not in GATHERS:
            raise ValueError(f'gather must be one of {GATHERS}, got '
                             f'{gather!r}')
        base, n_levels = ENCODERS[model]
        base = base or 2 * fusion_features + 64
        if narrow_features and (not multiview
                                or len(narrow_features) != n_levels):
            raise ValueError(
                f'narrow_features {tuple(narrow_features)}: one width a '
                f'pyramid level ({n_levels} for {model!r}), and only with '
                'the latent exchange (n_view > 1, no no_latent_concat)')
        self.n_view = n_view
        self.n_samples = npoints or (64 if n_view <= 2 else 48)
        self.model = model
        self.no_sample = no_sample
        self.no_latent_concat = no_latent_concat
        self.no_multiview = no_multiview
        self.no_high_freq = no_high_freq
        self.multiview = multiview
        self.dtype = dtype
        self.fused_attention = fused_attention
        self.fused_epilogue = fused_epilogue
        self.reference_exchange_compat = reference_exchange_compat
        self.fused_mlp = fused_mlp
        self.fused_render = fused_render
        self.repeat_attention = repeat_attention
        self.sorted_stream = sorted_stream
        self.gather = gather
        self.narrow_features = (tuple(narrow_features) if narrow_features
                                else None)
        if model == 'midas_vit':
            self.encoder = DPTHybridEncoder(
                features=fusion_features, vit_width=vit_width,
                vit_depth=vit_depth, vit_heads=vit_heads,
                resnet_layers=resnet_layers, dtype=dtype, remat=remat)
            self.conv_map = Conv(3, 64, 7, padding=3, dtype=dtype)
        elif model == 'resnet':
            self.encoder = SpatialEncoder(dtype)
        else:
            self.encoder = UNetEncoder(dtype)

        # The latent width halves where the V views' latents are
        # concatenated (JAX renderer.py:166-170): 288 at the flagship.
        ld = base // 2 if multiview else base
        self.latent_dim = ld
        d_interp = ld * n_view if multiview else base
        if multiview:
            d_feat = sum(self.narrow_features) if narrow_features else base
            self.query_encode_latent = SplitDense(d_feat + 3, base, dtype)
            self.query_encode_latent_2 = SplitDense(base, ld, dtype)
        elif not no_latent_concat:
            # V=1: the samples with tanh(pt/5), tanh(pt/100) (models.py:
            # 479-485)
            self.update_val_merge = Dense(base + 6, ld, dtype=dtype)
        self.latent_value = SplitDense(d_interp, ld, dtype)
        self.key_map = SplitDense(d_interp, HIDDEN_DIM, dtype)
        self.key_map_2 = SplitDense(HIDDEN_DIM, HIDDEN_DIM, dtype)
        self.query_embed = SplitDense(QUERY_FEAT_DIM, HIDDEN_DIM, dtype)
        self.query_embed_2 = SplitDense(HIDDEN_DIM, HIDDEN_DIM, dtype)
        if repeat_attention:
            self.encode_latent = SplitDense(ld, HIDDEN_DIM, dtype)
            self.query_repeat_embed = SplitDense(HIDDEN_DIM + QUERY_FEAT_DIM,
                                                 HIDDEN_DIM, dtype)
            self.query_repeat_embed_2 = SplitDense(HIDDEN_DIM, HIDDEN_DIM,
                                                   dtype)
        self.phi = ResnetFC(d_in=n_view * 9, d_latent=ld * n_view, d_out=3,
                            n_blocks=3, d_hidden=128, dtype=dtype)
        init_parameters(self, seed)
        self.to(device)

    # ------------------------------------------------------------------
    def encode(self, scene: dict) -> tuple[Tensor, ...]:
        """Feature pyramid, channel-last, (B * V, ...) each level
        (renderer.py:232-251): (path2, path1, z_conv) of the DPT encoder,
        whose poses are zeros under ``no_multiview`` and z_conv zeros under
        ``no_high_freq``; the ResNet34 or U-Net encoder's four maps. Under
        the ``car.encode`` span."""
        with span('car.encode'):
            ctx = scene['context']
            rgb = ctx['rgb'].float()
            B, V, H, W, _ = rgb.shape
            rgb_norm = normalize_imagenet((rgb + 1.0) * 0.5).to(self.dtype)
            if self.model != 'midas_vit':
                return tuple(self.encoder(rgb_norm.reshape(B * V, H, W, 3)))
            c2w = ctx['cam2world'].float()
            rel16 = (torch.linalg.inv(c2w[:, 0])[:, None] @ c2w).reshape(
                B, V, 16)
            if self.no_multiview:
                rel16 = torch.zeros_like(rel16)
            path2, path1 = self.encoder(rgb_norm, rel16)
            z_conv = self.conv_map(rgb_norm.reshape(B * V, H, W, 3))
            if self.no_high_freq:
                z_conv = torch.zeros_like(z_conv)
            return path2, path1, z_conv

    @property
    def use_fused_epilogue(self) -> bool:
        """Whether the exchange takes the fused epilogue (``fused_epilogue``
        ``None`` or ``True``)."""
        return self.fused_epilogue is not False

    @property
    def uses_packed_tables(self) -> bool:
        """Whether a render reads the pyramid's packed cell tables: every
        V=2 exchange and the V>=3 take paths do; the sorted stream, the
        V>=3 exchange under the K7 or K8 gather, and the paths without an
        exchange (V=1, ``no_latent_concat``) do not (JAX ``uses_packed``,
        evaluation.py:93-95)."""
        if self.sorted_stream or not self.multiview:
            return False
        fused_v3 = (self.use_fused_epilogue
                    and not self.reference_exchange_compat)
        return self.n_view == 2 or fused_v3 or self.gather == 'take'

    def clone(self, repeat_attention: Optional[bool] = None,
              fuse_kernel: Optional[Tensor] = None,
              narrow_features: Optional[Sequence[int]] = None,
              npoints: Optional[int] = None) -> 'CrossAttentionRenderer':
        """A sibling of the model that shares every parameter tensor with
        it (the JAX ``model.clone``, for the fast-eval renderers). Neither
        the model nor a weight is copied or changed.

        Args:
          repeat_attention: ``False`` gives a sibling without the second
            attention round (its modules stay, unused).
          fuse_kernel: ``query_encode_latent``'s kernel in the sibling,
            (d + 3, pyramid width) for gathered widths d: a per-scene fold
            (``narrow_pyramid``, ``quantize_pyramid``); its bias stays
            shared.
          narrow_features: the gathered widths ``fuse_kernel`` is for
            (default: the model's).
          npoints: epipolar samples a view in the sibling (0 takes the
            default of the constructor's ``npoints``); no parameter
            depends on it.
        """
        if ((narrow_features is not None or fuse_kernel is not None)
                and not self.multiview):
            raise ValueError('a fuse_kernel or narrow_features needs the '
                             'latent exchange, whose fuse layer alone '
                             'reads the pyramid')
        c = copy.copy(self)
        c._parameters = dict(self._parameters)
        c._buffers = dict(self._buffers)
        c._modules = dict(self._modules)
        if npoints is not None:
            c.n_samples = npoints or (64 if self.n_view <= 2 else 48)
        if repeat_attention is not None:
            if repeat_attention and not self.repeat_attention:
                raise ValueError('the model has no round-2 modules to '
                                 'repeat the attention with')
            c.repeat_attention = repeat_attention
        if narrow_features is not None or fuse_kernel is not None:
            widths = (tuple(narrow_features) if narrow_features is not None
                      else self.narrow_features)
            base = self.query_encode_latent.kernel.shape[1]
            rows = (sum(widths) if widths else base) + 3
            if fuse_kernel is None or tuple(fuse_kernel.shape) != (rows,
                                                                   base):
                got = (None if fuse_kernel is None
                       else tuple(fuse_kernel.shape))
                raise ValueError(
                    f'narrow_features {widths} need a fuse_kernel of shape '
                    f'{(rows, base)}, got {got}')
            qel = copy.copy(self.query_encode_latent)
            qel._parameters = dict(qel._parameters)
            qel._parameters.pop('kernel', None)
            qel.kernel = fuse_kernel
            c._modules['query_encode_latent'] = qel
            c.narrow_features = widths
        return c

    # ------------------------------------------------------------------
    def forward(self, scene: dict, z: Optional[Sequence[Tensor]] = None,
                z_packed: Optional[Sequence[Tensor]] = None,
                t_vals: Optional[Tensor] = None) -> dict:
        """Renders the query rays. ``z`` is the pyramid from :meth:`encode`
        (computed when absent); ``z_packed`` its cell tables, which callers
        rendering many ray blocks build once per image (ignored where the
        render reads no packed table, see :attr:`uses_packed_tables`).
        ``t_vals`` (B, V, R, P): each ray's sample positions on its
        epipolar segment, in [0, 1], in place of ``n_samples`` uniform ones
        (the pruned renderer's fine pass; JAX renderer.py:256-322); refused
        under ``no_sample``, which has no segment."""
        ctx, qry = scene['context'], scene['query']
        B, V, H, W, _ = ctx['rgb'].shape
        if V != self.n_view:
            raise ValueError(f'the model was built for {self.n_view} '
                             f'context views, the scene has {V}')
        R = qry['uv'].shape[2]
        P = t_vals.shape[-1] if t_vals is not None else self.n_samples
        if t_vals is not None and tuple(t_vals.shape) != (B, V, R, P):
            raise ValueError(f't_vals must be (B, V, R, P) = '
                             f'{(B, V, R, P)}, got {tuple(t_vals.shape)}')
        if t_vals is not None and self.no_sample:
            raise ValueError('t_vals is not supported with no_sample '
                             '(uniform-depth ablation has no segment '
                             'parametrization)')
        dev = ctx['rgb'].device
        if z is None:
            z = self.encode(scene)
        zp = None
        if self.uses_packed_tables:
            if z_packed is not None:
                zp = tuple(z_packed)
            else:
                with span('car.pack_pyramid'):
                    zp = pack_pyramid(z)

        with span('car.geometry'):
            # Everything happens in each context camera's frame.
            ctx_c2w = ctx['cam2world'].float()
            ctx_intr_v = ctx['intrinsics'].float()
            qry_c2w = qry['cam2world'].float()
            query_cam2world = torch.linalg.inv(ctx_c2w) @ qry_c2w  # (B,V,4,4)

            uv = qry['uv'][:, 0].float()[:, None].expand(B, V, R, 2)
            q_intr = qry['intrinsics'].float().expand(B, V, 4, 4)
            lf_coords = G.plucker_embedding(
                query_cam2world.reshape(B * V, 4, 4), uv.reshape(B * V, R, 2),
                q_intr.reshape(B * V, 4, 4))               # (B*V, R, 6)
            ctx_intr = ctx_intr_v.reshape(B * V, 4, 4)
            origins = G.ray_origin(query_cam2world).reshape(
                B * V, 1, 3).expand(B * V, R, 3)
            ray_dir = lf_coords[..., :3]

            if self.no_sample:
                # Fixed depths along the query ray (renderer.py:295-306).
                _, _, valid, pixel_val = E.volumetric_epipolar_lines(
                    lf_coords.reshape(B, V, R, 6), query_cam2world,
                    ctx_intr_v, H, W, P)
                valid = valid.reshape(B * V, R)
                pixel_val = pixel_val.reshape(B * V, R, P, 2)
            else:
                # Segment intrinsics are divided by H, not (W, H)
                # (models.py:226).
                intr_norm = torch.cat([ctx_intr[:, :2] / H, ctx_intr[:, 2:]],
                                      dim=1)
                start, end, valid = E.epipolar_segments_ndc(origins, ray_dir,
                                                            intr_norm)
                if t_vals is not None:
                    interval = t_vals.reshape(B * V, R, P).to(start.dtype)[
                        ..., None]
                else:
                    interval = torch.linspace(0.0, 1.0, P, dtype=start.dtype,
                                              device=dev)[:, None]
                pixel_val = (start[..., None, :] + (end - start)[..., None, :]
                             * interval)                   # (B*V, R, P, 2)

            eye = torch.eye(4, device=dev).expand(B * V, 4, 4)
            pt, _, _ = G.epipolar_point_3d(lf_coords, pixel_val, eye, H, W,
                                           ctx_intr)
            pt_views = pt.reshape(B, V, R, P, 3)

        geo = (zp, pixel_val, pt_views, ctx_c2w, ctx_intr_v, H, W)
        # The sorted stream takes precedence over every fused branch, so K4
        # runs only without it (renderer.py:334-353, :458). Without the
        # latent exchange neither applies (renderer.py:333-334).
        sorted_stream = self.multiview and self.sorted_stream
        fused_render = self.fused_render and not sorted_stream
        with span('car.exchange'):
            if sorted_stream and V == 2:
                joint_latent, key_val = self._sorted_exchange_v2(z, *geo[1:])
            elif fused_render:
                # K4 runs the exchange with the attention rounds once
                # local_coords exist; its stream takes are made here.
                takes = self._stream_takes(*geo)
                joint_latent = key_val = None
            elif self.multiview and V == 2 and self.use_fused_epilogue:
                joint_latent, key_val = self._fused_exchange_v2(*geo)
            elif self.multiview and V == 2:
                # [self, cross] for view 0, [cross, self] for view 1
                # (models.py:335,342), by slicing the kernels.
                fs, fc = self._latent_exchange_parts(*geo)
                joint_latent = torch.stack(
                    [self.latent_value(fs[:, 0], fc[:, 0]),
                     self.latent_value(fc[:, 1], fs[:, 1])], dim=1)
                kh = torch.stack(
                    [torch.relu(self.key_map(fs[:, 0], fc[:, 0])),
                     torch.relu(self.key_map(fc[:, 1], fs[:, 1]))], dim=1)
                key_val = self.key_map_2(kh)
            elif (self.multiview and self.use_fused_epilogue
                  and not self.reference_exchange_compat
                  and not sorted_stream):
                joint_latent, key_val = self._fused_exchange_multi(*geo)
            else:
                if sorted_stream:
                    interp_val = self._latent_exchange_sorted(z, *geo[1:])
                else:
                    interp_val = self._sample_pyramid(
                        z, zp, pixel_val.reshape(B * V, R * P, 2),
                        'border').reshape(B, V, R, P, -1)
                    if self.multiview:
                        interp_val = self._latent_exchange(
                            interp_val, z, zp, pt_views, ctx_c2w, ctx_intr_v,
                            H, W)
                    elif not self.no_latent_concat:
                        # V=1: append the tanh-encoded point (models.py:
                        # 479-485).
                        pt_feat = torch.cat([torch.tanh(pt_views / 5.0),
                                             torch.tanh(pt_views / 100.0)],
                                            dim=-1)
                        interp_val = self.update_val_merge(
                            torch.cat([interp_val, pt_feat], dim=-1))
                joint_latent = self.latent_value(interp_val)
                key_val = self.key_map_2(torch.relu(self.key_map(
                    interp_val)))

        with span('car.geometry'):
            # Per-sample query features (models.py:494-528).
            cam_rays = G.ray_directions_cam(pixel_val, ctx_intr[:, None], H,
                                            W).reshape(B, V, R, P, 3)
            ray_dir_e = ray_dir.reshape(B, V, R, 1, 3).expand_as(cam_rays)
            q_orig = G.ray_origin(query_cam2world)         # (B, V, 3)
            q_orig_e = q_orig[:, :, None, None, :].expand_as(cam_rays)
            depth = torch.linalg.vector_norm(
                pt_views - q_orig[:, :, None, None, :], dim=-1, keepdim=True)
            depth = torch.where(torch.isfinite(depth), depth,
                                torch.full_like(depth, 1e6))
            depth_encode = torch.cat(
                [torch.tanh(depth), torch.tanh(depth / 10.0),
                 torch.tanh(depth / 100.0), torch.tanh(depth / 1000.0)],
                dim=-1)
            local_coords = torch.cat(
                [cam_rays, torch.zeros_like(q_orig_e), ray_dir_e,
                 depth_encode, q_orig_e], dim=-1)          # (B,V,R,P,16)

        with span('car.attention'):
            if fused_render:
                z_final, at_wt = self._fused_render_v2(zp, takes,
                                                       local_coords, B, R, P)
                z_local = z_final[:, None].expand(B, V, R, z_final.shape[-1])
            else:
                z_local, at_wt = self._attention_rounds(
                    local_coords, key_val, joint_latent)

        with span('car.geometry'):
            # Attention-derived depth from the round-1 weights (models.py:
            # 573-594).
            pt_clamp = pt_views.clamp(-100.0, 100.0)
            world_point = (at_wt[..., None] * pt_clamp).sum(dim=3).sum(dim=1)
            cam_point = G.points_to_cam(world_point, qry_c2w[:, 0][:, None])
            depth_ray = cam_point[..., 2].clamp(0.0, 10.0)[..., None]

        with span('car.phi'):
            # Light-field decode (models.py:596-612) and whiteout (:615-617).
            coords9 = torch.cat(
                [lf_coords.reshape(B, V, R, 6),
                 q_orig[:, :, None, :].expand(B, V, R, 3)], dim=-1)
            coords_flat = coords9.permute(0, 2, 1, 3).reshape(B, R, V * 9)
            z_flat = z_local.permute(0, 2, 1, 3).reshape(B, R, -1)
            rgb = self.phi(torch.cat([z_flat.float(), coords_flat], dim=-1))
            valid_any = valid.reshape(B, V, R).amax(dim=1)[..., None]
            rgb = rgb * valid_any + (1.0 - valid_any)
        return {'rgb': rgb.reshape(B, 1, R, 3), 'depth_ray': depth_ray,
                'valid_mask': valid_any, 'at_wt': at_wt,
                'pixel_val': pixel_val.reshape(B, V, R, P, 2)}

    def _attend(self, query: Tensor, key: Tensor, value: Tensor
                ) -> tuple[Tensor, Tensor]:
        """Joint (view, sample) attention: K1, or its plain version under
        ``fused_attention=False`` (JAX ``_attend``)."""
        if self.fused_attention is False:
            return epipolar_attention_reference(query, key, value)
        return epipolar_attention(query, key, value)

    def _attention_rounds(self, local_coords: Tensor, key_val: Tensor,
                          joint_latent: Tensor) -> tuple[Tensor, Tensor]:
        """The query MLP and the attention rounds (K1) on the exchange's
        outputs (models.py:528-565). Returns (z_local (B, V, R, ld), the
        round-1 weights (B, V, R, P))."""
        B, V, R, P, _ = joint_latent.shape
        coords_embed = self.query_embed_2(torch.relu(
            self.query_embed(local_coords)))
        # Round 1 over the joint (view, sample) axis (models.py:532-541).
        z_sum, at_wt = self._attend(coords_embed, key_val, joint_latent)
        z_local = z_sum[:, None].expand(B, V, R, z_sum.shape[-1])
        if not self.repeat_attention:
            return z_local, at_wt
        # Round 2, queried by the round-1 latent (models.py:547-565); the
        # result is sum_v z2 + V * z_sum, as round-1 z_local is already the
        # view-broadcast sum.
        z_embed = self.encode_latent(z_local)              # (B, V, R, 128)
        z_embed_local = z_embed[:, :, :, None, :].expand(B, V, R, P,
                                                         HIDDEN_DIM)
        query_embed_local = self.query_repeat_embed_2(torch.relu(
            self.query_repeat_embed(z_embed_local,
                                    local_coords.to(self.dtype))))
        z_sum2, _ = self._attend(query_embed_local, coords_embed,
                                 joint_latent)
        return ((z_sum2 + V * z_sum)[:, None].expand(B, V, R,
                                                      z_sum.shape[-1]),
                at_wt)

    # ------------------------------------------------------------------
    def _exchange_points(self, pt_views: Tensor, ctx_c2w: Tensor) -> Tensor:
        """pt_in[:, k, v]: view-v samples expressed in frame k
        (renderer.py:885-892; ``ops/stream_takes.py:exchange_points``)."""
        return exchange_points(pt_views, ctx_c2w)

    def _stream_takes(self, zp, pixel_val, pt_views, ctx_c2w, ctx_intr, H,
                      W) -> tuple[tuple[Tensor, ...], list[Tensor]]:
        """Cell rows and aux arrays of the V exchange streams
        (renderer.py:591-655 at V=2, :710-754 at V>=3), in the layout of
        ``ops/stream_takes.py``: per-level (V*M,) int32 cells,
        stream-major, and V aux arrays in the model type. One kernel
        launch on the card; on the CPU the plain version, on
        :meth:`_exchange_points`. Under the ``car.address_math`` span."""
        with span('car.address_math'):
            return stream_takes(tuple(t.shape[1:3] for t in zp), pixel_val,
                                pt_views, ctx_c2w, ctx_intr, H, W,
                                self.dtype, self._exchange_points)

    def _whole(self, name: str, attr: str) -> Tensor:
        """Parameter ``attr`` of layer ``name`` whole, for a kernel that
        reads whole weights (K2, K3, K4, K9): the parameter itself, or,
        where the layer holds a tensor-parallel slice of it
        (``train/trainer.py:shard_state``), the slices gathered over the
        model group (``layers.gather_from_group``: each rank keeps its
        slice of the gradient), as XLA hands the JAX package's Pallas
        kernels whole weights under any mesh."""
        layer = getattr(self, name)
        t = getattr(layer, attr)
        if layer.tp is None:
            return t
        dim = sharded_dim(param_spec(f'{name}.{attr}', t))
        return t if dim is None else gather_from_group(t, layer.tp[1], dim)

    def _epilogue_weights(self) -> tuple[Tensor, ...]:
        """The fused epilogues' ten parameters, whole (:meth:`_whole`;
        kernels in (in, out) layout, biases). K2, K3 and K4 lay them out
        once per set of tensors (``prepared_weights``: under tensor
        parallelism the gathered ones, so once a forward); their plain
        versions cast them to the rows' type."""
        return tuple(self._whole(name, attr) for name in (
            'query_encode_latent', 'query_encode_latent_2', 'latent_value',
            'key_map', 'key_map_2') for attr in ('kernel', 'bias'))

    def _fused_exchange_v2(self, zp, pixel_val, pt_views, ctx_c2w, ctx_intr,
                           H, W) -> tuple[Tensor, Tensor]:
        """V=2 exchange through the fused epilogue (renderer.py:657-688).
        Returns (joint_latent, key_val) as (B, V, R, P, ·)."""
        B, V, R, P, _ = pt_views.shape
        cells, (aux_self, aux_cross) = self._stream_takes(
            zp, pixel_val, pt_views, ctx_c2w, ctx_intr, H, W)
        jl, kv = fused_exchange_epilogue(zp, cells, aux_self, aux_cross,
                                         self._epilogue_weights(), R * P)
        return (jl.reshape(B, V, R, P, self.latent_dim),
                kv.reshape(B, V, R, P, HIDDEN_DIM))

    def _fused_render_v2(self, zp, takes, local_coords: Tensor, B: int,
                         R: int, P: int) -> tuple[Tensor, Tensor]:
        """V=2 exchange -> both attention rounds, one kernel K4
        (renderer.py:769-819) on the stream takes of :meth:`_stream_takes`:
        everything :meth:`_fused_exchange_v2` does after them plus the
        query MLP, round 1 and, with ``repeat_attention``,
        ``encode_latent``, the repeat-query MLP and round 2 (models.py:
        278-565). Returns (z_final (B, R, ld), at_wt (B, V, R, P))."""
        cells, (aux_self, aux_cross) = takes
        # The parameters themselves (K4 lays them out once per set, as K2
        # does; its plain version casts them to the rows' type). Without
        # repeat attention no round-2 module exists and none is passed.
        modules = [self.query_embed, self.query_embed_2]
        if self.repeat_attention:
            modules += [self.encode_latent, self.query_repeat_embed,
                        self.query_repeat_embed_2]
        params = self._epilogue_weights() + tuple(
            t for m in modules for t in (m.kernel, m.bias))
        lc = local_coords.reshape(-1, QUERY_FEAT_DIM).to(self.dtype
                                                          ).contiguous()
        return fused_render_core(zp, cells, aux_self, aux_cross, lc, params,
                                 B, R, P, self.repeat_attention)

    def _fused_exchange_multi(self, zp, pixel_val, pt_views, ctx_c2w,
                              ctx_intr, H, W) -> tuple[Tensor, Tensor]:
        """V>=3 exchange through the multi-stream fused epilogue
        (renderer.py:690-767): the fixed [self, cross_0, ...] order of the
        streams equals the reference's [self] + ascending-k concat.
        Returns (joint_latent, key_val) as (B, V, R, P, ·)."""
        B, V, R, P, _ = pt_views.shape
        cells, aux = self._stream_takes(zp, pixel_val, pt_views, ctx_c2w,
                                        ctx_intr, H, W)
        jl, kv = fused_exchange_epilogue_multi(zp, cells, tuple(aux),
                                               self._epilogue_weights())
        return (jl.reshape(B, V, R, P, self.latent_dim),
                kv.reshape(B, V, R, P, HIDDEN_DIM))

    # ------------------------------------------------------------------
    def _fuse_latent(self, feat: Tensor, points: Tensor) -> Tensor:
        """Shared 2-layer exchange encoder on ``[feat | tanh(pt/5)]``
        (renderer.py:821-855, models.py:335-346); kernel K9 when
        ``fused_mlp`` is set, handed the parameters themselves (W1's two
        row blocks as views of its kernel), which it lays out once."""
        t = torch.tanh(points / 5.0).to(feat.dtype)
        qel, qel2 = self.query_encode_latent, self.query_encode_latent_2
        if self.fused_mlp:
            c1 = feat.shape[-1]
            w1, b1, w2, b2 = (self._whole(name, attr) for name in (
                'query_encode_latent', 'query_encode_latent_2')
                for attr in ('kernel', 'bias'))
            out = fused_mlp2(
                feat.reshape(-1, c1).to(self.dtype).contiguous(),
                t.reshape(-1, t.shape[-1]).contiguous(), w1[:c1], w1[c1:],
                b1, w2, b2)
            return out.reshape(*feat.shape[:-1], out.shape[-1])
        return qel2(torch.relu(qel(feat, t)))

    def _latent_exchange_parts(self, zp, pixel_val, pt_views, ctx_c2w,
                               ctx_intr, H, W) -> tuple[Tensor, Tensor]:
        """Unfused V=2 exchange before the per-view concat
        (renderer.py:857-883): (fuse_self, fuse_cross), each
        (B, V, R, P, ld). fuse_self[:, v] fuses view v's own maps on its
        segment (border padding) with pt in frame v; fuse_cross[:, v]
        fuses view 1 - v's maps at view v's samples reprojected into frame
        1 - v (zeros padding) with that point."""
        B, V, R, P, _ = pt_views.shape
        interp_val = grid_sample_pyramid_packed(
            zp, pixel_val.reshape(B * V, R * P, 2),
            'border').reshape(B, V, R, P, -1)
        pt_in = self._exchange_points(pt_views, ctx_c2w)   # (B,K,V,R,P,3)
        pt_cross = torch.stack([pt_in[:, k, 1 - k] for k in range(2)],
                               dim=1)                      # (B,K,R,P,3)
        proj = G.project_pinhole(pt_cross.reshape(B, V, R * P, 3), ctx_intr)
        pix = G.pixel_to_ndc(proj[..., :2], H, W)
        gathered = grid_sample_pyramid_packed(
            zp, pix.reshape(B * V, R * P, 2), 'zeros').reshape(B, V, R, P,
                                                               -1)
        fs = torch.stack([self._fuse_latent(interp_val[:, v], pt_in[:, v, v])
                          for v in range(2)], dim=1)
        fc = torch.stack([self._fuse_latent(gathered[:, 1 - v],
                                            pt_in[:, 1 - v, v])
                          for v in range(2)], dim=1)
        return fs, fc

    def _sample_pyramid(self, z, zp, coords: Tensor, mode: str) -> Tensor:
        """The unfused V>=3 exchange's, or the exchange-free paths',
        pyramid gather at (B*V, N, 2) coords: the packed tables where the
        render has them under ``gather='take'``, else the unpacked levels
        through the take path, K7 or K8 (renderer.py:413, :1092)."""
        if self.gather == 'take' and zp is not None:
            return grid_sample_pyramid_packed(zp, coords, mode)
        return grid_sample_pyramid(z, coords, mode, self.gather)

    def _latent_exchange(self, interp_val: Tensor, z, zp, pt_views, ctx_c2w,
                         ctx_intr, H, W) -> Tensor:
        """Unfused cross-view exchange at V>=3 (renderer.py:1056-1112).

        For the rays of view v: the self features (the epipolar gather
        ``interp_val``) fused with pt in frame v, and for every other view
        k the features of k's maps at the sample's point in frame k, fused
        with that point. Under ``reference_exchange_compat`` frame k's maps
        are sampled at the projection of pt_in[v, k] instead, as the
        reference does (models.py:384-393). Returns the per-view
        concatenation (B, V, R, P, ld * V)."""
        B, V, R, P, C = interp_val.shape
        pt_in = self._exchange_points(pt_views, ctx_c2w)   # (B,K,V,R,P,3)
        others = [[v for v in range(V) if v != k] for k in range(V)]
        swap = self.reference_exchange_compat
        if swap:
            pt_cross = torch.stack([pt_in[:, others[k], k] for k in range(V)],
                                   dim=1)
        else:
            pt_cross = torch.stack([pt_in[:, k, others[k]] for k in range(V)],
                                   dim=1)                  # (B,K,V-1,R,P,3)
        proj = G.project_pinhole(pt_cross.reshape(B, V, (V - 1) * R * P, 3),
                                 ctx_intr)
        pix = G.pixel_to_ndc(proj[..., :2], H, W)
        gathered_x = self._sample_pyramid(
            z, zp, pix.reshape(B * V, (V - 1) * R * P, 2),
            'zeros').reshape(B, V, V - 1, R, P, C)

        self_nat = torch.stack([self._fuse_latent(interp_val[:, v],
                                                  pt_in[:, v, v])
                                for v in range(V)], dim=1)

        def cross_fn(k, v):
            return self._fuse_latent(gathered_x[:, k, others[k].index(v)],
                                     pt_in[:, v, k] if swap
                                     else pt_in[:, k, v])

        return self._exchange_concat(self_nat, cross_fn, V, swap)

    @staticmethod
    def _key_hw(z) -> tuple[int, int]:
        """(H, W) of the pyramid's finest level: the sort key's grid."""
        return max(((f.shape[1], f.shape[2]) for f in z),
                   key=lambda s: s[0] * s[1])

    def _sorted_exchange_v2(self, z, pixel_val, pt_views, ctx_c2w, ctx_intr,
                            H, W) -> tuple[Tensor, Tensor]:
        """V=2 exchange on one sorted stream (renderer.py:919-997).

        One stable sort by the self sample's row orders both gathers: the
        cross gather reads the other view's maps (image ``id ^ 1``) at the
        projection of the same 3D point, with the other frame's intrinsics.
        The cross coords and both points ride one (M, 8) permute; the fuse
        MLP, the per-view [self, cross] / [cross, self] order (selected by
        view id) and the ``latent_value`` / ``key_map`` products run in
        sorted order, and one (M, ld + 128) unsort restores ray order.
        Returns (joint_latent, key_val) as (B, V, R, P, ·)."""
        B, V, R, P, _ = pt_views.shape
        M = B * V * R * P
        ld = self.latent_dim
        pt_in = self._exchange_points(pt_views, ctx_c2w)   # (B,K,V,R,P,3)
        pt_self = torch.stack([pt_in[:, v, v] for v in range(V)], dim=1)
        pt_cross = torch.stack([pt_in[:, 1 - v, v] for v in range(V)], dim=1)
        proj = G.project_pinhole(pt_cross.reshape(B, V, R * P, 3),
                                 ctx_intr.flip(1))
        pix = G.pixel_to_ndc(proj[..., :2], H, W)          # (B, V, R*P, 2)

        stream = sort_stream(pixel_val.reshape(B * V, R * P, 2),
                             self._key_hw(z))
        payload = torch.cat([pix.reshape(M, 2), pt_self.reshape(M, 3),
                             pt_cross.reshape(M, 3)], dim=-1)
        payload_s = payload.index_select(0, stream.perm.long())
        cross_id = stream.image_id ^ 1                     # the other view
        feat_self = torch.cat([grid_sample_sorted(
            fm, stream.coords, stream.image_id, 'border') for fm in z],
            dim=-1)
        feat_cross = torch.cat([grid_sample_sorted(
            fm, payload_s[:, 0:2], cross_id, 'zeros') for fm in z], dim=-1)
        fs = self._fuse_latent(feat_self, payload_s[:, 2:5])
        fc = self._fuse_latent(feat_cross, payload_s[:, 5:8])

        # View 0 takes [self, cross], view 1 [cross, self] (models.py:335,342).
        even = (stream.image_id % 2 == 0)[:, None]
        interp_s = torch.cat([torch.where(even, fs, fc),
                              torch.where(even, fc, fs)], dim=-1)
        jl_s = self.latent_value(interp_s)
        kv_s = self.key_map_2(torch.relu(self.key_map(interp_s)))
        both = unsort(torch.cat([jl_s, kv_s], dim=-1), stream)
        # K1 takes contiguous operands, so each slice gets its own copy.
        return (both[:, :ld].reshape(B, V, R, P, ld).contiguous(),
                both[:, ld:].reshape(B, V, R, P, HIDDEN_DIM).contiguous())

    def _latent_exchange_sorted(self, z, pixel_val, pt_views, ctx_c2w,
                                ctx_intr, H, W) -> Tensor:
        """Unfused exchange at V>=3 on two sorted streams
        (renderer.py:999-1054): the self gather sorted by its rows, the
        cross gathers of all V (V - 1) pairs sorted by theirs; each
        stream's fuse MLP runs in sorted order and is unsorted once.
        Covers both wirings; returns what :meth:`_latent_exchange` does."""
        B, V, R, P, _ = pt_views.shape
        M = B * V * R * P
        key_hw = self._key_hw(z)
        pt_in = self._exchange_points(pt_views, ctx_c2w)   # (B,K,V,R,P,3)
        others = [[v for v in range(V) if v != k] for k in range(V)]
        swap = self.reference_exchange_compat

        stream1 = sort_stream(pixel_val.reshape(B * V, R * P, 2), key_hw)
        feat_s = grid_sample_pyramid_sorted(z, stream1, 'border')
        pt_self = torch.stack([pt_in[:, v, v] for v in range(V)], dim=1)
        pt_self_s = pt_self.reshape(M, 3).index_select(
            0, stream1.perm.long())
        fuse_self = unsort(self._fuse_latent(feat_s, pt_self_s),
                           stream1).reshape(B, V, R, P, -1)

        if swap:
            pt_cross = torch.stack([pt_in[:, others[k], k] for k in range(V)],
                                   dim=1)
        else:
            pt_cross = torch.stack([pt_in[:, k, others[k]] for k in range(V)],
                                   dim=1)                  # (B,K,V-1,R,P,3)
        proj = G.project_pinhole(pt_cross.reshape(B, V, (V - 1) * R * P, 3),
                                 ctx_intr)
        pix = G.pixel_to_ndc(proj[..., :2], H, W)
        stream2 = sort_stream(pix.reshape(B * V, (V - 1) * R * P, 2), key_hw)
        featx_s = grid_sample_pyramid_sorted(z, stream2, 'zeros')
        ptx_s = pt_cross.reshape(M * (V - 1), 3).index_select(
            0, stream2.perm.long())
        fuse_cross = unsort(self._fuse_latent(featx_s, ptx_s),
                            stream2).reshape(B, V, V - 1, R, P, -1)

        def cross_fn(k, v):
            return fuse_cross[:, k, others[k].index(v)]

        return self._exchange_concat(fuse_self, cross_fn, V, swap)

    @staticmethod
    def _exchange_concat(self_nat: Tensor, cross_fn, V: int,
                         swap: bool) -> Tensor:
        """Per-view channel assembly at V>=3 (renderer.py:894-917):
        [self, other views ascending] (models.py:446,459,473); under
        ``swap`` the parts interleave (channel, slot) like the reference's
        cat(dim=2).flatten(1, 2) (models.py:443-446)."""
        per_view = []
        for v in range(V):
            parts = [self_nat[:, v]] + [cross_fn(k, v) for k in range(V)
                                        if k != v]
            if swap:
                iv = torch.stack(parts, dim=-1)
                per_view.append(iv.reshape(*iv.shape[:-2], -1))
            else:
                per_view.append(torch.cat(parts, dim=-1))
        return torch.stack(per_view, dim=1)               # (B,V,R,P,ld*V)
