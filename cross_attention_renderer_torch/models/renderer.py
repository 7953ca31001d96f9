"""Cross-attention light-field renderer (the flagship model), V=2 and V=3.

Port of ``cross_attention_renderer_tpu/models/renderer.py`` along these
branches (renderer.py:344-528):

* V=2, default: the fused exchange epilogue (kernel K2, renderer.py:354-361)
  and both attention rounds (kernel K1);
* V=2 with ``fused_render``: the fully fused render core (kernel K4,
  renderer.py:350-353, :458-467, :769-819), which runs the exchange and
  both attention rounds in one kernel;
* V=2 with ``fused_epilogue=False``: the unfused exchange
  (renderer.py:362-388, :857-883);
* V=3, default: the multi-stream fused epilogue (kernel K3,
  renderer.py:389-401, :690-767);
* V=3 with ``reference_exchange_compat`` or ``fused_epilogue=False``: the
  unfused exchange (renderer.py:402-434, :1056-1112).

The unfused exchanges' fuse MLP runs as kernel K9 when ``fused_mlp`` is set
(renderer.py:835-853).

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
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from cross_attention_renderer_torch.encoders.dpt import DPTHybridEncoder
from cross_attention_renderer_torch.geometry import epipolar as E
from cross_attention_renderer_torch.geometry import rays as G
from cross_attention_renderer_torch.layers import (Conv, init_parameters,
                                                   lecun_normal_)
from cross_attention_renderer_torch.models.resnet_fc import ResnetFC
from cross_attention_renderer_torch.ops.epipolar_attention import (
    epipolar_attention)
from cross_attention_renderer_torch.ops.fused_mlp import fused_mlp2
from cross_attention_renderer_torch.ops.fused_render import fused_render_core
from cross_attention_renderer_torch.ops.gather_epilogue import (
    fused_exchange_epilogue, fused_exchange_epilogue_multi)
from cross_attention_renderer_torch.ops.grid_sample import (
    cell_rows_and_slot_weights, grid_sample_pyramid_packed, pack_pyramid)
from cross_attention_renderer_torch.utils.image import normalize_imagenet

Tensor = torch.Tensor

HIDDEN_DIM = 128          # attention hidden width (models.py:114)
QUERY_FEAT_DIM = 16       # cam_rays 3 + zeros 3 + ray_dir 3 + depth 4
                          # + query origin 3 (models.py:528)


class SplitDense(nn.Module):
    """Dense layer over an input given as channel segments.

    ``SplitDense(f, d)(a, b)`` is ``Dense(f)(cat([a, b]))`` computed by
    slicing the kernel, so the wide concatenation never exists. The kernel
    keeps the JAX (d_in, features) layout whole; the fused epilogue reads
    it directly."""

    def __init__(self, d_in: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(d_in, features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def reset_parameters(self, g: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], g)
        nn.init.zeros_(self.bias)

    def forward(self, *parts: Tensor) -> Tensor:
        if sum(p.shape[-1] for p in parts) != self.kernel.shape[0]:
            raise ValueError(f'SplitDense: inputs {[p.shape for p in parts]}'
                             f' do not sum to {self.kernel.shape[0]}')
        k = self.kernel.to(self.dtype)
        out, off = None, 0
        for p in parts:
            w = k[off:off + p.shape[-1]]
            off += p.shape[-1]
            t = p.to(self.dtype) @ w
            out = t if out is None else out + t
        return out + self.bias.to(self.dtype)


class CrossAttentionRenderer(nn.Module):
    """The flagship renderer at V=2 or V=3 (see the module docstring).

    Sizes default to the reference configuration (the 122M DPT-hybrid);
    smaller encoder settings keep the architecture for CPU tests. The
    parameters are drawn from ``seed`` (Flax's initialisers, see
    :func:`~cross_attention_renderer_torch.layers.init_parameters`) and
    placed on ``device``.

    Args:
      n_view: context views, 2 or 3.
      npoints: epipolar samples per view; 0 takes the reference's default,
        64 at V=2 and 48 at V=3 (models.py:47-54).
      fused_epilogue: take the fused exchange epilogue (K2 at V=2, K3 at
        V=3). ``False`` takes the unfused exchange.
      reference_exchange_compat: reproduce the reference's 3-view exchange
        index swap (DEVIATIONS.md), which the fused V=3 epilogue does not
        implement: at V=3 it implies the unfused exchange. No effect at V=2.
      fused_mlp: run the unfused exchange's fuse MLP as kernel K9 (the JAX
        package's ``CAR_FUSED_MLP`` switch).
      fused_render: at V=2, run the exchange and both attention rounds as
        the fully fused render core K4 (the JAX package's
        ``CAR_FUSED_RENDER`` switch); it takes precedence over
        ``fused_epilogue``. V=2 only.
      repeat_attention: run the second attention round, queried by the
        first round's output (models.py:547-565). Without it the model has
        no ``encode_latent`` and ``query_repeat_embed(_2)``, as the JAX
        parameter tree has none.
    """

    def __init__(self, n_view: int = 2, npoints: int = 0,
                 fusion_features: int = 256, vit_width: int = 768,
                 vit_depth: int = 12, vit_heads: int = 12,
                 resnet_layers: tuple[int, int, int] = (3, 4, 9),
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device='cuda', fused_epilogue: bool = True,
                 reference_exchange_compat: bool = False,
                 fused_mlp: bool = False, fused_render: bool = False,
                 repeat_attention: bool = True):
        super().__init__()
        if n_view not in (2, 3):
            raise ValueError(f'the port renders 2 or 3 context views, got '
                             f'n_view={n_view}')
        if fused_render and n_view != 2:
            raise ValueError('the fused render core renders 2 context '
                             f'views, got n_view={n_view}')
        self.n_view = n_view
        self.n_samples = npoints or (64 if n_view <= 2 else 48)
        self.dtype = dtype
        self.fused_epilogue = fused_epilogue
        self.reference_exchange_compat = reference_exchange_compat
        self.fused_mlp = fused_mlp
        self.fused_render = fused_render
        self.repeat_attention = repeat_attention
        self.encoder = DPTHybridEncoder(
            features=fusion_features, vit_width=vit_width,
            vit_depth=vit_depth, vit_heads=vit_heads,
            resnet_layers=resnet_layers, dtype=dtype)
        self.conv_map = Conv(3, 64, 7, padding=3, dtype=dtype)

        base = 2 * fusion_features + 64     # pyramid width (576)
        ld = base // 2                      # latent width (288)
        self.latent_dim = ld
        self.query_encode_latent = SplitDense(base + 3, base, dtype)
        self.query_encode_latent_2 = SplitDense(base, ld, dtype)
        self.latent_value = SplitDense(ld * n_view, ld, dtype)
        self.key_map = SplitDense(ld * n_view, HIDDEN_DIM, dtype)
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
    def encode(self, scene: dict) -> tuple[Tensor, Tensor, Tensor]:
        """Feature pyramid (path2, path1, z_conv), channel-last
        (renderer.py:232-251)."""
        ctx = scene['context']
        rgb = ctx['rgb'].float()
        B, V, H, W, _ = rgb.shape
        c2w = ctx['cam2world'].float()
        rel = torch.linalg.inv(c2w[:, 0])[:, None] @ c2w
        rgb_norm = normalize_imagenet((rgb + 1.0) * 0.5).to(self.dtype)
        path2, path1 = self.encoder(rgb_norm, rel.reshape(B, V, 16))
        z_conv = self.conv_map(rgb_norm.reshape(B * V, H, W, 3))
        return path2, path1, z_conv

    # ------------------------------------------------------------------
    def forward(self, scene: dict, z: Optional[Sequence[Tensor]] = None,
                z_packed: Optional[Sequence[Tensor]] = None) -> dict:
        """Renders the query rays. ``z`` is the pyramid from :meth:`encode`
        (computed when absent); ``z_packed`` its cell tables, which callers
        rendering many ray blocks build once per image."""
        ctx, qry = scene['context'], scene['query']
        B, V, H, W, _ = ctx['rgb'].shape
        if V != self.n_view:
            raise ValueError(f'the model was built for {self.n_view} '
                             f'context views, the scene has {V}')
        R = qry['uv'].shape[2]
        P = self.n_samples
        dev = ctx['rgb'].device
        if z is None:
            z = self.encode(scene)
        zp = tuple(z_packed) if z_packed is not None else pack_pyramid(z)

        # Everything happens in each context camera's frame.
        ctx_c2w = ctx['cam2world'].float()
        ctx_intr_v = ctx['intrinsics'].float()
        qry_c2w = qry['cam2world'].float()
        query_cam2world = torch.linalg.inv(ctx_c2w) @ qry_c2w  # (B, V, 4, 4)

        uv = qry['uv'][:, 0].float()[:, None].expand(B, V, R, 2)
        q_intr = qry['intrinsics'].float().expand(B, V, 4, 4)
        lf_coords = G.plucker_embedding(
            query_cam2world.reshape(B * V, 4, 4), uv.reshape(B * V, R, 2),
            q_intr.reshape(B * V, 4, 4))                   # (B*V, R, 6)
        ctx_intr = ctx_intr_v.reshape(B * V, 4, 4)
        origins = G.ray_origin(query_cam2world).reshape(B * V, 1, 3).expand(
            B * V, R, 3)
        ray_dir = lf_coords[..., :3]

        # Segment intrinsics are divided by H, not (W, H) (models.py:226).
        intr_norm = torch.cat([ctx_intr[:, :2] / H, ctx_intr[:, 2:]], dim=1)
        start, end, valid = E.epipolar_segments_ndc(origins, ray_dir,
                                                    intr_norm)
        interval = torch.arange(P, dtype=start.dtype, device=dev) / (P - 1)
        pixel_val = (start[..., None, :] + (end - start)[..., None, :]
                     * interval[:, None])                  # (B*V, R, P, 2)

        eye = torch.eye(4, device=dev).expand(B * V, 4, 4)
        pt, _, _ = G.epipolar_point_3d(lf_coords, pixel_val, eye, H, W,
                                       ctx_intr)
        pt_views = pt.reshape(B, V, R, P, 3)

        geo = (zp, pixel_val, pt_views, ctx_c2w, ctx_intr_v, H, W)
        if self.fused_render:
            # K4 takes local_coords as well, so it runs once they exist.
            joint_latent = key_val = None
        elif V == 2 and self.fused_epilogue:
            joint_latent, key_val = self._fused_exchange_v2(*geo)
        elif V == 2:
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
        elif self.fused_epilogue and not self.reference_exchange_compat:
            joint_latent, key_val = self._fused_exchange_multi(*geo)
        else:
            interp_val = grid_sample_pyramid_packed(
                zp, pixel_val.reshape(B * V, R * P, 2), 'border')
            interp_val = self._latent_exchange(
                interp_val.reshape(B, V, R, P, -1), zp, pt_views, ctx_c2w,
                ctx_intr_v, H, W)
            joint_latent = self.latent_value(interp_val)
            key_val = self.key_map_2(torch.relu(self.key_map(interp_val)))

        # Per-sample query features (models.py:494-528).
        cam_rays = G.ray_directions_cam(pixel_val, ctx_intr[:, None], H,
                                        W).reshape(B, V, R, P, 3)
        ray_dir_e = ray_dir.reshape(B, V, R, 1, 3).expand_as(cam_rays)
        q_orig = G.ray_origin(query_cam2world)             # (B, V, 3)
        q_orig_e = q_orig[:, :, None, None, :].expand_as(cam_rays)
        depth = torch.linalg.vector_norm(
            pt_views - q_orig[:, :, None, None, :], dim=-1, keepdim=True)
        depth = torch.where(torch.isfinite(depth), depth,
                            torch.full_like(depth, 1e6))
        depth_encode = torch.cat(
            [torch.tanh(depth), torch.tanh(depth / 10.0),
             torch.tanh(depth / 100.0), torch.tanh(depth / 1000.0)], dim=-1)
        local_coords = torch.cat(
            [cam_rays, torch.zeros_like(q_orig_e), ray_dir_e, depth_encode,
             q_orig_e], dim=-1)                            # (B,V,R,P,16)

        if self.fused_render:
            z_final, at_wt = self._fused_render_v2(*geo, local_coords)
            z_local = z_final[:, None].expand(B, V, R, z_final.shape[-1])
        else:
            z_local, at_wt = self._attention_rounds(
                local_coords, key_val, joint_latent)

        # Attention-derived depth from the round-1 weights (models.py:573-594).
        pt_clamp = pt_views.clamp(-100.0, 100.0)
        world_point = (at_wt[..., None] * pt_clamp).sum(dim=3).sum(dim=1)
        cam_point = G.points_to_cam(world_point, qry_c2w[:, 0][:, None])
        depth_ray = cam_point[..., 2].clamp(0.0, 10.0)[..., None]

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

    def _attention_rounds(self, local_coords: Tensor, key_val: Tensor,
                          joint_latent: Tensor) -> tuple[Tensor, Tensor]:
        """The query MLP and the attention rounds (K1) on the exchange's
        outputs (models.py:528-565). Returns (z_local (B, V, R, ld), the
        round-1 weights (B, V, R, P))."""
        B, V, R, P, _ = joint_latent.shape
        coords_embed = self.query_embed_2(torch.relu(
            self.query_embed(local_coords)))
        # Round 1 over the joint (view, sample) axis (models.py:532-541).
        z_sum, at_wt = epipolar_attention(coords_embed, key_val,
                                          joint_latent)
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
        z_sum2, _ = epipolar_attention(query_embed_local, coords_embed,
                                       joint_latent)
        return ((z_sum2 + V * z_sum)[:, None].expand(B, V, R,
                                                      z_sum.shape[-1]),
                at_wt)

    # ------------------------------------------------------------------
    def _exchange_points(self, pt_views: Tensor, ctx_c2w: Tensor) -> Tensor:
        """pt_in[:, k, v]: view-v samples expressed in frame k
        (renderer.py:885-892)."""
        rel = torch.linalg.inv(ctx_c2w)[:, :, None] @ ctx_c2w[:, None]
        pt_in = G.transform_points(pt_views[:, None],
                                   rel[:, :, :, None, None])
        return torch.where(torch.isfinite(pt_in), pt_in,
                           torch.zeros_like(pt_in))

    def _stream_takes(self, zp, pixel_val, pt_views, ctx_c2w, ctx_intr, H,
                      W) -> tuple[tuple[Tensor, ...], list[Tensor]]:
        """Cell rows and aux arrays of the V exchange streams
        (renderer.py:591-655 at V=2, :710-754 at V>=3).

        Stream 0 is the self stream (each view's own maps on its segment,
        border padding); stream j >= 1 holds, for the rays of every view v,
        its j-th other view k in ascending frame order (the sample's 3D
        point in frame k, projected with k's intrinsics, k's maps, zeros
        padding). At V=2 that is the cross stream of view 1 - v. Returns
        (cells: per-level (V*M,) int32, stream-major; aux: V arrays
        (M, 16) in the model type: 12 slot weights, tanh(pt/5), pad)."""
        B, V, R, P, _ = pt_views.shape
        M = B * V * R * P
        dev = pt_views.device
        pt_in = self._exchange_points(pt_views, ctx_c2w)
        others = [[k for k in range(V) if k != v] for v in range(V)]
        pt_self = torch.stack([pt_in[:, v, v] for v in range(V)], dim=1)
        streams = [(pixel_val.reshape(B * V, R * P, 2), None, 'border',
                    pt_self)]
        row = torch.arange(B * V, dtype=torch.int32, device=dev)[:, None]
        for j in range(V - 1):
            k_of = torch.tensor([others[v][j] for v in range(V)],
                                dtype=torch.int32, device=dev)
            pt_j = torch.stack([pt_in[:, others[v][j], v] for v in range(V)],
                               dim=1)
            intr_j = torch.stack([ctx_intr[:, others[v][j]]
                                  for v in range(V)], dim=1)
            proj = G.project_pinhole(pt_j.reshape(B, V, R * P, 3), intr_j)
            pix = G.pixel_to_ndc(proj[..., :2], H, W)
            # image row (b, v) of the coords samples image (b, k_of[v])
            xid = (row // V) * V + k_of[(row % V).long()]
            streams.append((pix.reshape(B * V, R * P, 2), xid, 'zeros',
                            pt_j))

        adt = self.dtype
        pad = torch.zeros((M, 1), dtype=adt, device=dev)
        cells = [[] for _ in zp]
        aux = []
        for coords, xid, mode, pt in streams:
            weights = []
            for l, packed in enumerate(zp):
                c, w = cell_rows_and_slot_weights(
                    (packed.shape[1], packed.shape[2]), coords, mode,
                    image_id=xid)
                cells[l].append(c.reshape(-1))
                weights.append(w.reshape(M, 4).to(adt))
            t = torch.tanh(pt.reshape(M, 3) / 5.0).to(adt)
            aux.append(torch.cat(weights + [t, pad], dim=-1))
        return tuple(torch.cat(c) for c in cells), aux

    def _epilogue_params(self) -> tuple[Tensor, ...]:
        """The fused epilogues' weights, in the model type."""
        return tuple(t.to(self.dtype) for t in (
            self.query_encode_latent.kernel, self.query_encode_latent.bias,
            self.query_encode_latent_2.kernel,
            self.query_encode_latent_2.bias,
            self.latent_value.kernel, self.latent_value.bias,
            self.key_map.kernel, self.key_map.bias,
            self.key_map_2.kernel, self.key_map_2.bias))

    def _fused_exchange_v2(self, zp, pixel_val, pt_views, ctx_c2w, ctx_intr,
                           H, W) -> tuple[Tensor, Tensor]:
        """V=2 exchange through the fused epilogue (renderer.py:657-688).
        Returns (joint_latent, key_val) as (B, V, R, P, ·)."""
        B, V, R, P, _ = pt_views.shape
        cells, (aux_self, aux_cross) = self._stream_takes(
            zp, pixel_val, pt_views, ctx_c2w, ctx_intr, H, W)
        jl, kv = fused_exchange_epilogue(zp, cells, aux_self, aux_cross,
                                         self._epilogue_params(), R * P)
        return (jl.reshape(B, V, R, P, self.latent_dim),
                kv.reshape(B, V, R, P, HIDDEN_DIM))

    def _fused_render_v2(self, zp, pixel_val, pt_views, ctx_c2w, ctx_intr,
                         H, W, local_coords) -> tuple[Tensor, Tensor]:
        """V=2 takes -> exchange -> both attention rounds, one kernel K4
        (renderer.py:769-819): everything :meth:`_fused_exchange_v2` does
        plus the query MLP, round 1 and, with ``repeat_attention``,
        ``encode_latent``, the repeat-query MLP and round 2 (models.py:
        278-565). Returns (z_final (B, R, ld), at_wt (B, V, R, P))."""
        B, V, R, P, _ = pt_views.shape
        cells, (aux_self, aux_cross) = self._stream_takes(
            zp, pixel_val, pt_views, ctx_c2w, ctx_intr, H, W)
        ld, dt, dev = self.latent_dim, self.dtype, pt_views.device
        if self.repeat_attention:
            round2 = [t for m in (self.encode_latent, self.query_repeat_embed,
                                  self.query_repeat_embed_2)
                      for t in (m.kernel, m.bias)]
        else:
            # No round-2 modules exist; the kernel ignores these operands.
            round2 = [torch.zeros(s, device=dev) for s in (
                (ld, HIDDEN_DIM), (HIDDEN_DIM,),
                (HIDDEN_DIM + QUERY_FEAT_DIM, HIDDEN_DIM), (HIDDEN_DIM,),
                (HIDDEN_DIM, HIDDEN_DIM), (HIDDEN_DIM,))]
        params = self._epilogue_params() + tuple(t.to(dt) for t in (
            self.query_embed.kernel, self.query_embed.bias,
            self.query_embed_2.kernel, self.query_embed_2.bias, *round2))
        lc = local_coords.reshape(-1, QUERY_FEAT_DIM).to(dt).contiguous()
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
                                               self._epilogue_params())
        return (jl.reshape(B, V, R, P, self.latent_dim),
                kv.reshape(B, V, R, P, HIDDEN_DIM))

    # ------------------------------------------------------------------
    def _fuse_latent(self, feat: Tensor, points: Tensor) -> Tensor:
        """Shared 2-layer exchange encoder on ``[feat | tanh(pt/5)]``
        (renderer.py:821-855, models.py:335-346); kernel K9 when
        ``fused_mlp`` is set."""
        t = torch.tanh(points / 5.0).to(feat.dtype)
        qel, qel2 = self.query_encode_latent, self.query_encode_latent_2
        if self.fused_mlp:
            c1 = feat.shape[-1]
            out = fused_mlp2(
                feat.reshape(-1, c1).to(self.dtype).contiguous(),
                t.reshape(-1, t.shape[-1]).contiguous(), qel.kernel[:c1],
                qel.kernel[c1:], qel.bias, qel2.kernel, qel2.bias)
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

    def _latent_exchange(self, interp_val: Tensor, zp, pt_views, ctx_c2w,
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
        gathered_x = grid_sample_pyramid_packed(
            zp, pix.reshape(B * V, (V - 1) * R * P, 2),
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
