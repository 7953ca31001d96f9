"""Cross-attention light-field renderer (the flagship model), V=2 path.

Port of ``cross_attention_renderer_tpu/models/renderer.py``, its default V=2
branch: the one that reaches the fused exchange epilogue and the fused
epipolar attention (renderer.py:344-361, :436-528).

  1. ``encode``: DPT-hybrid multi-view encoder + full-res 7x7 conv branch
     -> feature pyramid z (models.py:148-188).
  2. Query rays -> Plücker coords in each context frame; epipolar segment
     per (ray, view) and ``npoints`` uniform samples; the 3D point on the
     query ray at each sample (models.py:213-283).
  3. Cell rows and slot weights of both streams (the self stream samples
     view v's maps on its segment; the cross stream samples view 1 - v's
     maps at the reprojected 3D point), then the fused exchange epilogue
     (kernel K2) -> joint latent and key per sample (models.py:278-346).
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
from cross_attention_renderer_torch.ops.gather_epilogue import (
    fused_exchange_epilogue)
from cross_attention_renderer_torch.ops.grid_sample import (
    cell_rows_and_slot_weights, pack_pyramid)
from cross_attention_renderer_torch.utils.image import normalize_imagenet

Tensor = torch.Tensor

N_VIEW = 2                # the V=2 path is the one ported
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
    """The flagship renderer at V=2 (see the module docstring).

    Sizes default to the reference configuration (the 122M DPT-hybrid);
    smaller encoder settings keep the architecture for CPU tests. The
    parameters are drawn from ``seed`` (Flax's initialisers, see
    :func:`~cross_attention_renderer_torch.layers.init_parameters`) and
    placed on ``device``."""

    def __init__(self, npoints: int = 64, fusion_features: int = 256,
                 vit_width: int = 768, vit_depth: int = 12,
                 vit_heads: int = 12,
                 resnet_layers: tuple[int, int, int] = (3, 4, 9),
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device='cuda'):
        super().__init__()
        self.n_samples, self.dtype = npoints, dtype
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
        self.latent_value = SplitDense(ld * N_VIEW, ld, dtype)
        self.key_map = SplitDense(ld * N_VIEW, HIDDEN_DIM, dtype)
        self.key_map_2 = SplitDense(HIDDEN_DIM, HIDDEN_DIM, dtype)
        self.query_embed = SplitDense(QUERY_FEAT_DIM, HIDDEN_DIM, dtype)
        self.query_embed_2 = SplitDense(HIDDEN_DIM, HIDDEN_DIM, dtype)
        self.encode_latent = SplitDense(ld, HIDDEN_DIM, dtype)
        self.query_repeat_embed = SplitDense(HIDDEN_DIM + QUERY_FEAT_DIM,
                                             HIDDEN_DIM, dtype)
        self.query_repeat_embed_2 = SplitDense(HIDDEN_DIM, HIDDEN_DIM, dtype)
        self.phi = ResnetFC(d_in=N_VIEW * 9, d_latent=ld * N_VIEW, d_out=3,
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
        if V != N_VIEW:
            raise ValueError(f'the port renders {N_VIEW} context views, '
                             f'got {V}')
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

        joint_latent, key_val = self._fused_exchange_v2(
            zp, pixel_val, pt_views, ctx_c2w, ctx_intr_v, H, W)

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

        coords_embed = self.query_embed_2(torch.relu(
            self.query_embed(local_coords)))
        # Round 1 over the joint (view, sample) axis (models.py:532-541).
        z_sum, at_wt = epipolar_attention(coords_embed, key_val,
                                          joint_latent)
        # Round 2, queried by the round-1 latent (models.py:547-565); the
        # result is sum_v z2 + V * z_sum, as round-1 z_local is already the
        # view-broadcast sum.
        z_local = z_sum[:, None].expand(B, V, R, z_sum.shape[-1])
        z_embed = self.encode_latent(z_local)              # (B, V, R, 128)
        z_embed_local = z_embed[:, :, :, None, :].expand(B, V, R, P,
                                                         HIDDEN_DIM)
        query_embed_local = self.query_repeat_embed_2(torch.relu(
            self.query_repeat_embed(z_embed_local,
                                    local_coords.to(self.dtype))))
        z_sum2, _ = epipolar_attention(query_embed_local, coords_embed,
                                       joint_latent)
        z_local = (z_sum2 + V * z_sum)[:, None].expand(B, V, R,
                                                       z_sum.shape[-1])

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

    # ------------------------------------------------------------------
    def _exchange_points(self, pt_views: Tensor, ctx_c2w: Tensor) -> Tensor:
        """pt_in[:, k, v]: view-v samples expressed in frame k
        (renderer.py:885-892)."""
        rel = torch.linalg.inv(ctx_c2w)[:, :, None] @ ctx_c2w[:, None]
        pt_in = G.transform_points(pt_views[:, None],
                                   rel[:, :, :, None, None])
        return torch.where(torch.isfinite(pt_in), pt_in,
                           torch.zeros_like(pt_in))

    def _stacked_takes(self, zp, pixel_val, pt_views, ctx_c2w, ctx_intr, H,
                       W):
        """Cell rows of both streams per level, and the two aux arrays
        (renderer.py:591-655). Returns (cells: per-level (2M,) int32,
        aux_self, aux_cross: (M, 16) in the model type)."""
        B, V, R, P, _ = pt_views.shape
        M = B * V * R * P
        dev = pt_views.device
        pt_in = self._exchange_points(pt_views, ctx_c2w)
        pt_self = torch.stack([pt_in[:, v, v] for v in range(2)], dim=1)
        pt_cross = torch.stack([pt_in[:, 1 - v, v] for v in range(2)], dim=1)
        # The cross stream of the rays of view v projects with frame
        # (1 - v)'s intrinsics and samples view (1 - v)'s maps.
        intr_sw = torch.flip(ctx_intr, dims=[1])
        proj = G.project_pinhole(pt_cross.reshape(B, V, R * P, 3), intr_sw)
        pix_cross = G.pixel_to_ndc(proj[..., :2], H, W)

        coords_self = pixel_val.reshape(B * V, R * P, 2)
        coords_cross = pix_cross.reshape(B * V, R * P, 2)
        # image row (b, v) of the coords samples image (b, 1 - v)
        xid = (torch.arange(B * V, dtype=torch.int32, device=dev)[:, None]
               ^ 1).expand(B * V, R * P)

        cells, w_s, w_c = [], [], []
        for packed in zp:
            hw = (packed.shape[1], packed.shape[2])
            cs, ws = cell_rows_and_slot_weights(hw, coords_self, 'border')
            cc, wc = cell_rows_and_slot_weights(hw, coords_cross, 'zeros',
                                                image_id=xid)
            cells.append(torch.cat([cs.reshape(-1), cc.reshape(-1)]))
            w_s.append(ws.reshape(M, 4))
            w_c.append(wc.reshape(M, 4))

        adt = self.dtype
        pad = torch.zeros((M, 1), dtype=adt, device=dev)
        t_self = torch.tanh(pt_self.reshape(M, 3) / 5.0).to(adt)
        t_cross = torch.tanh(pt_cross.reshape(M, 3) / 5.0).to(adt)
        aux_self = torch.cat([w.to(adt) for w in w_s] + [t_self, pad], dim=-1)
        aux_cross = torch.cat([w.to(adt) for w in w_c] + [t_cross, pad],
                              dim=-1)
        return tuple(cells), aux_self, aux_cross

    def _fused_exchange_v2(self, zp, pixel_val, pt_views, ctx_c2w, ctx_intr,
                           H, W) -> tuple[Tensor, Tensor]:
        """V=2 exchange through the fused epilogue (renderer.py:657-688).
        Returns (joint_latent, key_val) as (B, V, R, P, ·)."""
        B, V, R, P, _ = pt_views.shape
        cells, aux_self, aux_cross = self._stacked_takes(
            zp, pixel_val, pt_views, ctx_c2w, ctx_intr, H, W)
        params = tuple(t.to(self.dtype) for t in (
            self.query_encode_latent.kernel, self.query_encode_latent.bias,
            self.query_encode_latent_2.kernel,
            self.query_encode_latent_2.bias,
            self.latent_value.kernel, self.latent_value.bias,
            self.key_map.kernel, self.key_map.bias,
            self.key_map_2.kernel, self.key_map_2.bias))
        jl, kv = fused_exchange_epilogue(zp, cells, aux_self, aux_cross,
                                         params, R * P)
        return (jl.reshape(B, V, R, P, self.latent_dim),
                kv.reshape(B, V, R, P, HIDDEN_DIM))
