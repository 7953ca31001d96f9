"""SuperGlue attentional matcher in PyTorch.

Port of ``cross_attention_renderer_tpu/pose/superglue.py``: keypoint MLP
encoder, 18 alternating self and cross attention layers (4 heads, 256
wide), final projection, masked log-space Sinkhorn with a learned dustbin,
mutual check and threshold, on fixed-K slots with validity masks (invalid
slots are masked as attention sources and transport marginals, and their
matches are -1).

The module is the upstream network (``kenc.encoder``, ``gnn.layers.<l>.
attn.proj`` / ``merge`` / ``mlp``, ``final_proj``, ``bin_score``; Conv1d on
(B, C, K)), so an upstream state dict loads into :class:`SuperGlue` as it
is. Weights in the JAX package's layout (:func:`init_params`, or an npz of
:func:`convert_weights`) come in through :meth:`SuperGlue.from_params`.

The two layouts split a 256-wide projection into heads differently: the
upstream network reads channel ``d * 4 + h`` as dimension d of head h,
the JAX package channel ``h * 64 + d``. :func:`convert_weights` permutes
the q, k, v outputs and the merge inputs accordingly (the JAX function
copies them unpermuted, and it maps four of the keypoint encoder's five
layers), and :meth:`SuperGlue.from_params` undoes the permutation, so the
module computes the JAX function on a JAX-layout dict and the upstream one
on an upstream state dict.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

Tensor = torch.Tensor

DESC_DIM = 256
N_HEADS = 4
GNN_LAYERS = ('self', 'cross') * 9
KENC_LAYERS = (32, 64, 128, 256)
_NEG = -1e9
_HEAD_DIM = DESC_DIM // N_HEADS
# JAX-layout channel h * 64 + d -> upstream channel d * 4 + h
_HEAD_PERM = np.arange(DESC_DIM).reshape(_HEAD_DIM, N_HEADS).T.reshape(-1)
_HEAD_INV = np.argsort(_HEAD_PERM)
_BN_FIELDS = (('scale', 'weight'), ('bias', 'bias'), ('mean', 'running_mean'),
              ('var', 'running_var'))


def init_params(rng: np.random.Generator | int = 0) -> dict:
    """Random parameters in the JAX package's layout, drawn as its
    ``init_params`` draws them."""
    rng = np.random.default_rng(rng) if isinstance(rng, int) else rng
    p: dict = {'bin_score': np.float32(1.0)}

    def conv1d(name, cin, cout, bn):
        p[f'{name}_w'] = rng.normal(0, 1 / np.sqrt(cin),
                                    (cin, cout)).astype(np.float32)
        p[f'{name}_b'] = np.zeros(cout, np.float32)
        if bn:
            p[f'{name}_bn_scale'] = np.ones(cout, np.float32)
            p[f'{name}_bn_bias'] = np.zeros(cout, np.float32)
            p[f'{name}_bn_mean'] = np.zeros(cout, np.float32)
            p[f'{name}_bn_var'] = np.ones(cout, np.float32)

    dims = (3,) + KENC_LAYERS + (DESC_DIM,)
    for i in range(len(dims) - 1):
        conv1d(f'kenc_{i}', dims[i], dims[i + 1], bn=i < len(dims) - 2)
    for l in range(len(GNN_LAYERS)):
        for proj in ('q', 'k', 'v', 'merge'):
            conv1d(f'gnn{l}_{proj}', DESC_DIM, DESC_DIM, bn=False)
        mlp_dims = (2 * DESC_DIM, 2 * DESC_DIM, DESC_DIM)
        for i in range(2):
            conv1d(f'gnn{l}_mlp{i}', mlp_dims[i], mlp_dims[i + 1], bn=i < 1)
    conv1d('final_proj', DESC_DIM, DESC_DIM, bn=False)
    return p


def _layout() -> list:
    """(npz name, upstream conv, upstream BatchNorm or None, which side of
    the conv the heads split: 'out', 'in' or None) for every layer."""
    rows = []
    n_kenc = len(KENC_LAYERS) + 1
    for i in range(n_kenc):
        bn = f'kenc.encoder.{3 * i + 1}' if i < n_kenc - 1 else None
        rows.append((f'kenc_{i}', f'kenc.encoder.{3 * i}', bn, None))
    for l in range(len(GNN_LAYERS)):
        base = f'gnn.layers.{l}'
        for j, proj in enumerate('qkv'):
            rows.append((f'gnn{l}_{proj}', f'{base}.attn.proj.{j}', None,
                         'out'))
        rows.append((f'gnn{l}_merge', f'{base}.attn.merge', None, 'in'))
        rows.append((f'gnn{l}_mlp0', f'{base}.mlp.0', f'{base}.mlp.1', None))
        rows.append((f'gnn{l}_mlp1', f'{base}.mlp.3', None, None))
    rows.append(('final_proj', 'final_proj', None, None))
    return rows


def _np(v) -> np.ndarray:
    return np.asarray(v.detach().cpu() if isinstance(v, Tensor) else v)


def convert_weights(torch_state: dict) -> dict:
    """Upstream state dict -> the npz layout of :func:`init_params`, heads
    permuted so that the JAX split computes the upstream function."""
    out = {'bin_score': np.float32(_np(torch_state['bin_score']))}
    for name, conv, bn, heads in _layout():
        w = _np(torch_state[f'{conv}.weight'])[..., 0].T      # (in, out)
        b = _np(torch_state[f'{conv}.bias'])
        if heads == 'out':
            w, b = w[:, _HEAD_PERM], b[_HEAD_PERM]
        elif heads == 'in':
            w = w[_HEAD_PERM]
        out[f'{name}_w'] = np.ascontiguousarray(w)
        out[f'{name}_b'] = b
        if bn:
            for ours, theirs in _BN_FIELDS:
                out[f'{name}_bn_{ours}'] = _np(torch_state[f'{bn}.{theirs}'])
    return out


def _mlp(channels: tuple) -> nn.Sequential:
    """The upstream MLP: 1x1 convs with BatchNorm and ReLU between."""
    layers = []
    for i in range(1, len(channels)):
        layers.append(nn.Conv1d(channels[i - 1], channels[i], 1))
        if i < len(channels) - 1:
            layers += [nn.BatchNorm1d(channels[i]), nn.ReLU()]
    return nn.Sequential(*layers)


def normalize_keypoints(kpts: Tensor, height: int, width: int) -> Tensor:
    size = torch.tensor([width, height], dtype=kpts.dtype, device=kpts.device)
    return (kpts - size / 2) / (size.max() * 0.7)


class KeypointEncoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.encoder = _mlp((3,) + KENC_LAYERS + (DESC_DIM,))

    def forward(self, kpts: Tensor, scores: Tensor) -> Tensor:
        """kpts (B, K, 2) normalized, scores (B, K) -> (B, 256, K)."""
        return self.encoder(torch.cat([kpts.transpose(1, 2),
                                       scores[:, None]], dim=1))


class MultiHeadedAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.merge = nn.Conv1d(DESC_DIM, DESC_DIM, 1)
        self.proj = nn.ModuleList(nn.Conv1d(DESC_DIM, DESC_DIM, 1)
                                  for _ in range(3))

    def forward(self, x: Tensor, source: Tensor, src_valid: Tensor
                ) -> Tensor:
        """4-head attention of x (B, 256, N) over source (B, 256, M), with
        invalid source slots masked out."""
        B = x.shape[0]
        q, k, v = (proj(t).view(B, _HEAD_DIM, N_HEADS, -1)
                   for proj, t in zip(self.proj, (x, source, source)))
        logits = torch.einsum('bdhn,bdhm->bhnm', q, k) / _HEAD_DIM ** 0.5
        logits = torch.where(src_valid[:, None, None, :], logits, _NEG)
        prob = torch.softmax(logits, dim=-1)
        msg = torch.einsum('bhnm,bdhm->bdhn', prob, v)
        return self.merge(msg.reshape(B, DESC_DIM, -1))


class AttentionalPropagation(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = MultiHeadedAttention()
        self.mlp = _mlp((2 * DESC_DIM, 2 * DESC_DIM, DESC_DIM))

    def forward(self, x, source, src_valid):
        return self.mlp(torch.cat([x, self.attn(x, source, src_valid)], 1))


class AttentionalGNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList(AttentionalPropagation()
                                    for _ in GNN_LAYERS)

    def forward(self, desc0, desc1, valid0, valid1):
        for layer, name in zip(self.layers, GNN_LAYERS):
            if name == 'cross':
                src0, sv0, src1, sv1 = desc1, valid1, desc0, valid0
            else:
                src0, sv0, src1, sv1 = desc0, valid0, desc1, valid1
            delta0 = layer(desc0, src0, sv0)
            delta1 = layer(desc1, src1, sv1)
            desc0, desc1 = desc0 + delta0, desc1 + delta1
        return desc0, desc1


def log_optimal_transport(scores: Tensor, alpha: Tensor, iters: int,
                          valid0: Tensor, valid1: Tensor) -> Tensor:
    """Masked log-space Sinkhorn with a dustbin row and column: invalid
    slots get ~zero marginal mass, and the marginals come from the valid
    counts."""
    b, m, n = scores.shape
    alpha = alpha.to(scores.dtype)
    couplings = torch.cat([
        torch.cat([scores, alpha.expand(b, m, 1)], -1),
        torch.cat([alpha.expand(b, 1, n), alpha.expand(b, 1, 1)], -1)], 1)

    m_eff = valid0.sum(-1).to(scores.dtype)
    n_eff = valid1.sum(-1).to(scores.dtype)
    norm = -torch.log(m_eff + n_eff)
    log_mu = torch.cat([torch.where(valid0, norm[:, None], _NEG),
                        (torch.log(n_eff) + norm)[:, None]], dim=1)
    log_nu = torch.cat([torch.where(valid1, norm[:, None], _NEG),
                        (torch.log(m_eff) + norm)[:, None]], dim=1)
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
    return couplings + u[:, :, None] + v[:, None, :] - norm[:, None, None]


class SuperGlue(nn.Module):
    def __init__(self, device='cuda'):
        super().__init__()
        self.kenc = KeypointEncoder()
        self.gnn = AttentionalGNN()
        self.final_proj = nn.Conv1d(DESC_DIM, DESC_DIM, 1)
        self.register_parameter('bin_score', nn.Parameter(torch.tensor(1.)))
        self.to(device)

    @classmethod
    def from_params(cls, params: dict, device='cuda') -> 'SuperGlue':
        """The module holding a JAX-layout dict's weights."""
        state = {'bin_score': torch.tensor(float(params['bin_score']))}
        for name, conv, bn, heads in _layout():
            w = np.asarray(params[f'{name}_w'], np.float32)
            b = np.asarray(params[f'{name}_b'], np.float32)
            if heads == 'out':
                w, b = w[:, _HEAD_INV], b[_HEAD_INV]
            elif heads == 'in':
                w = w[_HEAD_INV]
            state[f'{conv}.weight'] = torch.from_numpy(
                np.ascontiguousarray(w.T[..., None]))
            state[f'{conv}.bias'] = torch.from_numpy(np.ascontiguousarray(b))
            if bn:
                for ours, theirs in _BN_FIELDS:
                    state[f'{bn}.{theirs}'] = torch.from_numpy(np.asarray(
                        params[f'{name}_bn_{ours}'], np.float32))
                state[f'{bn}.num_batches_tracked'] = torch.tensor(0)
        model = cls(device='cpu')
        model.load_state_dict(state, strict=True)
        return model.to(device).eval()

    @torch.inference_mode()
    def forward(self, data: dict, sinkhorn_iterations: int = 100,
                match_threshold: float = 0.2) -> dict:
        """Matches two keypoint sets. data: keypoints0/1 (B, K, 2),
        scores0/1 (B, K), descriptors0/1 (B, K, 256), valid0/1 (B, K) bool,
        image_shape (H, W). Returns matches0/1 (B, K) (-1: none) and
        matching_scores0/1."""
        H, W = data['image_shape']
        v0, v1 = data['valid0'], data['valid1']
        d0 = data['descriptors0'].transpose(1, 2) + self.kenc(
            normalize_keypoints(data['keypoints0'], H, W), data['scores0'])
        d1 = data['descriptors1'].transpose(1, 2) + self.kenc(
            normalize_keypoints(data['keypoints1'], H, W), data['scores1'])
        d0, d1 = self.gnn(d0, d1, v0, v1)
        m0, m1 = self.final_proj(d0), self.final_proj(d1)
        scores = torch.einsum('bdn,bdm->bnm', m0, m1) / DESC_DIM ** 0.5
        scores = torch.where(v0[:, :, None] & v1[:, None, :], scores, _NEG)
        Z = log_optimal_transport(scores, self.bin_score,
                                  sinkhorn_iterations, v0, v1)

        inner = Z[:, :-1, :-1]
        idx0 = inner.argmax(dim=2)
        idx1 = inner.argmax(dim=1)
        max0 = inner.amax(dim=2)
        ar0 = torch.arange(inner.shape[1], device=inner.device)[None]
        ar1 = torch.arange(inner.shape[2], device=inner.device)[None]
        mutual0 = ar0 == idx1.gather(1, idx0)
        mutual1 = ar1 == idx0.gather(1, idx1)
        zero = torch.zeros((), dtype=Z.dtype, device=Z.device)
        mscores0 = torch.where(mutual0, max0.exp(), zero)
        mscores1 = torch.where(mutual1, mscores0.gather(1, idx1), zero)
        valid_match0 = mutual0 & (mscores0 > match_threshold) & v0
        valid_match1 = mutual1 & valid_match0.gather(1, idx1) & v1
        return {'matches0': torch.where(valid_match0, idx0, -1),
                'matches1': torch.where(valid_match1, idx1, -1),
                'matching_scores0': mscores0, 'matching_scores1': mscores1}
