"""The port's geometry against the JAX package and the golden fixtures.

Fixtures: tests/fixtures/geometry_golden.npz and ef_golden.npz (f64 oracle
of the reference), with test_geometry.py's tolerances. Against JAX: the
same f32 numpy inputs through both, tolerance 1e-5 relative to scale (the
same f32 formulas; only the order of a few sums differs).
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu import geometry as JG
from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_torch.geometry import epipolar as E
from cross_attention_renderer_torch.geometry import rays as G
from torch_parity import assert_close

FIX = pathlib.Path(__file__).parent / 'fixtures'


@pytest.fixture(scope='module')
def gold():
    return dict(np.load(FIX / 'geometry_golden.npz', allow_pickle=False))


def t32(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def test_plucker_and_ray_directions(gold):
    np.testing.assert_allclose(
        G.plucker_embedding(t32(gold['c2w']), t32(gold['uv_pix']),
                            t32(gold['intr'])), gold['plucker'],
        atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(
        G.ray_directions(t32(gold['uv_pix']), t32(gold['c2w']),
                         t32(gold['intr'])), gold['ray_dirs'], atol=2e-5)
    B, R, P, _ = gold['uv_ndc'].shape
    np.testing.assert_allclose(
        G.ray_directions_cam(t32(gold['uv_ndc'].reshape(B, R * P, 2)),
                             t32(gold['intr']), int(gold['H']),
                             int(gold['W'])), gold['ray_dirs_cam'],
        atol=2e-5)


def test_project_and_lift(gold):
    np.testing.assert_allclose(
        G.project_pinhole(t32(gold['pts_cam']), t32(gold['intr'])),
        gold['projected'], atol=1e-2, rtol=1e-5)
    z = torch.full(gold['uv_pix'].shape[:-1], 1.5)
    np.testing.assert_allclose(
        G.lift(t32(gold['uv_pix'][..., 0]), t32(gold['uv_pix'][..., 1]), z,
               t32(gold['intr'])), gold['lifted'], atol=1e-5)


def test_epipolar_point_3d(gold):
    B = gold['c2w'].shape[0]
    pt, dist, _ = G.epipolar_point_3d(
        t32(gold['plucker']), t32(gold['uv_ndc']), torch.eye(4).expand(
            B, 4, 4), int(gold['H']), int(gold['W']), t32(gold['intr']))
    ref_pt = gold['epi_pt']
    ok = np.linalg.norm(ref_pt, axis=-1) < 100
    scale = np.maximum(np.linalg.norm(ref_pt, axis=-1, keepdims=True), 1.0)
    np.testing.assert_allclose((pt.numpy() / scale)[ok],
                               (ref_pt / scale)[ok], atol=5e-3)
    ref_d = gold['epi_dist'][..., 0]
    okd = ok & (ref_d < 100)
    np.testing.assert_allclose(
        dist[..., 0].numpy()[okd] / np.maximum(ref_d[okd], 1.0),
        ref_d[okd] / np.maximum(ref_d[okd], 1.0), atol=5e-3)


def test_project_rays_identity_extrinsics(gold):
    res = E.project_rays(t32(gold['pr_origins']), t32(gold['pr_dirs']),
                         torch.eye(4).expand(*gold['c2w'].shape),
                         t32(gold['pr_intr_norm']))
    ov = gold['pr_overlap']
    np.testing.assert_array_equal(res.overlaps_image.numpy(), ov)
    np.testing.assert_allclose(res.xy_min.numpy()[ov], gold['pr_xymin'][ov],
                               atol=2e-4)
    np.testing.assert_allclose(res.xy_max.numpy()[ov], gold['pr_xymax'][ov],
                               atol=2e-4)


def test_project_rays_general_extrinsics(gold):
    res = E.project_rays(t32(gold['pr_origins']), t32(gold['pr_dirs']),
                         t32(gold['c2w2']), t32(gold['pr_intr_norm']))
    agree = res.overlaps_image.numpy() == gold['pr2_overlap']
    assert agree.mean() > 0.99
    ov = gold['pr2_overlap'] & agree
    np.testing.assert_allclose(res.xy_min.numpy()[ov], gold['pr2_xymin'][ov],
                               atol=1e-3)
    np.testing.assert_allclose(res.xy_max.numpy()[ov], gold['pr2_xymax'][ov],
                               atol=1e-3)


def test_transform_points_roundtrip(gold):
    pts, c2w = t32(gold['pts_cam']), t32(gold['c2w'])[:, None]
    back = G.points_to_cam(G.transform_points(pts, c2w), c2w)
    np.testing.assert_allclose(back.numpy(), pts.numpy(), atol=1e-4)


def test_essential_fundamental_matrices(gold):
    ef = np.load(FIX / 'ef_golden.npz')
    np.testing.assert_allclose(
        G.essential_matrix(t32(gold['c2w']), t32(gold['c2w2'])).numpy(),
        ef['E'], atol=1e-5)
    np.testing.assert_allclose(
        G.fundamental_matrix(t32(gold['c2w']), t32(gold['c2w2']),
                             t32(gold['intr']), t32(gold['intr2'])).numpy(),
        ef['F'], atol=1e-5)


# ---------------------------------------------------------------------------
# Against the JAX functions on a renderer-like input.
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def rays():
    """Query rays of a synthetic scene in each context frame, as the
    renderer builds them (renderer.py:275-331), in numpy f32."""
    s = jax_scene(5, H=32, W=32, n_rays=24)
    c2w = np.asarray(s['context']['cam2world'])[0]            # (V, 4, 4)
    q2w = np.asarray(s['query']['cam2world'])[0, 0]
    qc = (np.linalg.inv(c2w) @ q2w).astype(np.float32)         # (V, 4, 4)
    V, R = c2w.shape[0], 24
    uv = np.broadcast_to(np.asarray(s['query']['uv'])[0], (V, R, 2))
    K = np.broadcast_to(np.asarray(s['query']['intrinsics'])[0], (V, 4, 4))
    intr_norm = K.copy()
    intr_norm[:, :2] /= 32
    rng = np.random.default_rng(0)
    return {'qc': qc, 'uv': np.ascontiguousarray(uv, np.float32),
            'K': np.ascontiguousarray(K, np.float32),
            'intr_norm': intr_norm.astype(np.float32),
            'ndc': rng.uniform(-1.2, 1.2, (V, R, 8, 2)).astype(np.float32)}


def _both(fn_name, module_j, module_t, *args):
    got = getattr(module_t, fn_name)(*[t32(a) if isinstance(a, np.ndarray)
                                       else a for a in args])
    want = getattr(module_j, fn_name)(*[jnp.asarray(a)
                                        if isinstance(a, np.ndarray)
                                        else a for a in args])
    return got, want


def test_plucker_segments_and_points_match_jax(rays):
    lf, lf_j = _both('plucker_embedding', JG, G, rays['qc'], rays['uv'],
                     rays['K'])
    assert_close('plucker', lf, lf_j, atol=1e-5, rtol=1e-5)
    lf_np = lf.numpy()
    origins = np.ascontiguousarray(np.broadcast_to(
        rays['qc'][:, None, :3, 3], lf_np.shape[:2] + (3,)))
    seg, seg_j = _both('epipolar_segments_ndc', JG, E, origins,
                       np.ascontiguousarray(lf_np[..., :3]),
                       rays['intr_norm'])
    for name, a, b in zip(('start', 'end', 'valid'), seg, seg_j):
        assert_close(name, a, b, atol=1e-4, rtol=1e-5)
    assert 0 < float(seg[2].mean()) <= 1
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
    pt, pt_j = _both('epipolar_point_3d', JG, G, lf_np, rays['ndc'], eye,
                     32, 32, rays['K'])
    assert_close('epipolar_point_3d', pt[0], pt_j[0], atol=1e-3, rtol=1e-4)
    np.testing.assert_array_equal(pt[2].numpy(), np.asarray(pt_j[2]))


@pytest.mark.parametrize('fn', ['project_pinhole', 'transform_points'])
def test_point_maps_match_jax(rays, fn):
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 2, (2, 24, 3)).astype(np.float32)
    pts[0, 0] = [1.0, 1.0, 0.0]                # zero depth: far sentinel
    arg = rays['K'] if fn == 'project_pinhole' else rays['qc'][:, None]
    got, want = _both(fn, JG, G, pts, arg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
