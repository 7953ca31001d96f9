"""The port's unposed path against the JAX package's, on the CPU.

Each case feeds the same numpy inputs to the JAX function and to its port,
with the tolerance stated there:

* SuperPoint (64x64, ``init_params(0)``, K = 128): the NMS'd score map
  within 1e-5, the valid keypoints as sets, their scores within 1e-5 and
  descriptors within 1e-4; ``simple_nms`` bit for bit;
* SuperGlue (K = 64, invalid slots in both images; 20 and 100 Sinkhorn
  iterations): matches equal, matching scores within 1e-4;
  ``log_optimal_transport`` alone within 1e-4; both nets' weight carriers
  and ``convert_weights`` round-trip an upstream-layout state dict;
* the classical frontend on the known-pose value-noise world pair:
  ``harris_response`` within 1e-6 of max |JAX|, ``detect``'s valid
  keypoints within 1e-4 px, ``describe`` within 1e-5 (border keypoints
  included), ``match_descriptors`` and ``match_pair_classical`` equal;
* ``essential.py`` against cv2 (``findEssentialMat`` / ``recoverPose``, as
  JAX's ``estimate_pose`` calls them): noise-free poses within 0.01
  degrees of the truth and of cv2's where cv2 finds the true pose; JAX's
  gates on noisy matches with outliers; ``recover_pose`` equal to
  ``cv2.recoverPose`` on every E; None below five matches;
* ``unposed.py``: ``scene_from_matches``, ``rotate_interpolate`` and
  ``make_circle`` against JAX's within 1e-5 / 1e-6, ``unposed_scene`` with
  the classical frontend within JAX's pose gates;
* ``cli/render_unposed.py`` end to end on two PNGs with a narrow model:
  its frames against JAX's ``make_image_renderer`` on the same weights and
  trajectory, within test_torch_cli.py's 1e-4 + 1e-4 max(1, max |JAX|).

Two RANSACs with different samples return different poses and inlier
masks from the same noisy matches, as cv2 does against itself on the
same matches in another order. The gates between the port and cv2 on
noisy inputs are therefore JAX's own gates of the truth and cv2's
agreement with itself, not the noise-free tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cross_attention_renderer_tpu.pose.classical as jcl
import cross_attention_renderer_tpu.pose.superglue as jsg
import cross_attention_renderer_tpu.pose.superpoint as jsp
import cross_attention_renderer_tpu.pose.unposed as jup
from cross_attention_renderer_torch.data.synthetic import noise_world_pair
from cross_attention_renderer_torch.pose import classical as pcl
from cross_attention_renderer_torch.pose import essential as pes
from cross_attention_renderer_torch.pose import superglue as psg
from cross_attention_renderer_torch.pose import superpoint as psp
from cross_attention_renderer_torch.pose import unposed as pup
from torch_parity import assert_close
from torch_pose_cases import (K_DEMO, narrow_pair, rot_deg, scene_pair,
                              wide_pair)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def world():
    """The known-pose value-noise world pair, 256x256, demo intrinsics."""
    return noise_world_pair(K_DEMO)


def _jax_nms_scores(params, img):
    """JAX superpoint's score map after NMS (superpoint.py:134-151)."""
    x = jnp.asarray(img)
    for i in range(4):
        x = jsp._conv(params, f'conv{i + 1}a', x)
        x = jsp._conv(params, f'conv{i + 1}b', x)
        if i < 3:
            x = jsp._pool2(x)
    logits = jsp._conv(params, 'convPb', jsp._conv(params, 'convPa', x),
                       relu=False)
    scores = jax.nn.softmax(logits, axis=-1)[..., :-1]
    B, h, w, _ = scores.shape
    scores = scores.reshape(B, h, w, 8, 8).transpose(0, 1, 3, 2, 4)
    return np.asarray(jsp.simple_nms(scores.reshape(B, h * 8, w * 8), 4))


# --------------------------------------------------------------------------
# SuperPoint
# --------------------------------------------------------------------------

def test_simple_nms_matches_jax():
    s = np.zeros((1, 32, 32), np.float32)
    s[0, 10, 10] = 1.0
    s[0, 10, 12] = 0.5
    s[0, 25, 25] = 0.8
    rand = np.random.default_rng(0).uniform(0, 1, (2, 40, 33)).astype(
        np.float32)
    for m in (s, rand):
        got = psp.simple_nms(torch.from_numpy(m), 4).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jsp.simple_nms(jnp.asarray(m), 4)))
    got = psp.simple_nms(torch.from_numpy(s), 4).numpy()
    assert got[0, 10, 10] == 1.0 and got[0, 10, 12] == 0.0
    assert got[0, 25, 25] == 0.8


def test_superpoint_matches_jax():
    params = jsp.init_params(0)
    img = np.random.default_rng(0).uniform(0, 1, (1, 64, 64, 1)).astype(
        np.float32)
    want = {k: np.asarray(v) for k, v in jax.jit(
        jsp.superpoint, static_argnames='max_keypoints')(
        params, jnp.asarray(img), max_keypoints=128).items()}
    model = psp.SuperPoint.from_params(psp.init_params(0), device='cpu')
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    got = {k: v.numpy() for k, v in model(x, max_keypoints=128).items()}
    dense, _ = model.dense(x)
    np.testing.assert_allclose(dense.numpy(), _jax_nms_scores(params, img),
                               atol=1e-5, rtol=0)

    valid_w, valid_g = want['valid'][0], got['valid'][0]
    assert 0 < valid_g.sum() == valid_w.sum() < 128
    # slots sorted by score on each side; paired by position
    for out, valid in ((want, valid_w), (got, valid_g)):
        s = out['scores'][0][valid]
        assert (np.diff(s) <= 0).all()
    order_w = np.lexsort(want['keypoints'][0][valid_w].T)
    order_g = np.lexsort(got['keypoints'][0][valid_g].T)
    np.testing.assert_array_equal(got['keypoints'][0][valid_g][order_g],
                                  want['keypoints'][0][valid_w][order_w])
    np.testing.assert_allclose(got['scores'][0][valid_g][order_g],
                               want['scores'][0][valid_w][order_w],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got['descriptors'][0][valid_g][order_g],
                               want['descriptors'][0][valid_w][order_w],
                               atol=1e-4, rtol=0)


def test_superpoint_weights_round_trip():
    """The JAX dict -> the module (HWIO -> OIHW) -> its state dict, which
    is the upstream layout -> ``convert_weights`` (the port's and JAX's)
    -> the JAX dict; the upstream state dict loads into a fresh module."""
    params = psp.init_params(0)
    for k, v in jsp.init_params(0).items():
        np.testing.assert_array_equal(params[k], v)
    state = psp.SuperPoint.from_params(params, device='cpu').state_dict()
    assert set(state) == {f'{n}.{p}' for n in psp._CONV_NAMES
                          for p in ('weight', 'bias')}
    for back in (psp.convert_weights(state),
                 jsp.convert_weights({k: v.numpy()
                                      for k, v in state.items()})):
        assert set(back) == set(params)
        for k, v in params.items():
            np.testing.assert_array_equal(back[k], v)
    fresh = psp.SuperPoint(device='cpu').eval()
    fresh.load_state_dict(state)
    x = torch.rand(1, 1, 32, 32, generator=torch.Generator().manual_seed(0))
    for a, b in zip(fresh.dense(x), psp.SuperPoint.from_params(
            params, device='cpu').dense(x)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# --------------------------------------------------------------------------
# SuperGlue
# --------------------------------------------------------------------------

def _glue_inputs(K=64, seed=1):
    """Two keypoint sets, the second a noisy shuffled copy of the first,
    with invalid slots in both."""
    rng = np.random.default_rng(seed)
    desc0 = rng.normal(0, 1, (1, K, 256)).astype(np.float32)
    desc0 /= np.linalg.norm(desc0, axis=-1, keepdims=True)
    perm = rng.permutation(K)
    desc1 = desc0[:, perm] + rng.normal(0, 0.05, desc0.shape).astype(
        np.float32)
    desc1 /= np.linalg.norm(desc1, axis=-1, keepdims=True)
    kpts0 = rng.uniform(10, 54, (1, K, 2)).astype(np.float32)
    kpts1 = (kpts0[:, perm] + rng.normal(0, 1, (1, K, 2))).astype(np.float32)
    valid0 = np.ones((1, K), bool)
    valid0[0, -6:] = False
    valid1 = np.ones((1, K), bool)
    valid1[0, rng.choice(K, 9, replace=False)] = False
    return {'keypoints0': kpts0, 'keypoints1': kpts1,
            'scores0': rng.uniform(0.01, 0.9, (1, K)).astype(np.float32),
            'scores1': rng.uniform(0.01, 0.9, (1, K)).astype(np.float32),
            'descriptors0': desc0, 'descriptors1': desc1,
            'valid0': valid0, 'valid1': valid1}


def _torch_data(data, shape):
    out = {k: torch.from_numpy(v) for k, v in data.items()}
    out['image_shape'] = shape
    return out


@pytest.mark.parametrize('iters', [20, 100])
def test_superglue_matches_jax(iters):
    params = jsg.init_params(0)
    data = _glue_inputs()
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    jdata['image_shape'] = (64, 64)
    want = {k: np.asarray(v) for k, v in jax.jit(
        lambda p, d: jsg.superglue(p, dict(d, image_shape=(64, 64)),
                                   sinkhorn_iterations=iters))(
        params, {k: v for k, v in jdata.items() if k != 'image_shape'}
    ).items()}
    model = psg.SuperGlue.from_params(psg.init_params(0), device='cpu')
    got = {k: v.numpy() for k, v in model(
        _torch_data(data, (64, 64)), sinkhorn_iterations=iters).items()}
    for k in ('matches0', 'matches1'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    m0, m1 = got['matches0'][0], got['matches1'][0]
    assert (m0 > -1).sum() > 5
    assert (m0[~data['valid0'][0]] == -1).all()
    assert (m1[~data['valid1'][0]] == -1).all()
    for i, j in enumerate(m0):
        if j >= 0:
            assert m1[j] == i
    for k in ('matching_scores0', 'matching_scores1'):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize('iters', [20, 100])
def test_log_optimal_transport_matches_jax(iters):
    rng = np.random.default_rng(3)
    scores = rng.normal(0, 2, (2, 12, 15)).astype(np.float32)
    valid0 = rng.uniform(size=(2, 12)) > 0.25
    valid1 = rng.uniform(size=(2, 15)) > 0.25
    scores = np.where(valid0[:, :, None] & valid1[:, None, :], scores,
                      -1e9).astype(np.float32)
    want = np.asarray(jsg.log_optimal_transport(
        jnp.asarray(scores), jnp.asarray(np.float32(0.7)), iters,
        jnp.asarray(valid0), jnp.asarray(valid1)))
    got = psg.log_optimal_transport(
        torch.from_numpy(scores), torch.tensor(0.7), iters,
        torch.from_numpy(valid0), torch.from_numpy(valid1)).numpy()
    # the masked entries sit near -1e9 + O(1): compare the live ones
    live = np.zeros(want.shape, bool)
    live[:, :-1, :-1] = valid0[:, :, None] & valid1[:, None, :]
    live[:, :-1, -1] = valid0
    live[:, -1, :-1] = valid1
    live[:, -1, -1] = True
    np.testing.assert_allclose(got[live], want[live], atol=1e-4, rtol=0)
    assert (got[~live] < -1e8).all()


def test_superglue_weights_round_trip():
    """The JAX dict -> the module (its head split permuted back) -> its
    state dict, the upstream layout with all five keypoint-encoder layers
    -> ``convert_weights`` -> the JAX dict, bit for bit."""
    params = psg.init_params(0)
    for k, v in jsg.init_params(0).items():
        np.testing.assert_array_equal(params[k], v)
    state = psg.SuperGlue.from_params(params, device='cpu').state_dict()
    assert 'kenc.encoder.12.weight' in state
    assert state['gnn.layers.3.attn.proj.1.weight'].shape == (256, 256, 1)
    back = psg.convert_weights(state)
    assert set(back) == set(params)
    for k, v in params.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    fresh = psg.SuperGlue(device='cpu').eval()
    fresh.load_state_dict(state)
    data = _torch_data(_glue_inputs(K=16, seed=2), (64, 64))
    want = psg.SuperGlue.from_params(params, device='cpu')(
        data, sinkhorn_iterations=5)
    got = fresh(data, sinkhorn_iterations=5)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, atol=0, rtol=0)


def test_match_pair_matches_jax(monkeypatch):
    """``match_pair`` (SuperPoint -> SuperGlue, then numpy) on a 64x64
    pair, K = 64, 20 iterations, threshold 0.05; JAX's two nets compiled (its
    ``match_pair`` calls them eagerly)."""
    monkeypatch.setattr(jsp, 'superpoint', jax.jit(
        jsp.superpoint, static_argnames='max_keypoints'))
    monkeypatch.setattr(jsg, 'superglue', jax.jit(
        jsg.superglue, static_argnames=('sinkhorn_iterations',
                                        'match_threshold')))
    rng = np.random.default_rng(4)
    im0 = rng.uniform(0, 1, (64, 64)).astype(np.float32)
    im1 = np.roll(im0, (2, 3), axis=(0, 1))
    sp, sg = jsp.init_params(0), jsg.init_params(1)
    # random weights give no match above the demo's 0.2
    want = jup.match_pair(sp, sg, im0, im1, max_keypoints=64,
                          match_threshold=0.05)
    got = pup.match_pair(psp.SuperPoint.from_params(sp, device='cpu'),
                         psg.SuperGlue.from_params(sg, device='cpu'),
                         im0, im1, max_keypoints=64, match_threshold=0.05)
    valid = want['matches'] > -1
    assert valid.sum() > 5
    np.testing.assert_array_equal(got['matches'] > -1, valid)
    # matched slots are valid keypoints: compare them, not the padding
    for k in ('mkpts0', 'mkpts1'):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got['mconf'], want['mconf'], atol=1e-4)


# --------------------------------------------------------------------------
# Classical frontend
# --------------------------------------------------------------------------

def test_harris_response_matches_jax(world):
    for g in world[:2]:
        want = np.asarray(jcl.harris_response(jnp.asarray(g)))
        got = pcl.harris_response(torch.from_numpy(g)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(),
                                   rtol=0)
        np.testing.assert_array_equal(
            torch.gradient(torch.from_numpy(g))[1].numpy(),
            np.asarray(jnp.gradient(jnp.asarray(g), axis=1)))


def test_detect_and_describe_match_jax(world):
    g = world[0]
    kj, sj, vj = (np.asarray(a) for a in jax.jit(
        jcl.detect, static_argnums=1)(jnp.asarray(g), 512))
    kg, sg, vg = (a.numpy() for a in pcl.detect(torch.from_numpy(g), 512))
    np.testing.assert_array_equal(vg, vj)
    assert vg.sum() > 100
    np.testing.assert_allclose(kg[vg], kj[vj], atol=1e-4, rtol=0)
    np.testing.assert_allclose(sg[vg], sj[vj], atol=1e-6 * sj[0], rtol=0)
    # border keypoints: a patch that would leave the image at the right or
    # bottom edge starts at the last position inside it, in both packages
    kpts = np.concatenate([kj, np.array([[7.0, 7.0], [255.4, 250.0],
                                         [120.0, 262.0], [249.0, 7.2]],
                                        np.float32)])
    want = np.asarray(jax.jit(jcl.describe)(jnp.asarray(g),
                                            jnp.asarray(kpts)))
    got = pcl.describe(torch.from_numpy(g), torch.from_numpy(kpts)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1, atol=1e-5)
    # at the top or left edge the port clamps the start to 0, as the JAX
    # docstring intends; JAX's dynamic_slice there first wraps a negative
    # start to the far side (its negative-index rule), which ``detect``
    # never meets (border 12 > patch radius 7)
    got = pcl.describe(torch.from_numpy(g), torch.tensor(
        [[0.0, 0.0], [-3.0, 100.0]])).numpy()
    for d, (y, x) in zip(got, ((0, 0), (93, 0))):
        v = g[y:y + 15, x:x + 15].ravel() - g[y:y + 15, x:x + 15].mean()
        np.testing.assert_allclose(d, v / np.linalg.norm(v), atol=1e-6)


def test_match_descriptors_and_pair_match_jax(world):
    g0, g1 = world[:2]
    d, v = [], []
    for g in (g0, g1):
        k, _, valid = jax.jit(jcl.detect, static_argnums=1)(
            jnp.asarray(g), 512)
        d.append(np.asarray(jax.jit(jcl.describe)(jnp.asarray(g), k)))
        v.append(np.asarray(valid))
    want = jcl.match_descriptors(*(jnp.asarray(a) for a in (*d, *v)))
    got = pcl.match_descriptors(*(torch.from_numpy(a) for a in (*d, *v)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-6)
    want = jcl.match_pair_classical(g0, g1)
    got = pcl.match_pair_classical(g0, g1, device='cpu')
    assert len(got['mkpts0']) > 60
    np.testing.assert_array_equal(got['matches'], want['matches'])
    for k in ('mkpts0', 'mkpts1', 'keypoints0', 'keypoints1'):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)


# --------------------------------------------------------------------------
# Five-point RANSAC and pose recovery
# --------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['wide0', 'wide1', 'scene'])
def test_essential_noise_free_matches_cv2(case):
    pytest.importorskip('cv2')
    k0, k1, R, t = (scene_pair() if case == 'scene'
                    else wide_pair(int(case[-1])))
    got = pup.estimate_pose(k0, k1, K_DEMO, K_DEMO)
    want = jup.estimate_pose(k0, k1, K_DEMO, K_DEMO)
    t_dir = t / np.linalg.norm(t)
    assert rot_deg(got[0], R) < 0.01 and rot_deg(got[0], want[0]) < 0.01
    assert rot_deg(want[0], R) < 0.01
    assert got[1] @ t_dir > 0.9999 and got[1] @ want[1] > 0.9999
    assert got[2].all() and want[2].all()


def test_essential_narrow_view_noise_free():
    """tests/test_pose.py:71-99's input: the port finds the true pose.
    cv2 keeps a wrong root of its first sample there, one that fits all
    200 matches within the threshold (JAX's test allows 5 degrees and
    notes ~0.56 of the matches passing cheirality). Both meet JAX's
    gates."""
    pytest.importorskip('cv2')
    k0, k1, R, t = narrow_pair()
    t_dir = t / np.linalg.norm(t)
    got = pup.estimate_pose(k0, k1, K_DEMO, K_DEMO, thresh=1.0)
    assert rot_deg(got[0], R) < 0.01 and got[1] @ t_dir > 0.9999
    for R_est, t_est, inliers in (got, jup.estimate_pose(
            k0, k1, K_DEMO, K_DEMO, thresh=1.0)):
        assert inliers.mean() > 0.3
        assert rot_deg(R_est, R) < 5.0
        assert abs(float(t_est @ t_dir)) > 0.95


def test_essential_noisy_with_outliers():
    """0.5 px noise, 20% outliers, six seeds: JAX's gates of the truth
    (test_pose.py:71-99: 5 degrees, |t.t_true| > 0.95), and inlier masks
    that agree with cv2's as well as cv2's agree with its own on the same
    matches in another order (mean over the seeds, 0.03 of slack)."""
    pytest.importorskip('cv2')
    agree, self_agree = [], []
    for seed in range(6):
        k0, k1, R, t = wide_pair(seed, noise=0.5, outliers=0.2)
        t_dir = t / np.linalg.norm(t)
        got = pup.estimate_pose(k0, k1, K_DEMO, K_DEMO)
        want = jup.estimate_pose(k0, k1, K_DEMO, K_DEMO)
        perm = np.random.default_rng(100 + seed).permutation(len(k0))
        again = jup.estimate_pose(k0[perm], k1[perm], K_DEMO, K_DEMO)
        assert rot_deg(got[0], R) < 5.0 and abs(got[1] @ t_dir) > 0.95
        assert got[2][:60].sum() <= 3        # the outliers stay out
        agree.append((got[2] == want[2]).mean())
        self_agree.append((again[2][np.argsort(perm)] == want[2]).mean())
    assert min(agree) > 0.7
    assert np.mean(agree) >= np.mean(self_agree) - 0.03, (agree, self_agree)


def test_essential_few_matches():
    """Below five matches: None, as JAX. Exactly five: every solution,
    stacked, as cv2 returns them, and estimate_pose's pass over them
    (each recovered from the mask the previous one left) equals JAX's."""
    cv2 = pytest.importorskip('cv2')
    k0, k1, _, _ = wide_pair(0, n=5)
    assert pup.estimate_pose(k0[:4], k1[:4], K_DEMO, K_DEMO) is None
    assert jup.estimate_pose(k0[:4], k1[:4], K_DEMO, K_DEMO) is None
    x0, x1 = (k0 - 128) / 225, (k1 - 128) / 225
    E, mask = pes.find_essential_mat(x0, x1, 1 / 225, 0.99999)
    E_cv, mask_cv = cv2.findEssentialMat(x0, x1, np.eye(3), threshold=1 / 225,
                                         prob=0.99999, method=cv2.RANSAC)
    assert E.shape == E_cv.shape and E.shape[0] > 3
    np.testing.assert_array_equal(mask.ravel() > 0, mask_cv.ravel() > 0)
    sols = [e / np.linalg.norm(e) for e in np.split(E_cv, len(E_cv) // 3)]

    def nearest(e, candidates):
        return min(min(np.abs(e - c).max(), np.abs(e + c).max())
                   for c in candidates)

    mine = np.split(E, len(E) // 3)
    assert max(nearest(e_cv, mine) for e_cv in sols) < 1e-6
    # five matches fit every solution exactly, so which one wins depends on
    # the solutions' order: the port's pose is one of cv2's solutions
    R_got, t_got, inliers = pup.estimate_pose(k0, k1, K_DEMO, K_DEMO)
    tx = np.array([[0, -t_got[2], t_got[1]], [t_got[2], 0, -t_got[0]],
                   [-t_got[1], t_got[0], 0]])
    assert nearest(tx @ R_got / np.linalg.norm(tx @ R_got), sols) < 1e-6
    np.testing.assert_array_equal(
        inliers, jup.estimate_pose(k0, k1, K_DEMO, K_DEMO)[2])


def test_recover_pose_matches_cv2(world):
    """The four-way decomposition, triangulation and cheirality count
    against cv2.recoverPose on cv2's own E and mask: the noisy case's E,
    the classical world pair's E, and each stacked E of a five-match
    sample, chained through the mask as JAX's loop chains them."""
    cv2 = pytest.importorskip('cv2')
    cases = []
    for k0, k1 in (wide_pair(2, noise=0.5, outliers=0.2)[:2],
                   wide_pair(3, n=5)[:2]):
        cases.append(((k0 - 128) / 225, (k1 - 128) / 225))
    m = jcl.match_pair_classical(*world[:2])
    cases.append(tuple((m[k].astype(np.float64) - 128) / 225
                       for k in ('mkpts0', 'mkpts1')))
    for x0, x1 in cases:
        E, mask = cv2.findEssentialMat(x0, x1, np.eye(3), threshold=1 / 225,
                                       prob=0.99999, method=cv2.RANSAC)
        mine = mask.copy()
        for e in np.split(E, len(E) // 3):
            # as JAX calls it: 1e9 lands on the R output of the overload
            # without a distance, which uses 50
            n, R, t, mine = pes.recover_pose(e, x0, x1, 50.0, mask=mine)
            n_cv, R_cv, t_cv, _ = cv2.recoverPose(e, x0, x1, np.eye(3), 1e9,
                                                  mask=mask)
            assert n == n_cv
            np.testing.assert_allclose(R, R_cv, atol=1e-9)
            np.testing.assert_allclose(t, t_cv, atol=1e-9)
            np.testing.assert_array_equal(mine.ravel() > 0, mask.ravel() > 0)
            far = np.ones_like(mask)
            n_cv, R_cv, t_cv, _, _ = cv2.recoverPose(
                e, x0, x1, np.eye(3), distanceThresh=1e9, mask=far)
            n, R, t, got = pes.recover_pose(e, x0, x1, 1e9, np.ones_like(far))
            assert n == n_cv
            np.testing.assert_allclose(R, R_cv, atol=1e-9)
            np.testing.assert_array_equal(got.ravel() > 0, far.ravel() > 0)


# --------------------------------------------------------------------------
# Trajectory and scene assembly
# --------------------------------------------------------------------------

def test_scene_from_matches_matches_jax():
    pytest.importorskip('cv2')
    k0, k1, _, _ = scene_pair()
    im = np.random.default_rng(5).uniform(0, 1, (256, 256, 3))
    want = jup.scene_from_matches(k0, k1, im, im, n_poses=80, sf=1.2)
    got = pup.scene_from_matches(k0, k1, im, im, n_poses=80, sf=1.2)
    for part in ('context', 'query'):
        assert sorted(got[part]) == sorted(want[part])
        for k, w in want[part].items():
            assert got[part][k].shape == w.shape and (
                got[part][k].dtype == w.dtype), (part, k)
            np.testing.assert_allclose(got[part][k], w, atol=1e-5, rtol=0,
                                       err_msg=f'{part} {k}')
    assert want['query']['cam2world'].shape == (1, 76, 4, 4)


def test_rotate_interpolate_and_make_circle_match_jax():
    for d in ([1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0],
              [0.6, 0.8, 0], [0.3, -0.2, 0.9]):
        d = np.asarray(d) / np.linalg.norm(d)
        got = pup.make_circle(d, 16)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, jup.make_circle(d, 16), atol=1e-6)
    rng = np.random.default_rng(6)
    from scipy.spatial.transform import Rotation
    for baseline in ([1.0, 0, 0], rng.normal(size=3)):
        p1 = np.eye(4)
        p1[:3, :3] = Rotation.from_rotvec(rng.normal(0, 0.2, 3)).as_matrix()
        p1[:3, 3] = baseline
        poses = np.stack([np.eye(4), p1])
        got = pup.rotate_interpolate(poses, 80)
        assert got.shape == (76, 4, 4)
        np.testing.assert_allclose(got, jup.rotate_interpolate(poses, 80),
                                   atol=1e-6)


def test_unposed_scene_classical_matches_jax(world):
    """The classical frontend's scene on the world pair: the same images,
    uv grid and intrinsics as JAX's; the context cameras within JAX's own
    gates of the truth (2 degrees, direction cosine 0.98,
    test_classical_matcher.py) and within 3 degrees of JAX's (each
    RANSAC's sample spread, see the module docstring)."""
    pytest.importorskip('cv2')
    g0, g1, c2w0, c2w1 = world
    im0, im1 = (np.repeat(g[..., None], 3, -1) for g in (g0, g1))
    want = jup.unposed_scene(None, None, im0, im1)
    got = pup.unposed_scene(None, None, im0, im1, device='cpu')
    for part, k in (('context', 'rgb'), ('context', 'intrinsics'),
                    ('query', 'uv'), ('query', 'intrinsics'),
                    ('query', 'rgb')):
        np.testing.assert_allclose(got[part][k], want[part][k], atol=1e-6)
    c2w, c2w_jax = got['context']['cam2world'][0], want['context'][
        'cam2world'][0]
    np.testing.assert_array_equal(c2w[0], np.eye(4))
    rel_gt = np.linalg.inv(c2w0) @ c2w1
    assert rot_deg(c2w[1, :3, :3], rel_gt[:3, :3]) < 2.0
    assert rot_deg(c2w[1, :3, :3], c2w_jax[1, :3, :3]) < 3.0
    t_dir = rel_gt[:3, 3] / np.linalg.norm(rel_gt[:3, 3])
    assert c2w[1, :3, 3] @ t_dir / np.linalg.norm(c2w[1, :3, 3]) > 0.98
    np.testing.assert_allclose(np.linalg.norm(c2w[1, :3, 3]), 1 / 1.2,
                               rtol=1e-6)
    assert got['query']['cam2world'].shape == (1, 76, 4, 4)


# --------------------------------------------------------------------------
# The CLI
# --------------------------------------------------------------------------

TINY = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
            vit_heads=2, resnet_layers=(1, 1, 1))
TINY_FLAGS = ['--fusion_features', '32', '--vit_width', '64',
              '--vit_depth', '2', '--vit_heads', '2',
              '--resnet_layers', '1', '1', '1', '--npoints', '8',
              '--device', 'cpu']


def _shrink(traj: dict, size: int = 32) -> dict:
    """The scene every (256 / size)-th pixel of the way: context images
    subsampled, intrinsics divided by the step, a size^2 query grid."""
    step = traj['context']['rgb'].shape[-3] // size
    out = {part: dict(traj[part]) for part in ('context', 'query')}
    out['context']['rgb'] = traj['context']['rgb'][:, :, ::step, ::step]
    for part in ('context', 'query'):
        k = traj[part]['intrinsics'].copy()
        k[..., :2, :] /= step
        out[part]['intrinsics'] = k
    i, j = np.meshgrid(np.arange(size), np.arange(size), indexing='xy')
    uv = np.stack([i, j], -1).reshape(-1, 2).astype(np.float32)
    n = traj['query']['cam2world'].shape[1]
    out['query']['uv'] = np.broadcast_to(uv, (1, n) + uv.shape)
    out['query']['rgb'] = out['context']['rgb'][:, :1].repeat(n, 1)
    return out


def test_render_unposed_cli_matches_jax(world, tmp_path, monkeypatch):
    """``cli/render_unposed.py`` on two PNGs of the world pair with a
    narrow model (a port checkpoint of random JAX weights): matching and
    the pose at 256x256, then 2 frames of the trajectory's scene cut to
    32x32 (every 8th pixel; a 256x256 frame of this model takes ~30 s on
    one CPU thread) in 4 ray blocks, against JAX's
    ``make_image_renderer`` on the same weights and scene."""
    imageio = pytest.importorskip('imageio.v2')
    from cross_attention_renderer_tpu.data import make_scene as jax_scene
    from cross_attention_renderer_tpu.models import (
        CrossAttentionRenderer as JaxRenderer)
    from cross_attention_renderer_tpu.train import evaluation as JE
    from cross_attention_renderer_torch.cli import render_unposed as RU
    from cross_attention_renderer_torch.convert import params_from_jax
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, create_train_state, save_checkpoint)
    from torch_parity import random_flax_params

    paths = []
    for i, g in enumerate(world[:2]):
        paths.append(str(tmp_path / f'im{i}.png'))
        imageio.imwrite(paths[-1], (np.repeat(g[..., None], 3, -1) * 255
                                    ).astype(np.uint8))
    jax_model = JaxRenderer(n_view=2, fused_epilogue=True,
                            fused_attention=False, **TINY)
    params = random_flax_params(jax_model, 0, jax_scene(6, H=32, W=32,
                                                        n_rays=8))
    model = CrossAttentionRenderer(device='cpu', **TINY)
    model.load_state_dict(params_from_jax(params), strict=True)
    ckpt = save_checkpoint(tmp_path / 'ckpt',
                           create_train_state(model, TrainConfig()))

    frames, scenes = [], []
    to_uint8 = RU.to_uint8
    monkeypatch.setattr(RU, 'to_uint8', lambda x: (
        frames.append(x.numpy().copy()), to_uint8(x))[1])
    unposed_scene = RU.unposed_scene
    monkeypatch.setattr(RU, 'unposed_scene', lambda *a, **k: (
        scenes.append(_shrink(unposed_scene(*a, **k))), scenes[-1])[1])
    res = RU.main(['--im1', paths[0], '--im2', paths[1], '--n_frames', '6',
                   '--ray_chunk', '256', '--out', str(tmp_path / 'u.mp4'),
                   '--checkpoint_path', str(ckpt), *TINY_FLAGS])
    assert res['frames'] == 2 and len(frames) == 2

    traj = scenes[0]
    encode, render_image = JE.make_image_renderer(jax_model, params, 4)

    def frame_scene(i):
        return {'context': traj['context'],
                'query': {k: traj['query'][k][:, i:i + 1]
                          for k in ('cam2world', 'intrinsics', 'uv')}}

    z = encode(frame_scene(0))
    for i, got in enumerate(frames):
        rgb, _ = render_image(frame_scene(i), z)
        want = (np.asarray(rgb).reshape(32, 32, 3) + 1) * 0.5
        assert_close(f'frame {i}', got, want, atol=1e-4, rtol=1e-4)


def test_render_unposed_one_weights_file_raises(tmp_path):
    from cross_attention_renderer_torch.cli import render_unposed as RU
    npz = tmp_path / 'sp.npz'
    np.savez(npz, **psp.init_params(0))
    with pytest.raises(SystemExit, match='must be given together'):
        RU.main(['--im1', 'a.png', '--im2', 'b.png',
                 '--superpoint_weights', str(npz), *TINY_FLAGS])
