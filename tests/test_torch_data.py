"""The port's data layer against the JAX package's, on the CPU.

One corpus, written by both packages' writers (the JAX package's
``tools/make_corpus.py`` and ``tools/make_co3d_corpus.py``, the port's
``cross_attention_renderer_torch/tools/``) at one seed, is read through
both packages' loaders: items, trajectories and batches must be equal,
arrays exactly and floats within 1e-6 (both run the same numpy
arithmetic; the tolerance only covers a float printed through torch).
Frames are cut to 64x114 (the loaders' crop to 64) on both sides, as the
JAX package's CLI tests cut them. The loaders' two routes are both held:
the native frame decoder (``native/dataloader.cc``; the port builds its
own copy) and the numpy route with the nearest-neighbour resize (cv2's
flag patched off on both sides, so the comparison does not depend on
cv2).
"""

import gzip
import hashlib
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import loadmat

from cross_attention_renderer_tpu.data import acid as JA
from cross_attention_renderer_tpu.data import co3d as JC
from cross_attention_renderer_tpu.data import download as JD
from cross_attention_renderer_tpu.data import native_loader as JN
from cross_attention_renderer_tpu.data import realestate as JR
from cross_attention_renderer_tpu.data import synthetic as JS
from cross_attention_renderer_torch.data import acid as PA
from cross_attention_renderer_torch.data import co3d as PC
from cross_attention_renderer_torch.data import download as PD
from cross_attention_renderer_torch.data import native_loader as PN
from cross_attention_renderer_torch.data import realestate as PR
from cross_attention_renderer_torch.data import synthetic as PS
from cross_attention_renderer_torch.tools import make_co3d_corpus as PMC
from cross_attention_renderer_torch.tools import make_corpus as PM

ROOT = Path(__file__).resolve().parents[1]
FRAME_HW = (64, 114)        # the corpus' frames; the loaders crop to 64
NATIVE_SO = ROOT / 'native' / 'libdataloader.so'
NATIVE_SO_SHA = hashlib.sha1(NATIVE_SO.read_bytes()).hexdigest()


def _jax_tool(name):
    """The JAX package's ``tools/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(
        f'jax_tools_{name}', ROOT / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_same(a, b, where='item'):
    """Nested dicts of arrays (and strings) equal: ints and bools exactly,
    floats within 1e-6."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), (where, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f'{where}.{k}')
        return
    if isinstance(a, str):
        assert a == b, where
        return
    x, y = _np(a), _np(b)
    assert x.shape == y.shape, (where, x.shape, y.shape)
    if np.issubdtype(x.dtype, np.floating):
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=where)
    else:
        np.testing.assert_array_equal(x, y, err_msg=where)


@pytest.fixture(scope='module')
def small_frames():
    """Both packages' loaders and writers at 64x114 frames for the
    module."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (JR, PR):
            mp.setattr(mod, 'IMG_H', FRAME_HW[0])
            mp.setattr(mod, 'IMG_W', FRAME_HW[1])
            mp.setattr(mod, 'CROP', FRAME_HW[0])
        yield mp


@pytest.fixture(scope='module')
def corpora(tmp_path_factory, small_frames):
    """The noise corpus (2 scenes and the 6 defect scenes) written by each
    package's writer: {'port': root, 'jax': root}."""
    roots = {}
    for side, mod in (('port', PM), ('jax', _jax_tool('make_corpus'))):
        small_frames.setattr(mod, 'H', FRAME_HW[0])
        small_frames.setattr(mod, 'W', FRAME_HW[1])
        root = tmp_path_factory.mktemp(f'corpus_{side}')
        argv = ['--root', str(root), '--scenes', '2', '--seed_base', '3']
        if side == 'port':
            mod.main(argv)
        else:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr('sys.argv', ['make_corpus.py', *argv])
                mod.main()
        roots[side] = root
    return roots


@pytest.fixture(scope='module')
def corpus(corpora):
    root = corpora['port']
    return root / 'frames', root / 'poses.mat'


def test_corpus_writers_write_the_same_files(corpora):
    """Every file of the two corpora holds the same arrays (the npz
    members; the pose tables; the truncated archive is the same bytes)."""
    a, b = corpora['port'], corpora['jax']
    files = sorted(p.relative_to(a) for p in a.rglob('*') if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob('*')
                           if p.is_file())
    assert len(files) == 9     # 7 archives, the pose table and its part
    for f in files:
        if 'truncated' in str(f):
            assert (a / f).read_bytes() == (b / f).read_bytes()
        elif f.suffix == '.npz':
            with np.load(a / f) as x, np.load(b / f) as y:
                assert_same(dict(x), dict(y), str(f))
        else:
            x, y = loadmat(a / f), loadmat(b / f)
            assert_same({k: v for k, v in x.items() if '__' not in k},
                        {k: v for k, v in y.items() if '__' not in k},
                        str(f))


def test_boxes_world_writers_agree(tmp_path, monkeypatch):
    """The 'boxes' world: the frames are renders of the port's
    ``_render_boxes`` on one side and the JAX package's on the other."""
    out = {}
    for side, mod in (('port', PM), ('jax', _jax_tool('make_corpus'))):
        monkeypatch.setattr(mod, 'H', 24)
        monkeypatch.setattr(mod, 'W', 40)
        argv = ['--root', str(tmp_path / side), '--scenes', '1',
                '--frames', '3', '--world', 'boxes', '--defects', '0']
        if side == 'port':
            mod.main(argv)
        else:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr('sys.argv', ['make_corpus.py', *argv])
                mod.main()
        with np.load(tmp_path / side / 'frames' / 'scene0000' /
                     'data.npz') as z:
            out[side] = dict(z)
        out[side]['poses'] = loadmat(tmp_path / side / 'poses.mat')[
            'scene0000']
    assert_same(out['port'], out['jax'])


@pytest.fixture(params=['native', 'numpy'])
def route(request, small_frames):
    """Both packages' loaders on the native route, or on the numpy route
    with the nearest-neighbour resize."""
    if request.param == 'native':
        if not (PN.available() and JN.available()):
            pytest.skip('no C++ compiler for the native loader')
    else:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JR, '_HAS_CV2', False)
            mp.setattr(PR, '_HAS_CV2', False)
            yield request.param
        return
    yield request.param


def _datasets(jax_cls, port_cls, corpus, route, **kw):
    a, b = jax_cls(*corpus, **kw), port_cls(*corpus, **kw)
    for ds in (a, b):
        ds.store.use_native = route == 'native'
    return a, b


@pytest.mark.parametrize('kw', [
    dict(num_ctxt_views=2, query_sparsity=192, augment=True, seed=1),
    dict(num_ctxt_views=2, query_sparsity=192, augment=True, lpips=True,
         seed=2),
    dict(num_ctxt_views=2, query_sparsity=None, augment=False, seed=3),
], ids=['augment', 'lpips', 'whole_query'])
def test_realestate_items_equal_jax(corpus, route, kw):
    """Every index (the defect scenes resample), through the shared
    generator (``ds[i]``) and the per-item seeded one."""
    a, b = _datasets(JR.RealEstate10k, PR.RealEstate10k, corpus, route,
                     **kw)
    assert len(a) == len(b) == 8
    for i in range(len(a)):
        assert_same(a[i], b[i], f'[{i}]')
    for serial, i in enumerate((0, 1, 5)):
        assert_same(a.getitem_seeded(i, serial),
                    b.getitem_seeded(i, serial), f'seeded [{i}]')


@pytest.mark.parametrize('views', [2, 3])
def test_realestate_vis_items_equal_jax(corpus, route, views):
    a, b = _datasets(JR.RealEstate10kVis, PR.RealEstate10kVis, corpus,
                     route, num_ctxt_views=views)
    for i in (0, 1):
        item = b[i]
        assert item['query']['uv'].shape == (1, FRAME_HW[0] ** 2, 2)
        assert_same(a[i], item, f'[{i}]')


@pytest.mark.parametrize('cls', ['ACID', 'ACIDVis'])
def test_acid_items_equal_jax(corpus, route, cls):
    a, b = _datasets(getattr(JA, cls), getattr(PA, cls), corpus, route,
                     seed=4)
    for i in range(3):
        assert_same(a[i], b[i], f'{cls}[{i}]')


def test_trajectory_scene_equals_jax(corpus, small_frames):
    img_root, poses = corpus
    for views in (2, 3):
        a = JR.trajectory_scene(img_root / 'scene0001', poses, views=views)
        b = PR.trajectory_scene(img_root / 'scene0001', poses, views=views)
        assert b['query']['rgb'].shape[1] == 127
        assert_same(a, b, f'views {views}')


@pytest.mark.parametrize('num_workers', [0, 2])
def test_batch_iterator_equals_jax(corpus, route, num_workers):
    """Batches of 4 as shard 1 of 2 (rows 2-3 of each global batch), torch
    tensors on the CPU with ``to_device=False``, equal to the JAX
    iterator's numpy batches; with prefetch workers too."""
    a, b = _datasets(JR.RealEstate10k, PR.RealEstate10k, corpus, route,
                     num_ctxt_views=2, query_sparsity=32, seed=5)
    it_a = JR.batch_iterator(a, 4, seed=7, to_device=False, shard=(1, 2))
    it_b = PR.batch_iterator(b, 4, seed=7, to_device=False, shard=(1, 2),
                             num_workers=num_workers)
    for k in range(3):
        got = next(it_b)
        assert isinstance(got['query']['mask'], torch.Tensor)
        assert got['context']['rgb'].shape == (2, 2, 64, 64, 3)
        assert got['query']['mask'].shape == (2,)
        assert_same(next(it_a), got, f'batch {k}')
    it_b.close()


def test_batch_iterator_moves_to_device_and_serves_small_datasets(corpus):
    """``to_device`` puts the batch on ``device``. A dataset smaller than
    the batch (on which the JAX iterator never yields) fills each batch
    from successive shuffles, every index at most once more than the
    others."""
    ds = PR.RealEstate10k(*corpus, query_sparsity=16, max_num_scenes=2)
    ds.store.use_native = False
    batch = next(PR.batch_iterator(ds, 5, device='cpu'))
    assert batch['query']['rgb'].device.type == 'cpu'
    seen = []
    it = PR.batch_iterator(ds, 5, seed=1, to_device=False)
    orig = ds.getitem_seeded

    def record(idx, serial):
        seen.append(idx)
        return orig(idx, serial)

    ds.getitem_seeded = record
    for _ in range(2):
        assert next(it)['query']['rgb'].shape == (5, 1, 16, 3)
    assert sorted(set(seen)) == [0, 1]
    assert abs(seen[:5].count(0) - seen[:5].count(1)) == 1
    with pytest.raises(ValueError, match='empty'):
        next(PR.batch_iterator([], 2))


@pytest.fixture(scope='module')
def co3d_corpora(tmp_path_factory):
    """A 2-sequence CO3D-format category written by each package's
    writer."""
    pytest.importorskip('imageio')
    roots = {}
    for side, mod in (('port', PMC), ('jax', _jax_tool('make_co3d_corpus'))):
        root = tmp_path_factory.mktemp(f'co3d_{side}')
        argv = ['--root', str(root), '--seqs', '2', '--frames', '12',
                '--size', '48']
        if side == 'port':
            mod.main(argv)
        else:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr('sys.argv', ['make_co3d_corpus.py', *argv])
                mod.main()
        roots[side] = root
    return roots


def test_co3d_writers_write_the_same_files(co3d_corpora):
    a, b = co3d_corpora['port'], co3d_corpora['jax']
    files = sorted(p.relative_to(a) for p in a.rglob('*') if p.is_file())
    assert files == sorted(p.relative_to(b) for p in b.rglob('*')
                           if p.is_file())
    for f in files:
        if f.suffix == '.jgz':
            with gzip.open(a / f, 'rt') as x, gzip.open(b / f, 'rt') as y:
                assert json.load(x) == json.load(y)
        else:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f


@pytest.mark.parametrize('masked', [False, True])
def test_co3d_items_equal_jax(co3d_corpora, masked):
    root = co3d_corpora['port']
    kw = dict(category='boxes', subset='fewview_train', num_input_views=3,
              query_sparsity=64, masked=masked, seed=2)
    a, b = JC.CO3Dv2Dataset(root, **kw), PC.CO3Dv2Dataset(root, **kw)
    assert len(a) == len(b) == 2
    for i in (0, 1, 0):
        item = b[i]
        assert item['context']['rgb'].shape == (3, 256, 256, 3)
        assert_same(a[i], item, f'[{i}]')


def test_synthetic_worlds_equal_jax():
    """``make_plane_scene`` and ``make_boxes_scene`` against JAX's: the
    same scene dicts, f32 on both sides."""
    for name, kw in (('make_plane_scene', dict(n_rays=0)),
                     ('make_plane_scene', dict(n_view=3, n_rays=100)),
                     ('make_boxes_scene', dict(n_rays=0)),
                     ('make_boxes_scene', dict(n_rays=128, n_rects=6))):
        want = getattr(JS, name)(5, H=32, W=40, dtype=jnp.float32, **kw)
        got = getattr(PS, name)(5, H=32, W=40, device='cpu', **kw)
        assert got['query']['rgb'].dtype == torch.float32
        assert_same(want, got, name)


def test_native_loader_builds_beside_the_package(tmp_path):
    """The port's native decoder is built into the package's build
    directory (``native/`` stays as it is) and decodes as the JAX
    package's does: the entries, and the frames with and without the
    360p resize."""
    if not (PN.available() and JN.available()):
        pytest.skip('no C++ compiler for the native loader')
    assert PN.library_path().parent == (
        ROOT / 'cross_attention_renderer_torch' / 'build')
    assert PN.library_path().exists()
    rng = np.random.default_rng(0)
    frames = {f'{1000 * i}.png': rng.integers(0, 255, (256, 455, 3),
                                              dtype=np.uint8)
              for i in range(3)}
    frames['9000.png'] = rng.integers(0, 255, (360, 640, 3), dtype=np.uint8)
    np.savez(tmp_path / 'data.npz', **frames)
    a, b = JN.NativeNpz(tmp_path / 'data.npz'), PN.NativeNpz(
        tmp_path / 'data.npz')
    assert a.keys() == b.keys()
    for kw in (dict(), dict(resize_hw=(256, 455))):
        np.testing.assert_array_equal(a.load_frames(list(frames), **kw),
                                      b.load_frames(list(frames), **kw))
    assert hashlib.sha1(NATIVE_SO.read_bytes()).hexdigest() == NATIVE_SO_SHA


def test_download_helpers_equal_jax(tmp_path):
    """The downloader's offline parts: the pose .txt parse, the ffmpeg
    timestamp, and a fetcher that fails (injected: nothing is fetched)
    logging its scenes."""
    txt = tmp_path / 'scene001.txt'
    txt.write_text('https://www.youtube.com/watch?v=abc\n'
                   '153000 0.9 1.6 0.5 0.5 0 0 1 0 0 0\n'
                   '286000 0.9 1.6 0.5 0.5 0 0 1 0 0 0\n')
    assert PD.parse_scene_txt(txt) == JD.parse_scene_txt(txt)
    assert PD.parse_scene_txt(txt)[1] == [153000, 286000]
    us = ((1 * 3600 + 2 * 60 + 3) * 1000 + 456) * 1000
    assert PD._timestamp_str(us) == JD._timestamp_str(us) == '01:02:03.456'
    (tmp_path / 'poses').mkdir()
    (tmp_path / 'poses' / 'sceneA.txt').write_text(
        'https://youtu.be/x\n1000 0 0 0 0 0 0\n')
    calls = []
    failed = PD.build_dataset(tmp_path / 'poses', tmp_path / 'out',
                              fetcher=lambda url, out: calls.append(url))
    assert failed == ['sceneA'] and calls == ['https://youtu.be/x']
    assert 'sceneA' in (tmp_path / 'out' / 'failed_videos.txt').read_text()
