"""The port's CLI and ``make_summary_renderer``, on the CPU.

* ``train/evaluation.py:make_summary_renderer`` against JAX's on a narrow
  model (2 ViT blocks, fusion_features 64; the weights through
  ``params_from_jax``) and a 32x32 image in 2 chunks, every output within
  the V=2 render test's 1e-4 + 1e-4 max(1, max |JAX|)
  (tests/test_torch_renderer.py).
* The CLI smoke cases of tests/test_cli.py, through the port's entry
  points at the same narrow sizes with ``--device cpu``, on a 2-scene
  corpus written by the port's ``make_corpus`` at 64x114 (the loaders'
  constants patched to it, as tests/test_cli.py patches JAX's): train
  (f32, bf16, stage 2 with LPIPS from the ``lpips_npz`` fixture, the val
  summary), eval (its metrics equal to ``evaluate_scene``'s on the same
  model and scene), render_traj, the ``--dtype`` flag, the fast-eval
  flags parsing and evaluating (``--fast``), the parallel flags raising
  where no world of ranks can satisfy them, and ``--save_images`` and the
  video writer raising without imageio.
* ``build_model`` building each encoder, ablation flag and view count 1-4
  on the CPU, and refusing ``--views 5``; a 2-step ``cli/train.py`` run of
  the ResNet34 model at one view, ``cli/eval.py`` of the ResNet34
  model at two views with ``--no_sample``, and of the U-Net at two views
  in bf16.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_tpu.train import evaluation as JE
from cross_attention_renderer_torch.cli import common as C
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data import realestate as PR
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.tools import make_corpus as PM
from cross_attention_renderer_torch.train import evaluation as E
from torch_parity import assert_close, random_flax_params

TINY_FLAGS = ['--fusion_features', '32', '--vit_width', '64',
              '--vit_depth', '2', '--vit_heads', '2',
              '--resnet_layers', '1', '1', '1', '--npoints', '8',
              '--device', 'cpu']
FRAME_HW = (64, 114)


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    """A 2-scene noise corpus of 64x114 frames from the port's writer, the
    loaders cut to it for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PR, 'IMG_H', FRAME_HW[0])
        mp.setattr(PR, 'IMG_W', FRAME_HW[1])
        mp.setattr(PR, 'CROP', FRAME_HW[0])
        mp.setattr(PM, 'H', FRAME_HW[0])
        mp.setattr(PM, 'W', FRAME_HW[1])
        root = tmp_path_factory.mktemp('cli_corpus')
        PM.main(['--root', str(root), '--scenes', '2', '--defects', '0',
                 '--seed_base', '1'])
        yield root / 'frames', root / 'poses.mat'


def _train(dataset, tmp_path, name, *flags):
    from cross_attention_renderer_torch.cli import train as train_cli
    img_root, pose_root = dataset
    return train_cli.main([
        '--img_root', str(img_root), '--pose_root', str(pose_root),
        '--logging_root', str(tmp_path), '--experiment_name', name,
        '--batch_size', '1', '--max_steps', '2', '--num_workers', '0',
        *flags, *TINY_FLAGS])


def test_summary_renderer_matches_jax():
    H = W = 32
    small = dict(npoints=8, fusion_features=64, vit_width=64, vit_depth=2,
                 vit_heads=2, resnet_layers=(1, 1, 1))
    jscene = jax_scene(6, H=H, W=W, n_rays=H * W, full_image=True)
    jax_model = JaxRenderer(n_view=2, fused_epilogue=True,
                            fused_attention=False, **small)
    params = random_flax_params(jax_model, 0, jax_scene(6, H=H, W=W,
                                                        n_rays=8))
    z = jax.jit(lambda p, s: jax_model.apply(p, s, method='encode'))(
        params, jscene)
    want = JE.make_summary_renderer(jax_model, 2)(
        params, jscene, z, jscene['query']['uv'])

    model = CrossAttentionRenderer(device='cpu', **small)
    model.load_state_dict(params_from_jax(params), strict=True)
    scene = make_scene(6, H=H, W=W, n_rays=H * W, full_image=True,
                       device='cpu')
    with torch.inference_mode():
        got = E.make_summary_renderer(model, 2)(
            scene, model.encode(scene), scene['query']['uv'])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        assert tuple(got[k].shape) == w.shape, k
        assert_close(k, got[k].float().numpy(), w, atol=1e-4, rtol=1e-4)
    assert want['at_wt'].shape == (1, 2, H * W, 8)


def test_train_cli_smoke(dataset, tmp_path):
    res = _train(dataset, tmp_path, 'smoke', '--query_sparsity', '16',
                 '--lr', '1e-4', '--steps_til_summary', '100',
                 '--steps_til_log', '1')
    state = res['state']
    assert state.step == 2 and [r['step'] for r in res['log']] == [0, 1]
    assert all(np.isfinite(r['total_loss']) and r['ms'] > 0
               for r in res['log'])
    assert (tmp_path / 'smoke' / 'checkpoints' / 'final.pt').exists()
    # --checkpoint_path reads the port's own checkpoints: a .pt file, or a
    # directory's 'current' checkpoint
    ckpt = tmp_path / 'smoke' / 'checkpoints' / 'final.pt'
    warm = _train(dataset, tmp_path, 'warm', '--query_sparsity', '16',
                  '--max_steps', '1', '--checkpoint_path', str(ckpt))
    assert warm['state'].step == 1
    (tmp_path / 'smoke' / 'checkpoints' / 'current.pt').write_bytes(
        ckpt.read_bytes())
    opt = C.base_parser('t').parse_args(TINY_FLAGS)
    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, create_train_state)
    model = C.build_model(opt)
    C.restore_params(create_train_state(model, TrainConfig()),
                     str(tmp_path / 'smoke' / 'checkpoints'))
    for name, p in model.state_dict().items():
        torch.testing.assert_close(p, state.model.state_dict()[name])


def test_dtype_flag_threads_to_model():
    opt = C.base_parser('t').parse_args(['--dtype', 'bfloat16', *TINY_FLAGS])
    assert C.build_model(opt).dtype == torch.bfloat16
    opt = C.base_parser('t').parse_args(TINY_FLAGS)
    model = C.build_model(opt)
    assert model.dtype == torch.float32
    assert next(model.parameters()).device.type == 'cpu'
    assert C.base_parser('t').parse_args([]).device == 'cuda'


def test_train_cli_bf16_smoke(dataset, tmp_path):
    _train(dataset, tmp_path, 'bf16', '--query_sparsity', '16',
           '--dtype', 'bfloat16')
    assert (tmp_path / 'bf16' / 'checkpoints' / 'final.pt').exists()


def test_train_cli_lpips_smoke(dataset, tmp_path, monkeypatch, lpips_npz,
                               capsys):
    """The stage-2 command (--lpips --depth): the LPIPS weights load through
    $LPIPS_WEIGHTS and the term reaches the step."""
    monkeypatch.setenv('LPIPS_WEIGHTS', str(lpips_npz))
    _train(dataset, tmp_path, 'lpips', '--lpips', '--depth', '--lr', '1e-4',
           '--steps_til_log', '1')
    assert (tmp_path / 'lpips' / 'checkpoints' / 'final.pt').exists()
    out = capsys.readouterr().out
    assert 'lpips_loss=' in out and 'ms a step' in out


def test_train_cli_val_summary_smoke(dataset, tmp_path):
    """--val_img_root drives the full-frame val summary and writes
    tensorboard events."""
    pytest.importorskip('tensorboardX')
    img_root, pose_root = dataset
    _train(dataset, tmp_path, 'val', '--query_sparsity', '16',
           '--val_img_root', str(img_root), '--val_pose_root',
           str(pose_root), '--steps_til_summary', '2')
    ev = list((tmp_path / 'val' / 'summaries').glob('events*'))
    assert ev and ev[0].stat().st_size > 1000


def test_train_cli_lpips_requires_weights(dataset, tmp_path, monkeypatch):
    monkeypatch.setenv('LPIPS_WEIGHTS', str(tmp_path / 'missing.npz'))
    with pytest.raises(FileNotFoundError, match='LPIPS weights not found'):
        _train(dataset, tmp_path, 'x', '--lpips')


# What no world of ranks can run: a process count without the
# coordinator's address, an address without the count, and, in one
# process, a mesh of more than one rank (the parallel layer itself is
# tests/test_torch_parallel.py's).
REFUSED_PARALLEL = {
    '--num_processes': (ValueError, 'coordinator address'),
    '--coordinator_address': (ValueError, 'coordinator address'),
    '--tensor_parallel': (AssertionError, None),
    '--data_parallel': (AssertionError, None)}


@pytest.mark.parametrize('flags', [
    ['--num_processes', '2', '--process_id', '0'],
    ['--coordinator_address', 'localhost:1234'],
    ['--tensor_parallel', '2'], ['--data_parallel', '2']])
def test_train_cli_refuses_parallel(dataset, tmp_path, flags):
    error, match = REFUSED_PARALLEL[flags[0]]
    with pytest.raises(error, match=match):
        _train(dataset, tmp_path, 'p', *flags)


def test_eval_cli_smoke(dataset, tmp_path, monkeypatch, capsys, lpips_npz):
    """The eval CLI's metrics, LPIPS included, equal ``evaluate_scene``'s
    on the same model (seed 0 from the same flags) and scene."""
    from cross_attention_renderer_torch.cli import eval as eval_cli
    from cross_attention_renderer_torch.losses.lpips import load_lpips
    monkeypatch.setenv('LPIPS_WEIGHTS', str(lpips_npz))
    img_root, pose_root = dataset
    res = eval_cli.main([
        '--img_root', str(img_root), '--pose_root', str(pose_root),
        '--logging_root', str(tmp_path), '--experiment_name', 'smoke_eval',
        '--max_scenes', '2', '--n_chunks', '4', '--save_images',
        *TINY_FLAGS])
    out = capsys.readouterr().out
    assert 'psnr=' in out and 'ssim=' in out and 'lpips=' in out
    assert len(res['scenes']) == 2
    assert (tmp_path / 'smoke_eval' / '0001_pred.png').exists()

    model = C.build_model(C.base_parser('t').parse_args(TINY_FLAGS)).eval()
    # the first item of a fresh dataset: its generator's first draw, as
    # the CLI's first scene
    scene = C.scene_batch(PR.RealEstate10kVis(img_root, pose_root)[0],
                          'cpu')
    want = E.evaluate_scene(model, scene, 64, 64, n_chunks=4,
                            lpips_fn=load_lpips(str(lpips_npz),
                                                device='cpu'))
    for k in ('mse', 'psnr', 'ssim', 'lpips'):
        np.testing.assert_allclose(res['scenes'][0][k], float(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_render_traj_cli_smoke(dataset, tmp_path, monkeypatch):
    """A 4-frame trajectory (3 query poses) to a video, or PNG frames where
    imageio has no mp4 backend."""
    pytest.importorskip('imageio')
    from cross_attention_renderer_torch.cli import render_traj
    img_root, pose_root = dataset
    monkeypatch.setattr(render_traj, 'trajectory_scene',
                        lambda *a, **k: PR.trajectory_scene(*a, **k,
                                                            n_frames=4))
    res = render_traj.main([
        '--scene_path', str(img_root / 'scene0001'), '--pose_dir',
        str(pose_root), '--ray_chunk', '1024',
        '--out', str(tmp_path / 'traj.mp4'), *TINY_FLAGS])
    assert len(res['psnr']) == 3 and np.isfinite(res['psnr']).all()


def test_save_images_without_imageio_says_so(dataset, tmp_path,
                                            monkeypatch):
    """Where imageio is not installed (the card machine), --save_images
    and the video writer raise an ImportError that names what needs it."""
    from cross_attention_renderer_torch.cli import eval as eval_cli
    monkeypatch.setitem(sys.modules, 'imageio', None)
    monkeypatch.setitem(sys.modules, 'imageio.v2', None)
    img_root, pose_root = dataset
    with pytest.raises(ImportError, match='--save_images needs the imageio'):
        eval_cli.main(['--img_root', str(img_root), '--pose_root',
                       str(pose_root), '--logging_root', str(tmp_path),
                       '--max_scenes', '1', '--save_images', *TINY_FLAGS])
    with pytest.raises(ImportError, match='a video needs the imageio'):
        C.FrameWriter(str(tmp_path / 'traj.mp4'))


def test_fast_eval_flags_parse_and_raise(dataset, tmp_path):
    """--pruned / --narrow / --q8 / --fast parse as the JAX CLI's do; the
    renderer, which refused them until the fast renderers were ported,
    now evaluates with them: --fast's metrics equal ``evaluate_scene``'s
    with the fast image renderer on the same model and scene (their parity
    with JAX is in tests/test_torch_fast_eval.py)."""
    from cross_attention_renderer_torch.cli import eval as eval_cli
    p = C.base_parser('x')
    opt = p.parse_args(['--pruned', '16,24', '--narrow', '128,128,64',
                        '--q8'])
    assert C.fast_eval_kwargs(opt) == {'pruned': (16, 24),
                                       'narrow': (128, 128, 64), 'q8': True}
    assert C.fast_eval_kwargs(p.parse_args([])) == dict(
        pruned=None, narrow=None, q8=False)
    kw = C.fast_eval_kwargs(p.parse_args(['--fast', '--pruned', '8,8']))
    assert kw == dict(pruned=(8, 8), narrow=(128, 128, 64), q8=True)
    img_root, pose_root = dataset
    argv = ['--img_root', str(img_root), '--pose_root', str(pose_root),
            '--logging_root', str(tmp_path), '--max_scenes', '1', '--fast',
            '--narrow', '16,16,32', *TINY_FLAGS]
    res = eval_cli.main(argv)
    opt = C.base_parser('x').parse_known_args(argv)[0]
    model = C.build_model(opt).eval()
    scene = C.scene_batch(PR.RealEstate10kVis(img_root, pose_root)[0],
                          'cpu')
    want = E.evaluate_scene(model, scene, 64, 64, n_chunks=8,
                            renderer=E.make_image_renderer(
                                model, 8, **C.fast_eval_kwargs(opt)))
    for k in ('mse', 'psnr', 'ssim'):
        assert np.isfinite(res['scenes'][0][k])
        np.testing.assert_allclose(res['scenes'][0][k], float(want[k]),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize('flags', [['--model', 'resnet'], ['--model', 'unet'],
                                   ['--no_sample'], ['--no_high_freq'],
                                   ['--no_latent_concat', '--no_multiview'],
                                   ['--views', '4'], ['--views', '1']])
def test_build_model_refuses_what_is_not_ported(flags):
    """Each of these was refused until the port had it: now each builds
    the renderer it names, and so does a view count above four (K3 takes
    any stream count)."""
    opt = C.base_parser('t').parse_args([*flags, *TINY_FLAGS])
    model = C.build_model(opt)
    assert model.model == opt.model and model.n_view == opt.views
    for a in C.ABLATIONS:
        assert getattr(model, a) == getattr(opt, a)
    assert len(model.encode(make_scene(0, n_view=opt.views, H=32, W=32,
                                       n_rays=4, device='cpu'))) == (
        3 if opt.model == 'midas_vit' else 4)
    opt.views = 5
    model = C.build_model(opt)
    assert model.n_view == 5 and model.n_samples == opt.npoints


def test_train_cli_resnet_one_view(dataset, tmp_path):
    res = _train(dataset, tmp_path, 'resnet_v1', '--model', 'resnet',
                 '--views', '1', '--query_sparsity', '16',
                 '--steps_til_log', '1')
    assert res['state'].step == 2 and len(res['log']) == 2
    assert all(np.isfinite(r['total_loss']) for r in res['log'])
    model = res['state'].model
    assert model.model == 'resnet' and model.n_view == 1
    assert (tmp_path / 'resnet_v1' / 'checkpoints' / 'final.pt').exists()


def test_eval_cli_resnet_no_sample(dataset, tmp_path):
    from cross_attention_renderer_torch.cli import eval as eval_cli
    img_root, pose_root = dataset
    argv = ['--img_root', str(img_root), '--pose_root', str(pose_root),
            '--logging_root', str(tmp_path), '--max_scenes', '1',
            '--model', 'resnet', '--no_sample', *TINY_FLAGS]
    res = eval_cli.main(argv)
    opt = C.base_parser('x').parse_known_args(argv)[0]
    model = C.build_model(opt).eval()
    scene = C.scene_batch(PR.RealEstate10kVis(img_root, pose_root)[0],
                          'cpu')
    want = E.evaluate_scene(model, scene, 64, 64, n_chunks=8)
    for k in ('mse', 'psnr', 'ssim'):
        assert np.isfinite(res['scenes'][0][k])
        np.testing.assert_allclose(res['scenes'][0][k], float(want[k]),
                                   rtol=1e-6, err_msg=k)


def test_eval_cli_unet_bf16(dataset, tmp_path):
    """``cli/eval.py --model unet`` at two views in bf16 (the benchmark's
    ``unet_v2``): the whole-image renderer's metrics, equal to
    ``evaluate_scene``'s on the same model and scene."""
    from cross_attention_renderer_torch.cli import eval as eval_cli
    img_root, pose_root = dataset
    argv = ['--img_root', str(img_root), '--pose_root', str(pose_root),
            '--logging_root', str(tmp_path), '--max_scenes', '1',
            '--model', 'unet', '--dtype', 'bfloat16', *TINY_FLAGS]
    res = eval_cli.main(argv)
    opt = C.base_parser('x').parse_known_args(argv)[0]
    model = C.build_model(opt).eval()
    assert model.model == 'unet' and model.n_view == 2
    scene = C.scene_batch(PR.RealEstate10kVis(img_root, pose_root)[0],
                          'cpu')
    want = E.evaluate_scene(model, scene, 64, 64, n_chunks=8,
                            renderer=E.make_image_renderer(model, 8))
    for k in ('mse', 'psnr', 'ssim'):
        assert np.isfinite(res['scenes'][0][k])
        np.testing.assert_allclose(res['scenes'][0][k], float(want[k]),
                                   rtol=1e-6, err_msg=k)
