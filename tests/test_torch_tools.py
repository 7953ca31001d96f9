"""The port's tools (``cross_attention_renderer_torch/tools/``) ported from
the JAX repository's ``tools/``, on the CPU.

* The CPU analyses against the JAX tools on the same fixture
  (``make_scene(0)``, the first rays of the 256x256 image; the JAX tools'
  module constant ``R`` set to the same count):
  - ``stream_stats``: every line's numbers. The self stream's equal JAX's;
    the cross stream's out fractions within 1e-4 and its span percentiles
    within 5%: one far sample (p = 63) of one ray, whose triangulated
    point is ill-conditioned, lands 0.046 ndc apart on the two sides (every
    other cross sample within 1e-4), and a block's span percentile over
    16 blocks moves with it.
  - ``cross_interp_error``: every number within 1e-4 relative. JAX's tool
    raises on this JAX at its line 111 (``take_along_axis`` of a 6-d index
    into a 5-d array, then a squeeze of the sample axis): it runs here with
    that one call given the index it means, (B, V, R, P, C) along the
    segment axis.
  - ``make_synthetic_lpips``: the npz equal, array for array, to the JAX
    tool's for the same seed.
* Each card tool: its flags (the JAX tool's, with their defaults, and
  ``--device cuda`` by default) and its refusal without a card.
* ``bench_train_roofline``'s split functions at a tiny config: the
  render-only loss with z held constant equals the full loss, and its
  gradient leaves the encoder's parameters without one; each card tool's
  measurement runs end to end on the CPU at a tiny config.
"""

import contextlib
import importlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cross_attention_renderer_torch.tools import _card

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(fusion_features=16, vit_width=32, vit_depth=1, vit_heads=2,
            resnet_layers=(1, 1, 1), npoints=4)
# tool: (flags given, {option: default the JAX tool has})
CARD_TOOLS = {
    'bench_train_roofline': ([], dict(vit_depth=12, no_high_freq=False,
                                      batch=12, remat=False)),
    'profile_sorted': ([], {}),
    'trace_render': ([], {}),
    'bench_traj': ([], dict(fast=False, pruned=None, narrow=None,
                            q8=False)),
    'bench_v3': ([], dict(iters=4, blocks=16, npoints=0)),
    'bench_block': ([], dict(mode='std')),
    'bench_blocks': ([], dict(chunks='4,8,16,32', iters=4)),
    'bench_sorted_stream': ([], {}),
    'bench_ondisk': (['--root', 'corpus'], dict(
        steps=500, workers=4, batch=12, iter_only=False, iter_batches=40)),
}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread (the tier-1 run puts six test workers on the
    machine's cores; see tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f'jax_tool_{name}', ROOT / 'tools' / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_tool(name):
    return importlib.import_module(f'cross_attention_renderer_torch.tools.'
                                   f'{name}')


def _printed(fn, *args) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


def _numbers(line: str) -> np.ndarray:
    return np.array([float(x) for x in re.findall(
        r'[-+]?\d+\.?\d*(?:e[-+]?\d+)?', line)])


# --- the CPU analyses against the JAX tools ---------------------------------

def test_stream_stats_matches_jax():
    jt = _jax_tool('stream_stats')
    jt.R = 256
    want = _printed(jt.main)
    got = _printed(_port_tool('stream_stats').main, ['--rays', '256'])
    assert len(got) == len(want) == 18
    for g, w in zip(got, want):
        assert g.split('out=')[0] == w.split('out=')[0]
        gn, wn = _numbers(g), _numbers(w)
        out, spans = slice(5, 6), slice(6, 9)     # after hxw, S and W
        if ' self ' in g:
            assert g == w
            continue
        np.testing.assert_allclose(gn[out], wn[out], atol=1e-4, err_msg=g)
        np.testing.assert_allclose(gn[spans], wn[spans], rtol=0.05,
                                   err_msg=g)


def test_cross_interp_error_matches_jax():
    jt = _jax_tool('cross_interp_error')
    jt.R = 128
    with pytest.raises(ValueError, match='same number of dimensions'):
        _printed(jt.main)

    class FixedJnp:
        """jax.numpy with the tool's take_along_axis given the (B, V, R,
        P, C) index it means, its result shaped for its squeeze(3)."""

        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def take_along_axis(a, idx, axis):
            return jnp.take_along_axis(a, idx[..., 0, :],
                                       axis=axis)[:, :, :, None]

    jt.jnp = FixedJnp()
    want = _printed(jt.main)
    got = _printed(_port_tool('cross_interp_error').main, ['--rays', '128'])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_allclose(_numbers(g), _numbers(w), rtol=1e-4,
                                   err_msg=g)


def test_make_synthetic_lpips_matches_jax(tmp_path):
    jt = _jax_tool('make_synthetic_lpips')
    want = tmp_path / 'jax.npz'
    import sys
    argv = sys.argv
    try:
        sys.argv = ['make_synthetic_lpips', '--out', str(want), '--seed',
                    '3']
        _printed(jt.main)
    finally:
        sys.argv = argv
    got = _port_tool('make_synthetic_lpips').main(
        ['--out', str(tmp_path / 'port.npz'), '--seed', '3'])
    a, b = np.load(got), np.load(want)
    assert sorted(a.files) == sorted(b.files) and len(a.files) == 31
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    from cross_attention_renderer_torch.losses.lpips import load_lpips
    fn = load_lpips(str(got), device='cpu')
    x = torch.rand(1, 32, 32, 3) * 2 - 1
    assert float(fn(x, x).max()) == 0.0 and float(fn(x, -x).min()) > 0


# --- the card tools: flags and refusal --------------------------------------

@pytest.mark.parametrize('tool', sorted(CARD_TOOLS))
def test_card_tool_flags_and_refusal(tool, monkeypatch):
    flags, defaults = CARD_TOOLS[tool]
    mod = _port_tool(tool)
    opt = mod.parser().parse_args(flags)
    assert opt.device == 'cuda'
    for k, v in defaults.items():
        assert getattr(opt, k) == v, (tool, k)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit, match=f'{tool}: needs an NVIDIA card'):
        mod.main(flags)


# --- the card tools' measurements at a tiny config on the CPU --------------

def test_roofline_split_functions():
    """The render-only loss from a constant z is the full loss, and its
    backward gives the encoder no gradient and every other trained
    parameter one; the split's derived parts add up."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.train.trainer import (
        TrainConfig, make_loss_fn)
    R = _port_tool('bench_train_roofline')
    model = _card.flagship(2, torch.device('cpu'), dtype=torch.float32,
                           **TINY)
    scene = make_scene(0, batch=2, n_view=2, H=32, W=32, n_rays=8,
                       device='cpu')
    cfg = TrainConfig()
    full = make_loss_fn(model, cfg)(scene)[0]
    z = R.encode_const(model, scene)
    assert not any(t.requires_grad for t in z)
    loss = R.render_loss_fn(model, cfg)(scene, z)
    torch.testing.assert_close(loss, full, rtol=1e-6, atol=0)
    loss.backward()
    encoder = {n for n, _ in model.named_parameters()
               if n.startswith(('encoder.', 'conv_map.'))}
    assert encoder
    for n, p in model.named_parameters():
        if n in encoder:
            assert p.grad is None, n
    assert model.phi.lin_out.weight.grad is not None
    assert model.query_encode_latent.kernel.grad is not None

    opt = R.parser().parse_args(['--device', 'cpu', '--iters', '1',
                                 '--batch', '2'])
    r = R.measure(opt, torch.device('cpu'), **TINY, hw=32, rays=8)
    t = r['ms']
    assert t['backward'] == pytest.approx(t['fwd_bwd'] - t['forward'])
    assert t['optimizer'] == pytest.approx(t['step'] - t['fwd_bwd'])
    assert r['flops'] > 0 and r['optimizer_bytes'] == 28 * sum(
        p.numel() for p in model.parameters())


def test_card_tools_run_at_a_tiny_config(tmp_path):
    cpu = torch.device('cpu')
    kw = dict(TINY)
    traj = _port_tool('bench_traj')
    r = traj.measure(traj.parser().parse_args(
        ['--device', 'cpu', '--frames', '1', '--pruned', '2,4']), cpu,
        hw=32, n_chunks=2, **kw)
    assert r['pruned'] == (2, 4) and r['frames_per_s'] > 0
    v3 = _port_tool('bench_v3')
    r = v3.measure(v3.parser().parse_args(
        ['--device', 'cpu', '--iters', '1', '--blocks', '2', '--views',
         '5']), cpu, hw=32, **{k: v for k, v in kw.items()
                               if k != 'npoints'})
    assert r['npoints'] == 48 and r['ms_per_image'] > 0
    block = _port_tool('bench_block')
    for mode, flags in block.MODES.items():
        ms, rgb = block.block_ms(_card.flagship(2, cpu, **kw, **flags),
                                 _card.full_scene(2, cpu, 32), 1, cpu, 64)
        assert ms > 0 and torch.isfinite(rgb).all(), mode
    ss = _port_tool('bench_sorted_stream')
    r = ss.measure(ss.parser().parse_args(['--device', 'cpu', '--iters',
                                           '1']), cpu, hw=32, rays=64, **kw)
    assert len(r['parity']) == 3 and np.isfinite(list(r['parity'].values())
                                                 ).all()
    tr = _port_tool('trace_render')
    events = tr.run(tr.parser().parse_args(
        ['--device', 'cpu', '--blocks', '1', '--out',
         str(tmp_path / 'trace')]), cpu, hw=32, rays=64, **kw)
    assert events and (tmp_path / 'trace' / 'trace.json').exists()
    ps = _port_tool('profile_sorted')
    r = ps.measure(4096, 1, cpu, levels=((8, 8, 16),))
    assert set(r) >= {'sort_stream (argsort + takes)',
                      'resident_gather 8x8x16 (K5)'}


def test_bench_ondisk_reads_a_corpus(tmp_path):
    from cross_attention_renderer_torch.data import realestate as PR
    from cross_attention_renderer_torch.tools import make_corpus as PM
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in ((PR, ('IMG_H', 'IMG_W', 'CROP')),
                           (PM, ('H', 'W'))):
            for n, v in zip(names, (64, 114, 64)):
                mp.setattr(mod, n, v)
        PM.main(['--root', str(tmp_path), '--scenes', '2', '--defects',
                 '0'])
        od = _port_tool('bench_ondisk')
        opt = od.parser().parse_args(
            ['--root', str(tmp_path), '--device', 'cpu', '--steps', '1',
             '--workers', '2', '--batch', '2', '--iter-batches', '2'])
        r = od.measure(opt, torch.device('cpu'), **TINY)
    assert r['scenes_per_s'] > 0 and np.isfinite(r['loss'])


IMAGE_TIME_NEW = ('v4', 'v5', 'v6', 'v5_f32', 'v5_q8', 'resnet_v5', 'unet_v2',
                  'unet_v2_fused', 'unet_v3')


@pytest.mark.parametrize('name', IMAGE_TIME_NEW)
def test_image_time_path_builds_and_renders_at_a_tiny_width(name):
    """Each path ``image_time.py`` times on the wide-tile core builds its
    model (the path's encoder, view count, type and route) at a tiny width
    on the CPU and renders 16 rays of a 32x32 scene through the renderer
    the tool gives it, finite."""
    from cross_attention_renderer_torch.data.synthetic import make_scene
    from cross_attention_renderer_torch.models import renderer as RM
    from cross_attention_renderer_torch.tools import image_time as IT
    from cross_attention_renderer_torch.train.evaluation import (
        make_fast_renderer, make_scan_renderer)
    kw = IT.PATHS[name]
    model, q8 = IT.path_model(RM, name, 'cpu', **TINY)
    assert model.n_view == kw.get('n_view', 2) and q8 == kw.get('q8', False)
    assert model.model == kw.get('model', 'midas_vit')
    assert model.fused_render == kw.get('fused_render', False)
    want = torch.float32 if kw.get('dtype') == 'float32' else torch.bfloat16
    assert model.dtype == want
    scene = make_scene(0, n_view=model.n_view, H=32, W=32, n_rays=16,
                       device='cpu')
    render = (make_fast_renderer(model, 1, q8=True) if q8
              else make_scan_renderer(model, 1))
    with torch.inference_mode():
        rgb, _ = render(scene, model.encode(scene), scene['query']['uv'])
    assert rgb.shape[-2:] == (16, 3) and torch.isfinite(rgb.float()).all()
