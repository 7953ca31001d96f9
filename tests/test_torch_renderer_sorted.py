"""The port's sorted-stream render (K5) and the V=3 compat render through
the one-hot (K7) and banded (K8) gathers, against JAX.

* The sorted render at V=2, at V=3 and at V=3 with
  ``reference_exchange_compat``: against JAX ``CrossAttentionRenderer(
  sorted_stream=True).apply``, whose gathers reach their plain take path on
  the CPU, as the port's wrappers do.
* The V=3 compat render with ``gather='onehot'`` and ``'banded'``: against
  JAX's compat render (the take path on the CPU: the function is the same).
* Inside the port: the sorted render against the standard one (JAX's
  test_sorted_stream_matches_standard), the precedence of the sorted stream
  over the fused render core, and no packed table on the paths that read
  none.

The same random weights on both sides through ``params_from_jax``; f32 on
the CPU; tolerance 1e-4 relative to max(1, |ref|), as both sides do the
same f32 arithmetic in another order.
"""

import jax
import numpy as np
import pytest
import torch

from cross_attention_renderer_tpu.data import make_scene as jax_scene
from cross_attention_renderer_tpu.models import (
    CrossAttentionRenderer as JaxRenderer)
from cross_attention_renderer_torch.convert import params_from_jax
from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models import renderer as RM
from cross_attention_renderer_torch.train import evaluation as EV
from torch_parity import assert_close, random_flax_params

SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))
OUTPUTS = ('rgb', 'depth_ray', 'valid_mask', 'at_wt', 'pixel_val')
SCENE = dict(H=64, W=64, n_rays=32)


@pytest.fixture(scope='module')
def weights():
    """n_view -> random JAX weights of the small model, drawn once."""
    cache = {}

    def get(V):
        if V not in cache:
            cache[V] = random_flax_params(JaxRenderer(n_view=V, **SMALL), 0,
                                          jax_scene(3, n_view=V, **SCENE))
        return cache[V]
    return get


@pytest.fixture(scope='module')
def jax_render(weights):
    """(n_view, model options) -> the JAX render of scene 3 with
    ``weights(n_view)``, each compiled once."""
    cache = {}

    def get(V, **kw):
        key = (V, tuple(sorted(kw.items())))
        if key not in cache:
            model = JaxRenderer(n_view=V, fused_attention=False, **SMALL,
                                **kw)
            cache[key] = jax.jit(model.apply)(
                weights(V), jax_scene(3, n_view=V, **SCENE))
        return cache[key]
    return get


def _port(V, params, **kw):
    model = RM.CrossAttentionRenderer(n_view=V, device='cpu', **SMALL, **kw)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def _port_render(V, params, seed=3, **kw):
    with torch.no_grad():
        return _port(V, params, **kw)(make_scene(seed, n_view=V,
                                                 device='cpu', **SCENE))


def _assert_outputs(got, want, atol=1e-4):
    for k in OUTPUTS:
        assert_close(k, got[k].numpy(), np.asarray(want[k]), atol=atol,
                     rtol=1e-4)
    assert float(got['valid_mask'].mean()) > 0


@pytest.mark.parametrize('V,compat', [(2, False), (3, False), (3, True)])
def test_sorted_render_matches_jax(weights, jax_render, V, compat):
    """At V=2 one stream serves both gathers (cross image = id ^ 1); at V=3
    the self and cross streams sort apart, in both wirings."""
    kw = dict(sorted_stream=True, reference_exchange_compat=compat)
    _assert_outputs(_port_render(V, weights(V), **kw), jax_render(V, **kw))


@pytest.mark.parametrize('V', [2, 3])
def test_sorted_matches_standard_render(weights, V):
    """Inside the port: the sorted stream permutes the same bilinear sums
    (JAX's test_sorted_stream_matches_standard, its tolerances)."""
    params = weights(V)
    scene = make_scene(11, n_view=V, H=32, W=32, n_rays=48, device='cpu')
    with torch.no_grad():
        std = _port(V, params)(scene)
        srt = _port(V, params, sorted_stream=True)(scene)
    for k in ('rgb', 'depth_ray', 'at_wt', 'valid_mask'):
        np.testing.assert_allclose(srt[k].numpy(), std[k].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize('gather', ['onehot', 'banded'])
def test_compat_gathers_match_jax(weights, jax_render, gather):
    """The unfused V=3 exchange's gathers through K7 or K8 (plain on the
    CPU) against JAX's compat render."""
    _assert_outputs(
        _port_render(3, weights(3), reference_exchange_compat=True,
                     gather=gather),
        jax_render(3, reference_exchange_compat=True))


@pytest.mark.parametrize('V', [2, 3])
def test_sorted_stream_takes_precedence(monkeypatch, weights, V):
    """``sorted_stream`` wins over ``fused_render`` and the fused
    epilogues (JAX renderer.py:334-458): both attention rounds run as K1,
    on contiguous operands as the kernel requires, no K2, K3 or K4 is
    called, and the image is the sorted render's."""
    params = weights(V)
    calls = []

    def recorder(name, fn):
        def wrapper(*args):
            calls.append(name)
            assert all(a.is_contiguous() for a in args
                       if isinstance(a, torch.Tensor)), name
            return fn(*args)
        return wrapper

    for name in ('epipolar_attention', 'fused_render_core',
                 'fused_exchange_epilogue', 'fused_exchange_epilogue_multi'):
        monkeypatch.setattr(RM, name, recorder(name, getattr(RM, name)))
    kw = dict(sorted_stream=True, fused_render=V == 2)
    got = _port_render(V, params, **kw)
    assert calls == ['epipolar_attention'] * 2
    _assert_outputs(got, _port_render(V, params, sorted_stream=True),
                    atol=0.0)


@pytest.mark.parametrize('V,kw,packs', [
    (2, dict(), True),
    (2, dict(sorted_stream=True, fused_render=True), False),
    (3, dict(sorted_stream=True), False),
    (3, dict(reference_exchange_compat=True), True),
    (3, dict(reference_exchange_compat=True, gather='onehot'), False),
])
def test_packed_tables_only_where_read(monkeypatch, weights, V, kw, packs):
    """``make_scan_renderer`` packs the pyramid once per image when the
    model reads packed tables and not at all when it reads none; a block
    never packs (JAX ``uses_packed``, evaluation.py:94-106)."""
    params = weights(V)
    packed = []
    pack_pyramid = RM.pack_pyramid

    def pack(z):
        packed.append(len(z))
        return pack_pyramid(z)

    monkeypatch.setattr(EV, 'pack_pyramid', pack)
    monkeypatch.setattr(RM, 'pack_pyramid', lambda z: pytest.fail(
        'a ray block packed the pyramid'))
    model = _port(V, params, **kw)
    assert model.uses_packed_tables == packs
    scene = make_scene(1, n_view=V, H=32, W=32, n_rays=16, device='cpu')
    with torch.no_grad():
        z = model.encode(scene)
    EV.make_scan_renderer(model, 2)(scene, z, scene['query']['uv'])
    assert packed == ([3] if model.uses_packed_tables else [])


def test_gather_option_is_checked():
    with pytest.raises(ValueError):
        RM.CrossAttentionRenderer(n_view=3, gather='windowed', device='cpu',
                                  **SMALL)
