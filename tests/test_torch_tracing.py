"""The program's spans (``utils/profiling.py:span``), on the CPU.

* With no profiler recording, ``span`` hands out one shared null context
  and no path of a render or a train step enters ``record_function``.
* Under ``torch.profiler`` a tiny whole-image render at V=2, V=3 and on
  the V=2 fused-render route (K4's plain version) opens ``car.encode`` and
  ``car.pack_pyramid`` once, ``car.block`` once a ray block, and inside
  each block, by time, the three ``car.geometry`` leaves, ``car.exchange``
  holding the ``car.address_math`` leaf, ``car.attention`` and
  ``car.phi``; the image is the untraced render's, bit for bit.
* A tiny train step under the profiler opens ``car.train.forward``,
  ``backward``, ``clip`` and ``adam`` once each, in that order, inside
  ``car.train.step``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cross_attention_renderer_torch.data.synthetic import make_scene
from cross_attention_renderer_torch.models.renderer import (
    CrossAttentionRenderer)
from cross_attention_renderer_torch.train import evaluation as E
from cross_attention_renderer_torch.train import trainer as T
from cross_attention_renderer_torch.utils import profiling as PR

SMALL = dict(npoints=8, fusion_features=32, vit_width=64, vit_depth=2,
             vit_heads=2, resnet_layers=(1, 1, 1))
HW = 32
BLOCKS = 4
LEAVES = ('car.geometry', 'car.address_math')


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts several test workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(V, **kw):
    return CrossAttentionRenderer(n_view=V, device='cpu', **SMALL, **kw)


def _scene(V, n_rays=HW * HW):
    return make_scene(0, H=HW, W=HW, n_view=V, n_rays=n_rays,
                      full_image=n_rays == HW * HW, device='cpu')


def _spans(prof):
    """[(name, start, end)] of the ``car.`` spans, by start (us)."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith('car.')),
                  key=lambda s: s[1])


def _inside(spans, outer):
    _, s0, e0 = outer
    return [s for s in spans if s is not outer and s0 <= s[1]
            and s[2] <= e0]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _train_step():
    model = _model(2)
    cfg = T.TrainConfig()
    return (T.create_train_state(model, cfg), T.make_train_step(model, cfg),
            _scene(2, n_rays=16))


def test_span_is_one_null_context_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) entered with '
                             'no profiler recording')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    assert PR.span('car.block') is PR.span('car.geometry')
    with PR.span('car.block'):
        pass
    model = _model(2)
    encode, render_image = E.make_image_renderer(model, BLOCKS)
    scene = _scene(2)
    rgb, _ = render_image(scene, encode(scene))
    assert torch.isfinite(rgb).all()
    state, step, batch = _train_step()
    state, m = step(state, batch)
    assert torch.isfinite(m['total_loss'])


@pytest.mark.parametrize('V,kw', [(2, {}), (3, {}),
                                  (2, dict(fused_render=True))],
                         ids=['v2', 'v3', 'v2_fused_render'])
def test_render_spans_nest_by_layer(V, kw):
    model = _model(V, **kw).eval()
    encode, render_image = E.make_image_renderer(model, BLOCKS)
    scene = _scene(V)
    want, _ = render_image(scene, encode(scene))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got, _ = render_image(scene, encode(scene))
    assert torch.equal(got, want)

    spans = _spans(prof)
    for name in ('car.encode', 'car.render_image', 'car.pack_pyramid'):
        assert len(_named(spans, name)) == 1, name
    image = _named(spans, 'car.render_image')[0]
    blocks = _named(spans, 'car.block')
    assert len(blocks) == BLOCKS
    assert _named(_inside(spans, image), 'car.block') == blocks
    assert _named(_inside(spans, image), 'car.pack_pyramid')
    for block in blocks:
        within = _inside(spans, block)
        counts = {n: len(_named(within, n)) for n in (
            'car.geometry', 'car.exchange', 'car.address_math',
            'car.attention', 'car.phi')}
        assert counts == {'car.geometry': 3, 'car.exchange': 1,
                          'car.address_math': 1, 'car.attention': 1,
                          'car.phi': 1}, counts
        exchange = _named(within, 'car.exchange')[0]
        assert _named(_inside(spans, exchange), 'car.address_math')
    for leaf in (s for s in spans if s[0] in LEAVES):
        assert not _inside(spans, leaf), leaf


def test_train_step_spans_run_in_order():
    state, step, batch = _train_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, m = step(state, batch)
    assert torch.isfinite(m['total_loss'])
    spans = _spans(prof)
    steps = _named(spans, 'car.train.step')
    assert len(steps) == 1
    parts = [s for s in _inside(spans, steps[0])
             if s[0] in ('car.train.forward', 'car.train.backward',
                         'car.train.clip', 'car.train.adam')]
    assert [s[0] for s in parts] == ['car.train.forward',
                                     'car.train.backward', 'car.train.clip',
                                     'car.train.adam']
    assert all(a[2] <= b[1] for a, b in zip(parts, parts[1:]))
    forward = parts[0]
    assert _named(_inside(spans, forward), 'car.encode')
    assert _named(_inside(spans, forward), 'car.exchange')
