"""The program-span readers (``harness/spans.py``, the ``ray_math_*``,
``*_idle_ms`` and ``outside_program_idle_ms`` metrics) on made-up traces
with nested ``car.*`` spans, each against its value counted by hand; and
a traced window of the render kind on the CPU, whose trace holds the
port's spans."""

import pytest
import torch

from harness import bench, spans, spec, tracing
from harness.weights import make_weights

PEAK = bench.peaks('NVIDIA H100 80GB HBM3')


def _span(name, start, end, tid=1):
    return {'ph': 'X', 'cat': 'user_annotation', 'name': name,
            'ts': start * 1e6, 'dur': (end - start) * 1e6, 'tid': tid}


def _kernel(name, launch, start, end, corr, tid=1):
    """A kernel and the CUDA call that launched it (by correlation id)."""
    return [{'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
             'ts': launch * 1e6, 'dur': 5, 'tid': tid,
             'args': {'correlation': corr}},
            {'ph': 'X', 'cat': 'kernel', 'name': name, 'ts': start * 1e6,
             'dur': (end - start) * 1e6, 'args': {'correlation': corr}}]


def render_trace():
    """A 20 s window: encode 0-2 s, then an image 2-18 s in two blocks.
    The first block's geometry (3-4), exchange (4-7) with its address math
    (4-6), query features (7-8), attention (8-9) and phi (9-10); the
    second block's address math (10-12) overlaps a geometry span (11-13).
    Busy: 5.1 s, so 14.9 s idle."""
    ev = [_span('bench.window', 0, 20), _span('bench.request', 0, 18.5),
          _span('car.encode', 0, 2), _span('car.render_image', 2, 18),
          _span('car.pack_pyramid', 2, 3), _span('car.block', 3, 10),
          _span('car.geometry', 3, 4), _span('car.exchange', 4, 7),
          _span('car.address_math', 4, 6), _span('car.geometry', 7, 8),
          _span('car.attention', 8, 9), _span('car.phi', 9, 10),
          _span('car.block', 10, 17), _span('car.address_math', 10, 12),
          _span('car.geometry', 11, 13),
          {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy DtoD',
           'ts': 19e6, 'dur': 0.5e6}]
    ev += _kernel('encoder', 0.2, 0.5, 1.5, 1)
    ev += _kernel('geometry_add', 3.1, 3.5, 3.8, 2)
    ev += _kernel('CatArrayBatchedCopy', 4.1, 4.5, 5.0, 3)
    ev += _kernel('exchange_core_kernel', 6.5, 6.0, 8.5, 4)
    ev += _kernel('address_mul', 10.5, 11.0, 11.2, 5)
    ev += _kernel('geometry_tanh', 12.5, 12.5, 12.6, 6)
    return tracing.Trace(ev)


def train_trace():
    """A 10 s window of one step (1-9 s) inside the benchmark's step span:
    forward 1-4 (the model's encode within it), backward 4-7 (its kernel
    launched on autograd's thread), clip 7-7.5, Adam 7.5-8.5; the batch
    drawn before the step. Busy: 5.0 s, so 5.0 s idle."""
    ev = [_span('bench.window', 0, 10), _span('bench.step', 0, 10),
          _span('car.train.step', 1, 9), _span('car.train.forward', 1, 4),
          _span('car.encode', 1, 2), _span('car.train.backward', 4, 7),
          _span('car.train.clip', 7, 7.5), _span('car.train.adam', 7.5, 8.5)]
    ev += _kernel('draw_batch', 0.1, 0.2, 0.6, 1)
    ev += _kernel('conv_forward', 1.1, 1.5, 3.0, 2)
    ev += _kernel('conv_backward', 4.5, 5.0, 6.5, 3, tid=2)
    ev += _kernel('foreach_norm', 7.1, 7.2, 7.3, 4)
    ev += _kernel('fused_adam', 7.6, 8.0, 9.5, 5)
    return tracing.Trace(ev)


def _read(cell_name, trace, units):
    cell = spec.cell(cell_name)
    out = bench.read_metrics(cell.per_layer,
                             bench.ReadContext(trace, cell, units, PEAK, 0))
    return {k: v['value'] for k, v in out.items()}


def test_union_counts_overlapping_spans_once():
    t = render_trace()
    assert spans.union(t, spans.RAY_MATH) == [(3, 6), (7, 8), (10, 13)]
    assert spans.union(t, ('car.address_math', 'car.geometry',
                           'car.address_math')) == [(3, 6), (7, 8),
                                                    (10, 13)]
    # clipped to the window
    assert spans.union(t, ('bench.request',)) == [(0, 18.5)]
    assert spans.union(t, ('no.such.span',)) == []


@pytest.mark.parametrize('cell,suffix', [
    ('co3d_v3.scenes', 'render'), ('re10k_v2.scenes_batch4', 'render'),
    ('re10k_v2.scenes', 'render_device')])
def test_render_readers_by_hand(cell, suffix):
    got = _read(cell, render_trace(), 2)
    # launched inside ray math at 3.1, 4.1, 10.5, 12.5 s, not the core at
    # 6.5 s: 4 kernels of 0.3 + 0.5 + 0.2 + 0.1 s over 2 images
    assert got[f'ray_math_launches.{suffix}'] == 2
    assert got[f'ray_math_ms.{suffix}'] == pytest.approx(550.0)
    # idle in 3-6 (2.2 s), 7-8 (none: the core runs), 10-13 (2.7 s)
    assert got[f'ray_math_idle_ms.{suffix}'] == pytest.approx(2450.0)
    # 18-20 s less the 0.5 s copy
    assert got[f'outside_program_idle_ms.{suffix}'] == pytest.approx(750.0)


def test_render_idle_parts_sum_to_the_window_idle():
    t = render_trace()
    window_idle = t.window_s - t.busy_s
    assert window_idle == pytest.approx(14.9)
    ray = spans.idle_inside(t, spans.union(t, spans.RAY_MATH))
    # the program's other time, by hand: 0-3 (2.0 s idle), 6-7 (none),
    # 8-10 (1.5 s), 13-18 (5.0 s)
    others = 2.0 + 0.0 + 1.5 + 5.0
    outside = spans.idle_outside(
        t, spans.union(t, spans.program_names(t)))
    assert ray + others + outside == pytest.approx(window_idle)
    assert ray == pytest.approx(4.9) and outside == pytest.approx(1.5)


def test_train_readers_by_hand():
    t = train_trace()
    got = _read('re10k_v2.train', t, 2)
    assert got['forward_idle_ms.train'] == pytest.approx(750.0)
    # the backward kernel, launched on another thread, fills 5-6.5 s
    assert got['backward_idle_ms.train'] == pytest.approx(750.0)
    # 7-8.5 s less the norm's 0.1 s and Adam's 0.5 s
    assert got['optimizer_idle_ms.train'] == pytest.approx(450.0)
    # 0-1 s less the batch's 0.4 s, 9-10 s less Adam's last 0.5 s
    assert got['outside_program_idle_ms.train'] == pytest.approx(550.0)
    parts = sum(got[f'{n}_idle_ms.train'] for n in (
        'forward', 'backward', 'optimizer', 'outside_program'))
    # the step's 8.5-9 s is busy, so the parts make the window's idle
    assert parts * 2 / 1e3 == pytest.approx(t.window_s - t.busy_s)


def test_readers_find_nothing_without_program_spans():
    """A parent without the spans: every new reader returns nothing."""
    ev = [_span('bench.window', 0, 10), _span('bench.render', 1, 9)]
    ev += _kernel('k', 1.5, 2.0, 3.0, 1)
    t = tracing.Trace(ev)
    new = ('ray_math', 'outside_program', 'forward_idle', 'backward_idle',
           'optimizer_idle')
    for cell in ('re10k_v2.scenes', 'co3d_v3.scenes', 're10k_v2.train'):
        assert not [k for k in _read(cell, t, 1) if k.startswith(new)]


def test_a_traced_cpu_window_holds_the_program_spans(tiny):
    cell = spec.cell('re10k_v2.scenes')
    cell.config = tiny(2)
    cell.traffic = dict(cell.traffic, pool_scenes=16)
    dev = torch.device('cpu')
    d = bench.driver(cell)(cell, 3, dev)
    d.setup(make_weights(cell.config, 3, dev))
    n = d.window(1.0, True)['requests']
    got = {k: len(v) for k, v in d.trace.spans.items()
           if k.startswith(spans.PROGRAM)}
    blocks = n * cell.config['ray_blocks']
    assert got == {'car.encode': n, 'car.render_image': n,
                   'car.pack_pyramid': n, 'car.block': blocks,
                   'car.geometry': 3 * blocks, 'car.exchange': blocks,
                   'car.address_math': blocks, 'car.attention': blocks,
                   'car.phi': blocks}
    assert spans.program_names(d.trace) == sorted(got)
