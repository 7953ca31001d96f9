"""The yardstick's arithmetic against counts made by hand at small widths,
and the per-layer readers on a made-up trace."""

import pytest

from harness import bench, spec, tracing

WORK = spec.BENCH_DIR / 'work'


def load(name):
    return bench.load_module(WORK / f'{name}.py')


def small(**kw):
    # fusion_features 1: the pyramid is 2 x 1 + 64 = 66 wide, the latent
    # 33; the attention width (128) and phi (3 blocks of 128) are fixed
    cfg = {'model': 'midas_vit', 'image_size': [2, 2], 'n_view': 2,
           'n_samples': 3, 'fusion_features': 1, 'vit_width': 8,
           'vit_depth': 1, 'resnet_layers': [1, 1, 1]}
    cfg.update(kw)
    return cfg


def test_sizes_follow_fusion_features():
    s = load('shapes').sizes(small(fusion_features=100))
    assert (s['F'], s['O'], s['K']) == (264, 132, 128)
    assert (s['phi_hidden'], s['phi_blocks']) == (128, 3)


def test_sizes_of_the_other_encoders():
    """ResNet34 and the U-Net: the pyramid's width and levels are their
    own, and no DPT size is carried."""
    shapes = load('shapes')
    for model, F, levels in (
            ('resnet', 512, [(256, 8), (128, 4), (64, 2), (64, 2)]),
            ('unet', 960, [(64, 2), (128, 4), (256, 8), (512, 16)])):
        cfg = {'model': model, 'image_size': [32, 32], 'n_view': 3,
               'n_samples': 4}
        s = shapes.sizes(cfg)
        assert (s['F'], s['O'], s['K']) == (F, F // 2, 128)
        assert not {'ff', 'w', 'depth'} & set(s)
        assert shapes.ref.pyramid_levels(cfg) == levels
        assert shapes.pyramid_bytes(cfg) == 2 * sum(
            (32 // d) ** 2 * ch for ch, d in levels)


def test_encoder_counts_by_hand():
    """ResNet34 (no first pool: 64 @ H/2, 128 @ H/4, 256 @ H/8) and the
    U-Net (32 @ H, then 64, 128, 256, 512 at H/2 .. H/16) at 32x32, two
    views; a multiply-add is two operations."""
    model = load('model')
    c = model.conv
    resnet = c(7, 3, 64, 16, 16) + 6 * c(3, 64, 64, 16, 16)
    resnet += (c(3, 64, 128, 8, 8) + c(1, 64, 128, 8, 8)
               + 7 * c(3, 128, 128, 8, 8))
    resnet += (c(3, 128, 256, 4, 4) + c(1, 128, 256, 4, 4)
               + 11 * c(3, 256, 256, 4, 4))
    unet = (c(7, 3, 32, 32, 32) + c(5, 32, 64, 16, 16)
            + c(3, 64, 128, 8, 8) + c(3, 128, 256, 4, 4)
            + c(3, 256, 512, 2, 2))
    for name, ops in (('resnet', resnet), ('unet', unet)):
        cfg = {'model': name, 'image_size': [32, 32], 'n_view': 2,
               'n_samples': 4}
        assert model.encode_ops(cfg) == 2 * ops
        assert model.render_ops(cfg) == 2 * ops + 32 * 32 * model.ray_ops(
            cfg)


def test_exchange_counts_by_hand():
    # 2 views x 16 rays x 3 samples = 96 samples a stream, 2 streams:
    # fuse (66 + 3) x 66 + 66 x 33 = 6732 a stream, latent 66 x 33, key
    # 66 x 128, key_2 128 x 128 multiply-adds a sample
    ops, nbytes = load('exchange').work(small(image_size=[4, 4]), 1)
    assert ops == 2 * 96 * (2 * 6732 + 66 * 33 + 66 * 128 + 128 * 128)
    pyramid = 2 * (1 * 1 + 4 * 1 + 16 * 64)    # H/4, H/2 at ff, H at 64
    weights = (69 * 66 + 66 * 33 + 66 * 33 + 66 * 128 + 128 * 128) * 2
    assert nbytes == (2 * pyramid + 96 * 2 * 5 * 4 + weights
                      + 96 * (33 + 128) * 2)


def test_attention_counts_by_hand():
    # 96 samples: q1, q2, key (128 each) and the latent (33) read once;
    # two (ray, 33) sums and two (sample) weights written, 2 bytes each
    ops, nbytes = load('attention').work(small(image_size=[4, 4]), 1)
    assert nbytes == 2 * (96 * (3 * 128 + 33) + 2 * (16 * 33 + 96))
    assert ops == 2 * 96 * (2 * 128 + 2 * 33 + 5)


def test_ray_ops_by_hand():
    cfg = small()
    m = 6                                   # samples a ray, both views
    macs = m * 6732 * 2 + m * (66 * 33 + 66 * 128 + 128 * 128)  # exchange
    macs += m * (16 * 128 + 128 * 128)      # query MLP
    macs += 2 * m * (128 + 33)              # two rounds
    macs += 2 * 33 * 128                    # encode_latent, a view
    macs += m * (144 * 128 + 128 * 128)     # repeat query
    macs += 18 * 128 + 3 * (66 * 128 + 2 * 128 * 128) + 128 * 3  # phi
    assert load('model').ray_ops(cfg) == 2 * macs


def test_conv_and_train_ops():
    model = load('model')
    assert model.conv(3, 2, 5, 4, 4) == 2 * 9 * 2 * 5 * 16
    cfg = small(image_size=[64, 64])
    traffic = {'batch': 2, 'rays': 7}
    assert model.train_ops(cfg, traffic) == pytest.approx(
        3 * 2 * (model.encode_ops(cfg) + 7 * model.ray_ops(cfg)))
    assert model.render_ops(cfg) == pytest.approx(
        model.encode_ops(cfg) + 64 * 64 * model.ray_ops(cfg))


def test_flagship_step_matches_the_counted_step():
    # the stage-1 step counted by running it (9.50 TFLOP, PERF.md)
    cell = spec.cell('re10k_v2.train')
    ops = load('model').train_ops(cell.config, cell.traffic)
    assert ops == pytest.approx(9.50e12, rel=0.01)


def _trace():
    # host ops and a window of 10 s; kernels k1 (launched inside encode)
    # and exchange_core (launched in render), a copy; one gap of 3 s
    ev = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'bench.window',
         'ts': 0, 'dur': 10e6, 'tid': 1},
        {'ph': 'X', 'cat': 'user_annotation', 'name': 'bench.encode',
         'ts': 0, 'dur': 1e6, 'tid': 1},
        {'ph': 'X', 'cat': 'cpu_op', 'name': 'aten::mul', 'ts': 4e6,
         'dur': 2e6, 'tid': 1},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
         'ts': 0.5e6, 'dur': 10, 'tid': 1, 'args': {'correlation': 1}},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel',
         'ts': 2e6, 'dur': 10, 'tid': 1, 'args': {'correlation': 2}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k1', 'ts': 1e6, 'dur': 2e6,
         'args': {'correlation': 1}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'exchange_core_kernel<1>',
         'ts': 6e6, 'dur': 3e6, 'args': {'correlation': 2}},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'Memcpy HtoD', 'ts': 9e6,
         'dur': 1e6},
    ]
    return tracing.Trace(ev)


def test_trace_reduction():
    t = _trace()
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(6.0)
    assert t.kernel_seconds([r'exchange_core']) == pytest.approx(3.0)
    assert t.launched_within('bench.encode') == pytest.approx(2.0)
    gaps = dict(t.idle_gaps())
    assert gaps['aten::mul'] == pytest.approx(3.0)
    assert sum(gaps.values()) == pytest.approx(4.0)
    assert t.device_ops()[0] == ['exchange_core_kernel<1>', 3.0]


def test_readers_on_a_trace():
    cell = spec.cell('re10k_v2.scenes_batch4')
    peak = bench.peaks('NVIDIA H100 80GB HBM3')
    out = bench.read_metrics(cell.per_layer, bench.ReadContext(
        _trace(), cell, 1, peak, 0, 3.0))
    assert out['launches_per_image.render']['value'] == 2
    assert out['encode_ms.render']['value'] == pytest.approx(2000.0)
    assert out['device_idle.render']['value'] == pytest.approx(40.0)
    ops, nbytes = load('exchange').work(cell.config, 1)
    assert out['exchange_roofline.render']['value'] == pytest.approx(
        100 * max(ops / 989e12, nbytes / 3.35e12) / 3.0)
    # the untraced window's 3 images a second, not the traced window
    assert out['mfu.render']['value'] == pytest.approx(
        100 * load('model').render_ops(cell.config) * 3.0 / 989e12)
    # no attention kernel in the trace: the reader returns nothing
    assert 'attention_roofline.render' not in out
    # no untraced window: no share of the peak
    assert 'mfu.render' not in bench.read_metrics(
        cell.per_layer, bench.ReadContext(_trace(), cell, 1, peak, 0))


def test_device_time_readers_on_a_trace():
    """A cell whose end-to-end metric is the device time an image: that
    metric from the trace, the per-layer readers it shares with the other
    render cells, and its host-clock numbers reported per layer."""
    cell = spec.cell('re10k_v2.scenes')
    assert [m['name'] for m in cell.end_to_end] == ['render_device_ms',
                                                    'setup_s']
    peak = bench.peaks('NVIDIA H100 80GB HBM3')
    host = {'render_images_per_s': (2.5, 'images/s'),
            'render_latency_p90_ms': (410.0, 'ms')}
    ctx = bench.ReadContext(_trace(), cell, 2, peak, 0, 2.5, host)
    e2e = bench.read_metrics(
        [m for m in cell.end_to_end if m['source'] == 'device_trace'], ctx)
    assert e2e['render_device_ms']['value'] == pytest.approx(3000.0)
    out = bench.read_metrics(cell.per_layer, ctx)
    assert out['launches_per_image.render_device']['value'] == 1
    assert out['encode_ms.render_device']['value'] == pytest.approx(1000.0)
    assert out['device_idle.render_device']['value'] == pytest.approx(40.0)
    # the operations of two images over 6 s of device time
    assert out['mfu.render_device']['value'] == pytest.approx(
        100 * load('model').render_ops(cell.config) * 2 / 6.0 / 989e12)
    assert out['render_images_per_s.host']['value'] == 2.5
    assert out['render_latency_p90_ms.host']['value'] == 410.0
    assert 'attention_roofline.render_device' not in out
    # no device operation in the trace: nothing to read
    empty = tracing.Trace([{'ph': 'X', 'cat': 'user_annotation',
                            'name': 'bench.window', 'ts': 0, 'dur': 1e6}])
    ctx = bench.ReadContext(empty, cell, 2, peak, 0, 2.5, host)
    assert bench.read_metrics(cell.end_to_end[:1], ctx) == {}
