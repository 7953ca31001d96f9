"""What ``unet_v2`` (the U-Net variant at two views, at its published
widths) and its cell read, pinned: the pyramid's width and levels, the
latent and attention widths, the parameter count of the program's model,
the exchange's and the attention's work of an image, the cell's metrics
and limits, and the faults its calibration plants."""

import hashlib
import json
import math

import pytest
import torch

import calibrate
from harness import bench, spec
from reference import model as ref

WORK = spec.BENCH_DIR / 'work'
CFG = spec.read_json(spec.BENCH_DIR / 'configs' / 'unet_v2.json')
# the exchange: 56.55 TFLOP an image, 7.147 ms a launch (8 an image) at
# 989 TFLOP/s; chip_smoke.py's K2 4-level U-Net bound, 7.135 ms, leaves
# out the fuse MLP's three position columns
EXCHANGE = (56549686902784.0, 10547926656.0)
ATTENTION = (20484980736.0, 14654898176.0)
PARAMETERS = 4178947


def test_the_published_widths():
    s = bench.load_module(WORK / 'shapes.py').sizes(CFG)
    assert (s['F'], s['O'], s['K']) == (960, 480, 128)
    assert (s['phi_hidden'], s['phi_blocks']) == (128, 3)
    assert (s['V'], s['P'], s['R']) == (2, 64, 256 * 256)
    assert ref.pyramid_levels(CFG) == [(64, 2), (128, 4), (256, 8),
                                       (512, 16)]
    assert CFG['model'] == 'unet'
    assert not {'fusion_features', 'vit_width', 'vit_depth', 'vit_heads',
                'resnet_layers', 'pretrain_grid'} & set(CFG)


def test_the_parameters_of_the_programs_model():
    from cross_attention_renderer_torch.models.renderer import (
        CrossAttentionRenderer)
    with torch.device('meta'):
        m = CrossAttentionRenderer(
            n_view=CFG['n_view'], npoints=CFG['n_samples'], model='unet',
            dtype=torch.bfloat16, device='meta')
    assert sum(p.numel() for p in m.parameters()) == PARAMETERS
    specs = ref.param_specs(CFG)
    assert sum(math.prod(shape) for _, shape, _ in specs) == PARAMETERS
    assert (hashlib.sha256(json.dumps(specs).encode()).hexdigest(),
            len(specs)) == ('e5a680475f7aae7a9e999e85bb0da38acc7992f3cd0ab735'
                            'ba4506c0bacf1115', 52)


def test_the_work_of_an_image():
    exchange = bench.load_module(WORK / 'exchange.py').work(CFG, 1)
    assert exchange == EXCHANGE
    assert exchange[0] == pytest.approx(56.6e12, rel=1e-3)
    per_launch_ms = exchange[0] / CFG['ray_blocks'] / 989e12 * 1e3
    assert per_launch_ms == pytest.approx(7.135, rel=0.002)
    assert bench.load_module(WORK / 'attention.py').work(CFG, 1) == ATTENTION
    render_ops = bench.load_module(WORK / 'model.py').render_ops(CFG)
    assert exchange[0] / render_ops > 0.98


def test_the_cell():
    """One chip, the scenes traffic; images/s and p90 end to end (device
    ms spread 0.38% and 0.59% over two sets of six runs, wider than a
    fifth of its 0.02 bound), every ``.render`` reader; the limits, over
    the sound readings (``image_err`` 0.0097-0.0236, ``pyramid_err``
    0.0054-0.0066 on 36 seeds) and under fp8's (0.101-0.243, 0.057-0.073)
    and every planted fault's (``phi_branch`` ``image_err`` 0.0375-0.195,
    ``unet_level`` 0.51-2.73 and 1.0, on 15 seeds); the faults."""
    cell = spec.cell('unet_v2.scenes')
    assert cell.config == CFG and cell.chips == 1
    assert cell.traffic == spec.read_json(
        spec.BENCH_DIR / 'traffic' / 'scenes.json')
    assert [m['name'] for m in cell.end_to_end] == [
        'render_images_per_s', 'render_latency_p90_ms', 'setup_s']
    assert {m['name'] for m in cell.per_layer} == {
        f'{n}.render' for n in (
            'launches_per_image', 'encode_ms', 'exchange_roofline',
            'attention_roofline', 'device_idle', 'mfu', 'ray_math_launches',
            'ray_math_ms', 'ray_math_idle_ms', 'outside_program_idle_ms')}
    assert cell.limits == {'limits': {'image_err': 0.032,
                                      'pyramid_err': 0.02}}
    assert calibrate.branch_faults(CFG) == {
        'unet_level': ('encoder.down5.weight', 'encoder.down5.bias'),
        'phi_branch': ('phi.block1.fc_1.weight', 'phi.block1.fc_1.bias')}
