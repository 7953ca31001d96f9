"""A later change adds a configuration (of any of the three encoders), a
traffic mix, a cell, its limits, a per-layer metric and a traffic kind as
new files and new ``BENCHMARK.json`` entries, and edits no file: the
harness finds them all by name."""

import json
import re
import shutil
import time

import pytest
import torch

from harness import bench, spec


def test_a_cell_and_a_metric_added_as_files(tmp_path, tiny):
    root = spec.ROOT
    shutil.copytree(root / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    b = tmp_path / 'benchmark'
    s = json.loads((root / 'BENCHMARK.json').read_text())
    (b / 'traffic' / 'scenes_batch2.json').write_text(json.dumps(dict(
        json.loads((b / 'traffic' / 'scenes.json').read_text()),
        scenes_per_request=2, pool_scenes=16)))
    (b / 'limits' / 're10k_v2.scenes_batch2.json').write_text(
        (b / 'limits' / 're10k_v2.scenes.json').read_text())
    (b / 'metrics' / 'requests_traced.render.py').write_text(
        'def read(ctx):\n    return float(ctx.units)\n')
    s['workloads'].append({'name': 're10k_v2.scenes_batch2',
                           'config': 're10k_v2', 'traffic': 'scenes_batch2',
                           'chips': 1, 'why': 'two scenes a call'})
    for m in s['end_to_end']:
        if m['name'] == 'render_images_per_s':
            m['workloads'].append('re10k_v2.scenes_batch2')
    s['per_layer'].append({'name': 'requests_traced.render',
                           'unit': 'count', 'better': 'higher',
                           'source': 'program_counter', 'layer': 'harness',
                           'moves': 'render_images_per_s',
                           'workloads': ['re10k_v2.scenes_batch2']})
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(s))

    cell = spec.cell('re10k_v2.scenes_batch2', root=tmp_path)
    assert cell.traffic['scenes_per_request'] == 2
    assert [m['name'] for m in cell.per_layer] == ['requests_traced.render']
    cell.config = tiny(2)
    r = bench.run(cell, 7, 0.2, True, torch.device('cpu'),
                  time.perf_counter())
    assert r['correct']
    assert r['metrics']['requests_traced.render']['value'] == 8.0


def test_a_traffic_kind_added_as_a_file(tmp_path, tiny):
    """A new kind ``kinds/<kind>.py`` (here one that builds on the render
    kind) and a traffic file naming it."""
    root = spec.ROOT
    shutil.copytree(root / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(root / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    b = tmp_path / 'benchmark'
    (b / 'kinds' / 'render_marked.py').write_text(
        'from pathlib import Path\n'
        'from harness.bench import load_module\n'
        "Base = load_module(Path(__file__).with_name('render.py')).Driver\n"
        'class Driver(Base):\n'
        "    marker = 'render_marked'\n")
    (b / 'traffic' / 'scenes.json').write_text(json.dumps(dict(
        json.loads((b / 'traffic' / 'scenes.json').read_text()),
        kind='render_marked', pool_scenes=16)))
    cell = spec.cell('re10k_v2.scenes', root=tmp_path)
    assert bench.driver(cell).marker == 'render_marked'
    cell.config = tiny(2)
    r = bench.run(cell, 11, 0.2, False, torch.device('cpu'),
                  time.perf_counter())
    assert r['correct'] and r['attempted'] > 0


def test_a_configuration_of_another_encoder_added_as_a_file(tmp_path, tiny,
                                                            capsys):
    """A U-Net configuration, with none of the DPT's keys, added as a
    file and a ``configs`` entry, runs as a traced render cell: correct,
    and its share of the peak counts the U-Net's own operations."""
    root = spec.ROOT
    shutil.copytree(root / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    b = tmp_path / 'benchmark'
    s = json.loads((root / 'BENCHMARK.json').read_text())
    cfg = dict(tiny(2, 'unet'), name='unet_tiny')
    assert not {'fusion_features', 'vit_width', 'vit_depth', 'vit_heads',
                'resnet_layers', 'pretrain_grid'} & set(cfg)
    (b / 'configs' / 'unet_tiny.json').write_text(json.dumps(cfg))
    s['configs'].append({'name': 'unet_tiny',
                         'source': 'https://arxiv.org/abs/2304.08463',
                         'file': 'benchmark/configs/unet_tiny.json',
                         'reduced': ['image_size', 'n_samples'],
                         'why': 'the U-Net encoder, 4 levels 960 wide'})
    s['workloads'].append({'name': 'unet_tiny.scenes', 'config': 'unet_tiny',
                           'traffic': 'scenes', 'chips': 1,
                           'why': 'scene requests through the U-Net'})
    (b / 'limits' / 'unet_tiny.scenes.json').write_text(
        (b / 'limits' / 're10k_v2.scenes.json').read_text())
    for m in s['end_to_end'] + s['per_layer']:
        if m['name'] in ('render_images_per_s', 'mfu.render'):
            m['workloads'].append('unet_tiny.scenes')
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(s))

    cell = spec.cell('unet_tiny.scenes', root=tmp_path)
    assert cell.config == cfg
    cell.traffic = dict(cell.traffic, pool_scenes=16)
    r = bench.run(cell, 2 ** 33 + 17, 0.2, True, torch.device('cpu'),
                  time.perf_counter())
    assert r['correct'], r['checks']
    rate = float(re.search(r'^window render_images_per_s (\S+) images/s$',
                           capsys.readouterr().err, re.M).group(1))
    model = bench.load_module(b / 'work' / 'model.py')
    c = model.conv
    assert model.encode_ops(cell.config) == 2 * (
        c(7, 3, 32, 32, 32) + c(5, 32, 64, 16, 16) + c(3, 64, 128, 8, 8)
        + c(3, 128, 256, 4, 4) + c(3, 256, 512, 2, 2))
    assert r['metrics']['mfu.render']['value'] == pytest.approx(
        100 * model.render_ops(cell.config) * rate / 989e12, rel=1e-12)
