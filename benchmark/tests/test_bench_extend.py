"""A later change adds a traffic mix, a cell, its limits, a per-layer
metric and a traffic kind as new files and new ``BENCHMARK.json``
entries, and edits no file: the harness finds them all by name."""

import json
import shutil
import time

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
