"""``BENCHMARK.json`` against the benchmark's contract, and every entry
resolved to its files by name."""

import json
import re
from pathlib import Path

import pytest

from harness import spec

ROOT = spec.ROOT
BENCH = spec.BENCH_DIR
SPEC = spec.load_spec()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.\-]{1,16}$')
WIDTH = re.compile(r'(hidden|intermediate|latent|state|projection|head|'
                   r'expansion|experts_per|_dim$|_rank$|width|features)')


def test_top_level_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs',
                         'workloads', 'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark']
    assert SPEC['command'] == ['python3', 'benchmark/run.py']
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (SPEC['run_seconds'] + 60) + cells * 180 + 1200 <= 43200


def test_names_and_units_use_allowed_characters():
    names = ([c['name'] for c in SPEC['configs']]
             + [w['name'] for w in SPEC['workloads']]
             + [w['traffic'] for w in SPEC['workloads']]
             + [m['name'] for m in SPEC['end_to_end'] + SPEC['per_layer']]
             + [k for c in SPEC['configs'] for k in c['reduced']])
    for n in names:
        assert NAME.match(n), n
    for m in SPEC['end_to_end'] + SPEC['per_layer']:
        assert UNIT.match(m['unit']), m['unit']
        assert m['better'] in ('lower', 'higher')
    for text in ([w['why'] for w in SPEC['workloads']]
                 + [c['source'] for c in SPEC['configs']]
                 + [m['layer'] for m in SPEC['per_layer']]):
        assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text


def test_names_are_unique():
    for group in (SPEC['configs'], SPEC['workloads'],
                  SPEC['end_to_end'] + SPEC['per_layer']):
        names = [e['name'] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w['config'], w['traffic']) for w in SPEC['workloads']]
    assert len(pairs) == len(set(pairs))


def test_metrics_follow_the_contract():
    e2e = {m['name']: m for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e
    for m in SPEC['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0 < m['bound'] <= 0.25
    cells = {w['name'] for w in SPEC['workloads']}
    for m in SPEC['per_layer']:
        assert m['moves'] in e2e
        assert m['source'] in ('device_trace', 'program_span',
                               'program_counter', 'host_clock')
        moved = e2e[m['moves']]
        for c in m.get('workloads', cells):
            assert spec.reports(moved, c), (m['name'], c)
        if m['name'].endswith('_roofline') or 'mfu' in m['name']:
            assert m['unit'] == '%'


def test_every_cell_reports_enough():
    for w in SPEC['workloads']:
        cell = spec.cell(w['name'])
        names = [m['name'] for m in cell.end_to_end]
        assert 'setup_s' in names and len(names) >= 2
        assert cell.per_layer, w['name']
        assert w['chips'] in (1, 4)


def test_every_entry_resolves_to_its_files():
    for c in SPEC['configs']:
        path = ROOT / c['file']
        assert path.is_file() and path.relative_to(BENCH)
        cfg = json.loads(path.read_text())
        assert cfg['name'] == c['name']
        assert len(c['reduced']) <= 16
        for key in c['reduced']:
            assert not WIDTH.search(key), key
            assert key in cfg['assumed'], key
    files = [c['file'] for c in SPEC['configs']]
    assert len(files) == len(set(files))
    for w in SPEC['workloads']:
        assert (BENCH / 'traffic' / f"{w['traffic']}.json").is_file()
        limits = json.loads((BENCH / 'limits' / f"{w['name']}.json"
                             ).read_text())['limits']
        assert limits and all(v > 0 for v in limits.values())
    for m in SPEC['per_layer'] + [m for m in SPEC['end_to_end']
                                  if m['source'] == 'device_trace']:
        assert (BENCH / 'metrics' / f"{m['name']}.py").is_file()


def test_every_config_is_used():
    used = {w['config'] for w in SPEC['workloads']}
    assert used == {c['name'] for c in SPEC['configs']}


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob('*'):
        if '__pycache__' in p.parts or p.is_dir():
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.match(r'^[A-Za-z0-9_.\-/]{1,200}$', rel), rel


@pytest.mark.parametrize('name', [w['name'] for w in SPEC['workloads']])
def test_cell_names_its_traffic_kind(name):
    cell = spec.cell(name)
    assert (BENCH / 'kinds' / f"{cell.traffic['kind']}.py").is_file()
    assert Path(cell.bench_dir) == BENCH
