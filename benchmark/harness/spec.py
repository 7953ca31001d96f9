"""The benchmark's description: ``BENCHMARK.json`` at the repo root and the
data files its entries name.

A cell (one entry of ``workloads``) joins a configuration
(``configs/<name>.json``, the file its ``configs`` entry names), a traffic
mix (``traffic/<name>.json``) and its limits (``limits/<cell>.json``: the
numbers its correctness check compares and the limit of each). Per-layer
metrics are readers ``metrics/<name>.py``, found by the metric's name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list
    bench_dir: Path = BENCH_DIR


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell unless the metric
    lists its cells."""
    return 'workloads' not in metric or cell in metric['workloads']


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``, with its data
    read from ``<root>/benchmark/``. Raises KeyError for a name the spec
    does not hold."""
    spec = load_spec(root)
    bench_dir = root / BENCH_DIR.name
    entry = {w['name']: w for w in spec['workloads']}[name]
    cfg_entry = {c['name']: c for c in spec['configs']}[entry['config']]
    e2e = [m for m in spec['end_to_end'] if reports(m, name)]
    moved = {m['name'] for m in e2e}
    per_layer = [m for m in spec['per_layer']
                 if reports(m, name) and m['moves'] in moved]
    return Cell(
        name=name, config=read_json(root / cfg_entry['file']),
        traffic=read_json(bench_dir / 'traffic' / f"{entry['traffic']}.json"),
        limits=read_json(bench_dir / 'limits' / f'{name}.json'),
        chips=int(entry['chips']), end_to_end=e2e, per_layer=per_layer,
        bench_dir=bench_dir)
