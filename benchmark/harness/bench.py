"""One run of one cell: set-up, the window, the numbers, the check.

A cell's traffic kind is a driver ``kinds/<kind>.py`` (its class
``Driver``), found by the ``kind`` its traffic file names. The run's
host-clock end-to-end metrics come from the driver over the window. A
traced run measures the same window, untraced, and then a short one under
the profiler; its per-layer metrics come from the readers
``metrics/<name>.py``, each given a :class:`ReadContext` of both. An
untraced run of a cell that reports an end-to-end metric whose source is
``device_trace`` makes that short profiled window too, after the timed
one, and takes the metric from its reader ``metrics/<name>.py`` in the
same way. After the windows the device's peak memory is read, the
program and its state are freed, and the reference follows what the
windows produced on the same weights and inputs.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import torch

from harness.spec import BENCH_DIR
from harness.weights import make_weights
from reference import model as ref


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        'bench_' + path.stem.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell):
    """The driver class of ``cell``'s traffic kind."""
    return load_module(cell.bench_dir / 'kinds'
                       / f"{cell.traffic['kind']}.py").Driver


def peaks(kind: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The published peaks of the card ``kind`` (``peaks.json``)."""
    table = json.loads((bench_dir / 'peaks.json').read_text())
    for name, row in table['cards'].items():
        if name in kind:
            return row
    raise KeyError(f'no published peaks for {kind!r} in peaks.json')


class ReadContext:
    """What a reader sees: the trace of the traced window, the cell's
    configuration and traffic, the units (images or steps) traced,
    ``rate``, the units a second of the untraced window (host clock),
    ``host``, the driver's host-clock numbers of that window by name, the
    card's peaks and the work files ``work/<layer>.py``."""

    def __init__(self, trace, cell, units: int, peak: dict,
                 memory_peak_bytes: int, rate: float = 0.0,
                 host: dict | None = None):
        self.trace, self.cfg, self.traffic = trace, cell.config, cell.traffic
        self.units, self.peak, self.rate = units, peak, rate
        self.host = host or {}
        self.memory_peak_bytes = memory_peak_bytes
        self.bench_dir = cell.bench_dir

    def work(self, layer: str):
        return load_module(self.bench_dir / 'work' / f'{layer}.py')


def read_metrics(metrics: list, ctx: ReadContext) -> dict:
    """Each metric of ``metrics`` from its reader ``metrics/<name>.py``; a
    reader that finds nothing returns None, and its metric is left out."""
    out = {}
    for m in metrics:
        value = load_module(ctx.bench_dir / 'metrics'
                            / f"{m['name']}.py").read(ctx)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out


def judge(cell, numbers: dict) -> tuple[bool, dict]:
    """Each number compared beside its limit; correct where none is over
    (a number that is not finite is over)."""
    checks, ok = {}, True
    for name, limit in cell.limits['limits'].items():
        value = numbers[name]
        checks[name] = {'value': value, 'limit': limit}
        ok = ok and math.isfinite(value) and value <= limit
    return ok, checks


def run(cell, seed: int, seconds: float, traced: bool, device,
        t0: float) -> dict:
    """One run; returns the result line's fields."""
    d = driver(cell)(cell, seed, device)
    d.setup(make_weights(cell.config, seed, device))
    setup_s = time.perf_counter() - t0
    w = d.window(seconds, False)
    host = d.end_to_end(w)
    for name, (value, unit) in host.items():
        print(f'window {name} {value!r} {unit}', file=sys.stderr)
    attempted = w['requests']
    from_trace = [m for m in cell.end_to_end
                  if m['source'] == 'device_trace']
    if traced or from_trace:
        wt = d.window(seconds, True)
        attempted += wt['requests']
    cuda = device.type == 'cuda'
    memory = torch.cuda.max_memory_allocated(device) if cuda else 0
    failed = d.failed()
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': cell.chips, 'memory_peak_bytes': int(memory)}
    result = {'attempted': attempted, 'failed': failed}
    if traced or from_trace:
        tr = d.trace
        ctx = ReadContext(
            tr, cell, wt['units'],
            peaks(dev['kind'] if cuda else 'H100', cell.bench_dir), memory,
            w['units'] / w['window_s'], host)
    if traced:
        result['metrics'] = read_metrics(cell.per_layer, ctx)
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result['breakdown'] = {'device_ops': tr.device_ops(),
                               'idle_gaps': tr.idle_gaps()}
    else:
        metrics = {k: {'value': v, 'unit': u} for k, (v, u) in host.items()}
        metrics['setup_s'] = {'value': setup_s, 'unit': 's'}
        if from_trace:
            metrics.update(read_metrics(from_trace, ctx))
        result['metrics'] = {m['name']: metrics[m['name']]
                             for m in cell.end_to_end if m['name'] in metrics}
    result['device'] = dev
    keep = d.checked()
    d.release(keep)
    got = d.program_outputs()
    want = d.reference(make_weights(cell.config, seed, device), ref.F32,
                       keep)
    ok, checks = judge(cell, d.numbers(got, want))
    result['correct'] = ok and failed == 0
    result['checks'] = checks
    return result
