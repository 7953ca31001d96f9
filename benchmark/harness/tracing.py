"""The traced run's window under ``torch.profiler``, reduced to what the
per-layer readers need.

The benchmark marks its own spans (``record_function``) around the calls
into each layer: ``bench.window`` around the traced window, and per
request or step ``bench.request``, ``bench.encode``, ``bench.render`` or
``bench.step``. The profiler's trace (the Chrome format it exports) gives
the device's kernels, copies and fills with their times, each kernel's
launch on the host (by correlation id), and the host's operations. Device
busy time is the union of the device intervals inside the window.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation')


def span(name: str, on: bool):
    """A ``record_function`` span where tracing is on, else nothing."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


@contextlib.contextmanager
def profiled(on: bool):
    """Profiles the body with CPU and CUDA activities where ``on``; yields
    a holder whose ``trace`` is the :class:`Trace` once the body ends."""
    holder = type('Holder', (), {'trace': None})()
    if not on:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = Trace(json.load(f)['traceEvents'])
    finally:
        os.unlink(path)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device and host events of the window (times in seconds)."""

    def __init__(self, events: list):
        launches = {}
        self.device, self.host, self.spans = [], [], defaultdict(list)
        window = None
        for e in events:
            if e.get('ph') != 'X':
                continue
            cat = str(e.get('cat', '')).lower()
            ts, dur = float(e['ts']) * 1e-6, float(e.get('dur', 0)) * 1e-6
            args = e.get('args') or {}
            if cat in DEVICE_CATS:
                self.device.append((e['name'], ts, dur, cat,
                                    args.get('correlation')))
            elif cat in HOST_CATS or cat.startswith('cuda_'):
                # cuda_*: the CUDA runtime's and its lower API's calls
                self.host.append((ts, ts + dur, e['name'], e.get('tid')))
                if cat.startswith('cuda_') and 'correlation' in args:
                    launches[args['correlation']] = ts
                if cat == 'user_annotation':
                    self.spans[e['name']].append((ts, ts + dur))
                    if e['name'] == 'bench.window':
                        window = (ts, ts + dur)
        if window is None:
            raise RuntimeError('the trace holds no bench.window span')
        self.t0, self.t1 = window
        self.window_s = self.t1 - self.t0
        self.device = [(n, ts, dur, cat, launches.get(c))
                       for n, ts, dur, cat, c in self.device
                       if ts < self.t1 and ts + dur > self.t0]
        self.busy = _merge((max(ts, self.t0), min(ts + dur, self.t1))
                           for _, ts, dur, _, _ in self.device)
        self.busy_s = sum(e - s for s, e in self.busy)

    def kernels(self):
        return [d for d in self.device if d[3] == 'kernel']

    def kernel_seconds(self, patterns) -> float:
        """Device seconds of the kernels whose name matches one of the
        regular expressions ``patterns``."""
        rx = [re.compile(p) for p in patterns]
        return sum(dur for n, _, dur, _, _ in self.kernels()
                   if any(r.search(n) for r in rx))

    def launched_within(self, span_name: str) -> float:
        """Device seconds of the kernels launched while ``span_name`` was
        open on the host."""
        spans = sorted(self.spans.get(span_name, ()))
        starts = [s for s, _ in spans]
        total = 0.0
        for _, _, dur, _, at in self.device:
            if at is None:
                continue
            i = bisect.bisect_right(starts, at) - 1
            if i >= 0 and at <= spans[i][1]:
                total += dur
        return total

    def device_ops(self, top: int = 10) -> list:
        """The device operations that took the most time: [[name, s]]."""
        acc = defaultdict(float)
        for n, _, dur, _, _ in self.device:
            acc[n[:120]] += dur
        return [[n, s] for n, s in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The device's idle time inside the window by what the host was
        doing: each gap is named by the innermost host operation open at
        its middle, on any thread (the backward pass runs on autograd's
        own). [[name, s]], most first."""
        gaps, last = [], self.t0
        for s, e in self.busy:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if last < self.t1:
            gaps.append((last, self.t1))
        ops = sorted((s, e, n, tid) for s, e, n, tid in self.host)
        acc = defaultdict(float)
        stacks, i = defaultdict(list), 0
        for gs, ge in gaps:
            mid = 0.5 * (gs + ge)
            while i < len(ops) and ops[i][0] <= mid:
                st = stacks[ops[i][3]]
                while st and st[-1][1] < ops[i][0]:
                    st.pop()
                st.append(ops[i])
                i += 1
            open_ = []
            for st in stacks.values():
                while st and st[-1][1] < mid:
                    st.pop()
                if st:
                    open_.append(st[-1])
            name = max(open_)[2][:120] if open_ else 'host'
            acc[name] += ge - gs
        return [[n, s] for n, s in sorted(acc.items(),
                                          key=lambda kv: -kv[1])[:top]]
