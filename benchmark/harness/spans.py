"""The program's own spans in a traced window: interval arithmetic on a
:class:`harness.tracing.Trace`.

The port marks its layers with ``car.*`` spans (``record_function``,
recorded only while a profiler runs, so the traced windows turn them on
and the timed ones leave them off). They land in the same trace as the
kernels, on the same clock. A span set is read as the union of its spans'
intervals on the host (nested or overlapping spans count once), clipped
to the window; a kernel belongs to it where its launch (the CUDA call that
the profiler ties to the kernel by correlation id) falls inside that
union, on any thread; the device is idle inside it where the union holds
no device operation. Only the trace's public fields are read: ``spans``,
``busy``, ``t0``, ``t1`` and ``device``.
"""

from __future__ import annotations

import bisect

PROGRAM = 'car.'
# the ray math: leaves, no program span opens inside them
RAY_MATH = ('car.geometry', 'car.address_math')


def program_names(trace) -> list[str]:
    """The names of the program's spans in the trace."""
    return sorted(n for n in trace.spans if n.startswith(PROGRAM))


def union(trace, names) -> list[tuple[float, float]]:
    """The union of the intervals of the spans ``names``, clipped to the
    window: sorted, disjoint (start, end) pairs in seconds."""
    out = []
    for s, e in sorted((max(s, trace.t0), min(e, trace.t1))
                       for n in names for s, e in trace.spans.get(n, ())):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _length(intervals) -> float:
    return sum(e - s for s, e in intervals)


def _overlap(a, b) -> float:
    """The length of the intersection of two sorted disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def launched_inside(trace, intervals) -> list:
    """The device kernels launched while the host was inside
    ``intervals``: the trace's ``device`` entries (name, start, seconds,
    category, launch time)."""
    starts = [s for s, _ in intervals]
    out = []
    for d in trace.device:
        at = d[4]
        if d[3] != 'kernel' or at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= intervals[i][1]:
            out.append(d)
    return out


def idle_inside(trace, intervals) -> float:
    """Seconds of ``intervals`` in which no operation ran on the device."""
    return _length(intervals) - _overlap(intervals, trace.busy)


def idle_outside(trace, intervals) -> float:
    """Seconds of the window outside ``intervals`` in which no operation
    ran on the device."""
    window_idle = (trace.t1 - trace.t0) - _length(trace.busy)
    return window_idle - idle_inside(trace, intervals)
