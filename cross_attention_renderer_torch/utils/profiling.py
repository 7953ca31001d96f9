"""Profiling and throughput measurement.

Port of ``cross_attention_renderer_tpu/utils/profiling.py``: a profiler
trace of a block of work, written as a Chrome trace (open it in
chrome://tracing or Perfetto; no TensorBoard plugin needed), and a running
rays/s meter. Beside them, the card's timers that ``chip_smoke.py`` and the
probe scripts share: :func:`cuda_ms` between two events, and
:func:`graph_ms` for work so short that the host's launch cost would hide
it.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None
          ) -> Iterator[torch.profiler.profile]:
    """Profiles the block with ``torch.profiler`` (host activity, and the
    card's where ``cuda``, by default when a card is present) and writes
    ``log_dir/trace.json`` when it ends. Yields the profiler, whose
    ``key_averages()`` sum the time by kernel."""
    from torch.profiler import ProfilerActivity, profile
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(out / 'trace.json'))


def cuda_ms(fn: Callable[[], object], iters: int) -> float:
    """Mean device time in ms of ``fn`` over ``iters`` calls after one
    warm-up, between two CUDA events: the host's time to launch each call is
    in it where it exceeds the device's."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn: Callable[[], object], calls: int, replays: int = 3
             ) -> float:
    """Mean device time in ms of one call of ``fn``: ``calls`` back-to-back
    calls captured in one CUDA graph, replayed ``replays`` times between two
    CUDA events, so the host's launch cost drops out. ``fn`` must be
    capturable: no host synchronisation, and no tensor it makes may outlive
    the call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()            # warm-up outside the capture: builds, loads, caches
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    return ms


class ThroughputMeter:
    """Running rays/s and steps/s over the last ``window`` steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._rays: list[int] = []

    def step(self, n_rays: int):
        self._times.append(time.perf_counter())
        self._rays.append(n_rays)
        if len(self._times) > self.window + 1:
            self._times.pop(0)
            self._rays.pop(0)

    @property
    def rays_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return sum(self._rays[1:]) / dt if dt > 0 else None

    @property
    def steps_per_sec(self) -> Optional[float]:
        if len(self._times) < 2:
            return None
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else None
