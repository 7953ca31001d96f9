"""Profiling: the program's spans, the trace exporter and the card's timers.

Port of ``cross_attention_renderer_tpu/utils/profiling.py``'s named scopes
and trace: :func:`span` marks a layer of the program on the profiler's
timeline (the ``car.*`` spans of ``models/renderer.py``,
``train/evaluation.py`` and ``train/trainer.py``), and :func:`trace`
writes a profiled block of work as a Chrome trace (open it in
chrome://tracing or Perfetto; no TensorBoard plugin needed), spans,
kernels and launches on one clock. Beside them, the card's timers that
``chip_smoke.py`` and the probe scripts share: :func:`cuda_ms` between two
events, and :func:`graph_ms` for work so short that the host's launch cost
would hide it.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Callable, Iterator, Optional

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` span ``name`` while a ``torch.profiler``
    session records on this process, else one shared null context. The
    test is a single query of the profiler's state: an inactive
    ``record_function`` costs ~10 us a span on the host, ~70 spans an
    image. The spans launch nothing; under the profiler they land on the
    kernels' clock, and each launch falls inside the spans open on the
    host when it was made."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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

