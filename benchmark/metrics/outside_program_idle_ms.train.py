"""``outside_program_idle_ms.render``, a step: the device's idle ms while
no ``car.*`` span was open, in the train cells (the benchmark draws each
step's batch there, inside ``bench.step`` but outside the program)."""

from pathlib import Path

from harness.bench import load_module

read = load_module(
    Path(__file__).with_name('outside_program_idle_ms.render.py')).read
