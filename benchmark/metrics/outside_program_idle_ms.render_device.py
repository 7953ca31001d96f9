"""``outside_program_idle_ms.render``, in the cells whose end-to-end metric is
``render_device_ms`` (their images a second are reported per layer)."""

from pathlib import Path

from harness.bench import load_module

read = load_module(
    Path(__file__).with_name('outside_program_idle_ms.render.py')).read
