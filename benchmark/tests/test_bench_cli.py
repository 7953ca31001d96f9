"""``run.py`` without a card: a non-zero exit and no result, from the
repo and from a directory that holds only the benchmark's files."""

import shutil
import subprocess
import sys

from harness import spec

ROOT = spec.ROOT


def run(cwd, *extra):
    return subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 're10k_v2.scenes',
         '--seed', str(2 ** 31 + 5), '--seconds', '1', '--trace', '0',
         *extra], cwd=cwd, capture_output=True, text=True, timeout=300,
        env={'PATH': '/usr/bin:/bin', 'CUDA_VISIBLE_DEVICES': '',
             'HOME': str(cwd)})


def test_without_a_card_it_fails_and_prints_no_result():
    out = run(ROOT)
    assert out.returncode != 0
    assert 'metrics' not in out.stdout and '{' not in out.stdout
    assert 'CUDA' in out.stderr


def test_an_unknown_cell_fails():
    out = subprocess.run(
        [sys.executable, 'benchmark/run.py', '--workload', 'nope',
         '--seed', '1', '--seconds', '1'], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout


def test_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = run(tmp_path)
    assert out.returncode != 0 and not out.stdout
