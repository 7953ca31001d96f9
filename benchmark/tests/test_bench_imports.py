"""What the benchmark loads: neither JAX nor the JAX package anywhere
under ``benchmark/``, and the program only through
``harness/program.py`` (the reference imports nothing of it). Names are
compared by their top-level part, whole: the port's name begins with the
JAX package's."""

import ast
import subprocess
import sys

import run
from harness import spec

BENCH = spec.BENCH_DIR
FORBIDDEN = set(run.FORBIDDEN)
PORT = 'cross_attention_renderer_torch'


def imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and getattr(
                node.func, 'attr', getattr(node.func, 'id', '')) in (
                'import_module', '__import__'):
            names.add(str(node.args[0].value).split('.')[0])
    return names


def sources():
    return [p for p in BENCH.rglob('*.py') if '__pycache__' not in p.parts]


def test_no_module_imports_jax_or_the_jax_package():
    for p in sources():
        assert not imported(p) & FORBIDDEN, p


def test_only_the_program_module_imports_the_port():
    for p in sources():
        if p.parent.name == 'tests' or p == BENCH / 'harness' / 'program.py':
            continue
        assert PORT not in imported(p), p


def test_a_run_loads_no_jax():
    """The harness and the port as a run loads them leave no JAX module
    in ``sys.modules``."""
    code = ('import sys; sys.path[:0] = [%r, %r]; import run; '
            'from harness import bench, program; '
            'import cross_attention_renderer_torch.train.evaluation, '
            'cross_attention_renderer_torch.train.trainer, '
            'cross_attention_renderer_torch.models.renderer; '
            'print(run.forbidden_modules())' % (str(BENCH),
                                                str(BENCH.parent)))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
