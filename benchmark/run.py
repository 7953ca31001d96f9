"""The benchmark of the PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. It sets
up (builds the kernels the cell launches into the program's build folder,
makes the weights and the inputs on the card from the seed, warms every
shape up), measures for ``--seconds`` (the traced run: a short window
under ``torch.profiler``), checks what the window produced against the
plain reference under ``benchmark/reference/``, and prints one JSON line
last: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
``breakdown`` (traced) and ``checks``, each number compared beside its
limit (also the last lines of standard error). Without a card, or with
fewer than the cell asks for, it exits non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Neither JAX nor the JAX package may load in this process.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'cross_attention_renderer_tpu')


def _environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout,
    so that only a checkout's first run builds; one host thread for the
    CPU's operators (the program's work is on the card; more threads only
    lengthened and spread the set-up)."""
    build = ROOT / 'cross_attention_renderer_torch' / 'build'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(build / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(build / 'triton')
    os.environ['OMP_NUM_THREADS'] = '1'


def forbidden_modules() -> list:
    return sorted({name.split('.')[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()
    sys.path[:0] = [str(BENCH_DIR), str(ROOT)]

    from harness import spec
    try:
        cell = spec.cell(args.workload)
    except (OSError, KeyError) as e:
        print(f'run.py: no cell {args.workload!r}: {e!r}', file=sys.stderr)
        return 2

    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f'run.py: the cell needs {cell.chips} CUDA card(s); '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}'
              ' visible', file=sys.stderr)
        return 2

    from harness import bench
    result = bench.run(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device('cuda', 0), T0)
    found = forbidden_modules()
    if found:
        print(f'run.py: loaded in this process: {found}', file=sys.stderr)
        return 3
    line = {k: result[k] for k in ('correct', 'attempted', 'failed',
                                   'metrics', 'device')}
    if 'breakdown' in result:
        line['breakdown'] = result['breakdown']
    line['checks'] = result['checks']
    for name, c in result['checks'].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
