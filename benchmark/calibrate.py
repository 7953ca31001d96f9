"""Readings that a cell's correctness limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \
        --control 3 [--first-seed N]

For each seed: the cell's set-up and a short window through the
program's entry points at the cell's sizes, then the numbers its check
compares for the program (the lower readings) and, on the first
``--control`` seeds, for the control: the reference in fp8 put in the
program's place (the upper readings). On those seeds a train cell also
reads the fault of half of each batch left out, and a render cell those
of one residual branch or level of the encoder, or one of phi's
branches, dropped (``branch_faults``), each planted in the f32 reference
put in the program's place. One JSON line a seed, then a summary line:
the largest program reading and the smallest control reading of each
number.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, default=12)
    p.add_argument('--control', type=int, default=3)
    p.add_argument('--first-seed', type=int, default=3_000_000_001)
    p.add_argument('--seconds', type=float, default=2.0)
    args = p.parse_args(argv)

    import run as entry
    entry._environment()
    import torch
    if not torch.cuda.is_available():
        print('calibrate.py: needs a CUDA card', file=sys.stderr)
        return 2
    from harness import spec
    cell = spec.cell(args.workload)
    dev = torch.device('cuda', 0)
    summary = readings(cell, args.first_seed, args.seeds, args.control,
                       args.seconds, dev, print_row)
    summary['card'] = torch.cuda.get_device_name(dev)
    print_row(summary)
    return 0


def print_row(row: dict) -> None:
    print(json.dumps(row), flush=True)


def readings(cell, first_seed: int, seeds: int, control: int,
             seconds: float, dev, emit) -> dict:
    """Runs the seeds, emits one row a seed; returns the summary."""
    import torch
    from harness import bench
    from harness.weights import make_weights
    from reference import model as ref
    fp8 = ref.Numerics('fp8')
    prog, ctrl = {}, {}
    for k in range(seeds):
        seed = first_seed + 7919 * k
        t = time.perf_counter()
        d = bench.driver(cell)(cell, seed, dev)
        d.setup(make_weights(cell.config, seed, dev))
        d.window(seconds, False)
        failed = d.failed()
        keep = d.checked()
        d.release(keep)
        weights = make_weights(cell.config, seed, dev)
        want = d.reference(weights, ref.F32, keep)
        got = d.program_outputs()
        row = {'seed': seed, 'failed': failed,
               'program': d.numbers(got, want)}
        outs = {'program': got}
        if k < control:
            outs['control'] = d.reference(weights, fp8, keep)
            row['control'] = d.numbers(outs['control'], want)
            if cell.traffic['kind'] == 'render':
                for name, zeroed in branch_faults(cell.config).items():
                    faulty = dict(weights)
                    for n in zeroed:
                        faulty[n] = torch.zeros_like(weights[n])
                    row[name] = d.numbers(
                        d.reference(faulty, ref.F32, keep), want)
            if cell.traffic['kind'] == 'train':
                outs['half_batch'] = d.reference(weights, ref.F32, keep,
                                                 batch_share=0.5)
                row['half_batch'] = d.numbers(outs['half_batch'], want)
        if cell.traffic['kind'] == 'train':
            row['look'] = {k: _look(v, want) for k, v in outs.items()}
        else:
            row['look'] = {i: {'rms': float(r.square().mean().sqrt()),
                               'std': float(r.std())}
                           for i, (r, _) in want.items()}
        for name, v in row['program'].items():
            prog[name] = max(prog.get(name, 0.0), v)
        for name, v in row.get('control', {}).items():
            ctrl[name] = min(ctrl.get(name, float('inf')), v)
        row['s'] = time.perf_counter() - t
        emit(row)
        del d, weights, want
        if dev.type == 'cuda':
            torch.cuda.empty_cache()
    return {'workload': cell.name, 'lower': prog, 'upper_control': ctrl}


def branch_faults(cfg: dict) -> dict:
    """Faults planted in the reference put in the program's place, in
    the configuration's encoder and in phi: in the DPT one residual branch
    dropped (its last product or norm zeroed) in the R50, the ViT and the
    RefineNet; in ResNet34 its last block's branch (the block's second
    norm zeroed); in the U-Net its coarsest level (``down5`` zeroed); and
    one of phi's branches."""
    from reference import model as ref
    model = ref.encoder(cfg)
    if model == 'midas_vit':
        last = len(cfg['resnet_layers']) - 1
        r50 = (f'encoder.backbone.stage{last}_block'
               f"{cfg['resnet_layers'][last] - 1}.norm3.GroupNorm_0")
        vit = f"encoder.vit.block{cfg['vit_depth'] // 2}.mlp_fc2"
        faults = {'r50_branch': r50, 'vit_branch': vit,
                  'refinenet_branch': 'encoder.refinenet2.rcu1.conv2'}
    elif model == 'resnet':
        last = list(ref.resnet34_blocks())[-1][0]
        faults = {'resnet_branch': f'{last}.norm2'}
    else:
        faults = {'unet_level': f'encoder.down{len(ref.UNET_DOWN) + 1}'}
    faults['phi_branch'] = 'phi.block1.fc_1'
    return {k: (f'{v}.weight', f'{v}.bias') for k, v in faults.items()}


def _look(got: dict, want: dict) -> dict:
    """Where a train cell's numbers come from: each step's loss gap, and
    the three parameters with the largest gradient and change gaps."""
    import statistics
    g_med = statistics.median(want['first_grad'].values())
    c_med = statistics.median(want['change'].values())

    def top(key, med):
        gaps = {n: abs(got[key].get(n, 0.0) - r) / max(r, med)
                for n, r in want[key].items()}
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:3]

    return {'loss_steps': [abs(a - b) / abs(b) for a, b in
                           zip(got['losses'], want['losses'])],
            'grad_top': top('first_grad', g_med),
            'change_top': top('change', c_med),
            'grad_median_leaf': statistics.median(
                abs(got['first_grad'].get(n, 0.0) - r) / max(r, g_med)
                for n, r in want['first_grad'].items())}


if __name__ == '__main__':
    sys.exit(main())
