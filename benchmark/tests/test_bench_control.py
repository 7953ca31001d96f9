"""The control at a size a CPU test holds: the reference in fp8 put in the
program's place is judged not correct by the cell's limits, where the
program passes. Render cells run the program in bf16, as configured; at
the train cell's tiny size a bf16 step's median gradient gap is as wide
as fp8's (a 2 x 16-ray batch through a 2-block model), so the program
runs there in f32. (On the chip, at the cells' own sizes, bf16 against
fp8: ``calibrate.py``; PERF.md gives those readings.)"""

import pytest
import torch

import calibrate
from harness import bench, spec

CPU = torch.device('cpu')


def tiny_cell(name, tiny):
    cell = spec.cell(name)
    train = cell.traffic['kind'] == 'train'
    cell.config = tiny(cell.config['n_view'],
                       dtype='float32' if train else 'bfloat16')
    if train:
        cell.traffic = dict(cell.traffic, batch=2, rays=16)
    else:
        cell.traffic = dict(cell.traffic, pool_scenes=32)
    return cell


@pytest.mark.parametrize('name', ['re10k_v2.scenes', 'co3d_v3.scenes',
                                  're10k_v2.train'])
def test_the_control_fails_where_the_program_passes(tiny, name):
    cell = tiny_cell(name, tiny)
    rows = []
    summary = calibrate.readings(cell, 2 ** 31 + 3, 2, 2, 0.2, CPU,
                                 rows.append)
    for row in rows:
        ok, _ = bench.judge(cell, row['control'])
        assert not ok, row
        ok, _ = bench.judge(cell, row['program'])
        assert ok, row
    assert any(summary['upper_control'][k] > 3 * summary['lower'][k]
               for k in cell.limits['limits'])
