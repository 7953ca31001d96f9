"""Which ways of fetching a row by a run-time index work, and at what cost
(T6-T10).

The Hopper counterpart of the JAX repository's
``tools/micro_kgather_bisect.py``, whose cases bisected what Mosaic
rejects. Here every case launches its kernel and must match its plain
version bit for bit (printed as OK), then is timed beside
``torch.index_select`` (``copy_`` for the fill). 2048 rows, blocks of 512:

  T6  ``smem_block_input``: each block's (512, 128) int32 rows filled with
      its first index;
  T7  ``dyn_row_load_f32``: row gather from an (8192, 256) f32 table, the
      block's indices staged in shared memory;
  T8  ``dyn_row_load_bf16``: the same from (8192, 1024) bf16;
  T9  ``dyn_row_static_store_scratch``: T7 through a one-row shared buffer;
  T10 ``dma_one_row``: one bulk copy a row, one in flight.

  python -m cross_attention_renderer_torch.tools.micro_kgather_bisect [case ...]
"""

from __future__ import annotations

import sys

from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from cross_attention_renderer_torch.tools import _common as C

BM = 512
HW, C4 = 8192, 1024
M = BM * 4


def smem_block_input(dev):
    import torch
    idx = torch.arange(M, dtype=torch.int32, device=dev)
    return C.fill_case('T6', 'smem (512, 128) int32 blocks', idx, BM)


def _gather(probe, label, dtype, width, dev, **kw):
    import torch
    table = C.random_table((HW, width), dtype, 2, dev)
    idx = torch.arange(M, dtype=torch.int32, device=dev) % HW
    kernel = (lambda t, i: RG.bulk_gather(t, i, bm=BM, window=1)) if kw.pop(
        'bulk', False) else (lambda t, i: RG.copy_gather(t, i, bm=BM, **kw))
    return C.gather_case(probe, label, kernel, table, idx)


def dyn_row_load_f32(dev):
    import torch
    return _gather('T7', f'f32 ({HW}, 256)', torch.float32, 256, dev,
                   index='shared')


def dyn_row_load_bf16(dev):
    import torch
    return _gather('T8', f'bf16 ({HW}, {C4})', torch.bfloat16, C4, dev,
                   index='shared')


def dyn_row_static_store_scratch(dev):
    import torch
    return _gather('T9', f'scratch row f32 ({HW}, 256)', torch.float32, 256,
                   dev, index='shared', stage=True)


def dma_one_row(dev):
    import torch
    return _gather('T10', f'dma one row f32 ({HW}, 256)', torch.float32, 256,
                   dev, bulk=True)


CASES = dict(smem=smem_block_input, f32=dyn_row_load_f32,
             bf16=dyn_row_load_bf16, scratch=dyn_row_static_store_scratch,
             dma=dma_one_row)


def run(dev=None, names=None) -> list[dict]:
    dev = dev or C.device()
    records = []
    for name in names or CASES:
        records.append(CASES[name](dev))
        C.ok(name)
    return records


def main() -> None:
    run(names=sys.argv[1:] or None)


if __name__ == '__main__':
    main()
