"""Index layouts and index staging (T11-T13).

The Hopper counterpart of the JAX repository's
``tools/micro_kgather_bisect2.py``: every case launches its kernel and
must match its plain version bit for bit (printed as OK), then is timed
beside ``torch.index_select`` (``copy_`` for the fill). 2048 rows, blocks
of 512, an (8192, 256) f32 table:

  T11 ``smem_2d``: T6's fill with the indices as a (4, 512) array;
  T12 ``prefetch_idx``: row gather, each row's index read from device
      memory (the TPU kernel prefetched the whole array);
  T13 ``vmem_idx_dma_smem``: row gather, the block's indices copied to
      shared memory by one bulk copy on an mbarrier first.

  python -m cross_attention_renderer_torch.tools.micro_kgather_bisect2 [case ...]
"""

from __future__ import annotations

import sys

from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from cross_attention_renderer_torch.tools import _common as C

BM = 512
HW = 8192
M = BM * 4


def smem_2d(dev):
    import torch
    idx = torch.arange(M, dtype=torch.int32, device=dev).reshape(M // BM, BM)
    # the (M/BM, BM) array is the same memory as T6's (M,) one
    return C.fill_case('T11', 'smem2d (4, 512) idx', idx.reshape(-1), BM)


def _gather(probe, label, index, dev):
    import torch
    table = C.random_table((HW, 256), torch.float32, 3, dev)
    idx = torch.arange(M, dtype=torch.int32, device=dev) % HW
    return C.gather_case(
        probe, label, lambda t, i: RG.copy_gather(t, i, bm=BM, index=index),
        table, idx)


def prefetch_idx(dev):
    return _gather('T12', f'prefetch f32 ({HW}, 256)', 'global', dev)


def vmem_idx_dma_smem(dev):
    return _gather('T13', f'idx by bulk copy f32 ({HW}, 256)', 'bulk', dev)


CASES = dict(smem2d=smem_2d, prefetch=prefetch_idx,
             vmemdma=vmem_idx_dma_smem)


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
