"""The per-row gather rate with prefetched indices, and how many indices a
call takes (T3).

The Hopper counterpart of the JAX repository's ``tools/micro_kgather2.py``
(``gather_prefetch``): one warp a row, each block reading its indices from
device memory (where the TPU kernel prefetched the whole index array into
SMEM); the rate at 2^16 rows on three tables for blocks of 512 and 2048
rows and the lane loop unrolled 1, 4 and 8, then the index-capacity
sweep, 2^14 to 2^20 indices on a (1024, 256) table (on Hopper no on-chip
buffer bounds it), each beside ``torch.index_select``.

  python -m cross_attention_renderer_torch.tools.micro_kgather2
"""

from __future__ import annotations

from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from cross_attention_renderer_torch.tools import _common as C

M = 1 << 16
SHAPES = ((8192, 1024), (32768, 1024), (131072, 256))


def run(dev=None) -> list[dict]:
    import torch
    dev = dev or C.device()
    records = []
    for hw, c4 in SHAPES:
        table = C.random_table((hw, c4), torch.bfloat16, 0, dev)
        idx = C.random_idx(hw, M, 0, dev)
        for bm in (512, 2048):
            for u in (1, 4, 8):
                records.append(C.gather_case(
                    'T3', f'loop bm={bm} u={u} {hw}x{c4} M={M}',
                    lambda t, i, bm=bm, u=u: RG.copy_gather(
                        t, i, bm=bm, unroll=u), table, idx))
    table = C.random_table((1024, 256), torch.bfloat16, 1, dev)
    for logm in (14, 16, 18, 20):
        idx = C.random_idx(1024, 1 << logm, logm, dev)
        records.append(C.gather_case(
            'T3', f'prefetch {1 << logm} idx ({(1 << logm) * 4 // 1024} KB)',
            lambda t, i: RG.copy_gather(t, i, bm=512), table, idx))
    return records


def main() -> None:
    run()


if __name__ == '__main__':
    main()
