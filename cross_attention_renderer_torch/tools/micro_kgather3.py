"""Gathering whole tiles, and one bulk copy a row (T4, T5).

The Hopper counterpart of the JAX repository's ``tools/micro_kgather3.py``
at 2^16 rows a call:

  T4  ``tile_gather``: one (16, 128) bf16 tile (4 KB) a row from a
      (16384, 16, 128) table, one warp a row, lane loop unrolled 1, 4, 8;
  T5  ``dma_gather``: one bulk copy a row of a (16384, 1024) bf16 table,
      16 in flight;

each beside ``torch.index_select`` on the same table.

  python -m cross_attention_renderer_torch.tools.micro_kgather3
"""

from __future__ import annotations

from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from cross_attention_renderer_torch.tools import _common as C

M = 1 << 16
BM = 512
HW = 16384


def run(dev=None) -> list[dict]:
    import torch
    dev = dev or C.device()
    records = []
    table3 = C.random_table((HW, 16, 128), torch.bfloat16, 0, dev)
    idx = C.random_idx(HW, M, 0, dev)
    for u in (1, 4, 8):
        records.append(C.gather_case(
            'T4', f'tile-row loop u={u} ({HW},16,128)',
            lambda t, i, u=u: RG.copy_gather(t, i, bm=BM, unroll=u),
            table3, idx))
    table = table3.reshape(HW, 2048)[:, :1024].contiguous()
    del table3
    records.append(C.gather_case(
        'T5', f'dma-per-row ({HW},1024) window=16',
        lambda t, i: RG.bulk_gather(t, i, bm=BM, window=16), table, idx))
    return records


def main() -> None:
    run()


if __name__ == '__main__':
    main()
