"""Can a kernel gather random rows as fast as ``index_select``? (T1, T2)

The Hopper counterpart of the JAX repository's ``tools/micro_kgather.py``:
at the flagship level-1 shape (32768 rows x 1024 bf16 packed cells) and two
others, 2^20 rows a call,

  T1  ``vmem_loop_gather``: one warp a row from the table (in L2 where it
      fits, 16.8 MB; the 67 MB ones do not), the block's 512 indices
      staged in shared memory, lane loop unrolled 1 and 8;
  T2  ``hbm_dma_gather``: one bulk copy a row, 16 in flight;

each checked bit for bit against ``table[clip(idx)]`` and printed as ms
and ns a row beside ``torch.index_select``.

  python -m cross_attention_renderer_torch.tools.micro_kgather
"""

from __future__ import annotations

from cross_attention_renderer_torch.ops.experimental import row_gather as RG
from cross_attention_renderer_torch.tools import _common as C

M = 1 << 20
BM = 512
SHAPES = ((32768, 1024), (8192, 1024), (131072, 256))


def run(dev=None) -> list[dict]:
    """Every case's numbers (``_common.gather_case``)."""
    import torch
    dev = dev or C.device()
    records = []
    for hw, c4 in SHAPES:
        print(f'--- table ({hw}, {c4}) bf16 = {hw * c4 * 2 / 1e6:.1f} MB ---',
              flush=True)
        table = C.random_table((hw, c4), torch.bfloat16, 0, dev)
        idx = C.random_idx(hw, M, 0, dev)
        for u in (1, 8):
            records.append(C.gather_case(
                'T1', f'vmem loop u{u} {hw}x{c4}',
                lambda t, i, u=u: RG.copy_gather(t, i, bm=BM, unroll=u,
                                                 index='shared'),
                table, idx))
        records.append(C.gather_case(
            'T2', f'hbm dma/row {hw}x{c4}',
            lambda t, i: RG.bulk_gather(t, i, bm=BM, window=16), table, idx))
        del table, idx
    return records


def main() -> None:
    run()


if __name__ == '__main__':
    main()
