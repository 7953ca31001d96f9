// Fused V=2 exchange epilogue with the cell-row gather inside, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` launched by `_pallas_forward` in
// cross_attention_renderer_tpu/ops/gather_epilogue.py (the V=2
// `fused_exchange_epilogue`). The kernel (exchange_epilogue.cuh, with
// kViewSwap) runs tiles of 64 samples; per stream (self, then cross) it
// combines the cell rows and runs the fuse MLP, places bf16(f) in the
// [a | b] halves of the sample's row by its view id (m // rp) % 2 (view 0:
// [self, cross], view 1: [cross, self]) and writes
//
//   jl = [a | b] @ lv + lvb
//   kv = bf16(relu([a | b] @ km + kmb)) @ k2 + k2b.
//
// What bounds it on an H100: about 2.5 MFLOP a sample in the matrix
// products (2.6 TFLOP a call at the flagship's 1,048,576 samples, ~2.7 ms at
// 989 TFLOP/s in bf16) against ~9.7 GB of cell rows read at random (~2.9 ms
// at 3.35 TB/s): both sides are close, so neither may be wasted.
//
// What the design does about it. On the TPU the row take ran outside the
// kernel, only because Mosaic cannot address single rows; outside a kernel
// that take writes a (2M, 2304) bf16 stack (~9.7 GB) and reads it back. Here
// each block fetches its own cell rows with 16-byte loads straight into the
// bilinear combine, so rows cross device memory once and nothing but the
// (M, 288) and (M, 128) outputs is written. Every intermediate of a tile
// (the combine, the hidden layer, the [a | b] latent pair) lives in shared
// memory, 226 KB at the flagship widths. The products run on the tensor
// cores through mma.sync m16n8k16 (bf16 in, f32 accumulate, mma_tile.cuh);
// each warp owns a slice of output columns for all 64 rows, so every weight
// fragment it fetches from L2 (the ~1.5 MB of bf16 weights stay there)
// serves four row tiles, and the fragments of the next four k-steps are
// requested before the current ones are multiplied. A simple first kernel:
// no TMA, no wgmma, one block per SM.

#include "exchange_epilogue.cuh"

// tables[l]: (rows_l, 4 * channels[l]) bf16; cells[l]: (2M,) int32, the
// self stream's rows then the cross stream's; aux_self, aux_cross: (M, 16)
// bf16. Weights as in exchange_epilogue::Args (bf16 matrices transposed to
// (out, in), f32 biases and tanh rows). jl: (M, O), kv: (M, K) bf16. All
// contiguous. Returns a cudaError_t code.
extern "C" int fused_exchange_epilogue_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* w1t, const void* w1_tanh, const void* b1, const void* w2t,
    const void* b2, const void* lvt, const void* lvb, const void* kmt,
    const void* kmb, const void* k2t, const void* k2b, void* jl, void* kv,
    int M, int F, int H1, int O, int K, int rp, void* stream) {
  using namespace exchange_epilogue;
  const void* const w[11] = {w1t, w1_tanh, b1,  w2t, b2, lvt,
                             lvb, kmt,     kmb, k2t, k2b};
  Args a;
  const int err = fill_args(a, n_levels, tables, cells, channels, w, jl, kv,
                            2, M, F, H1, O, K, rp);
  if (err) return err;
  a.aux[0] = static_cast<const bf16*>(aux_self);
  a.aux[1] = static_cast<const bf16*>(aux_cross);
  a.aux[2] = a.aux[3] = nullptr;
  return launch<4, true>(a, stream);
}
