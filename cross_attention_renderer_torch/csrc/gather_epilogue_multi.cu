// Fused S-stream exchange epilogue (V>=3) with the cell-row gather inside,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel_multi` launched by
// `_pallas_forward_multi` in cross_attention_renderer_tpu/ops/
// gather_epilogue.py (`fused_exchange_epilogue_multi`, the default V=3
// path). Per stream s of [self, cross_0, cross_1] it combines the sample's
// cell rows and runs the fuse MLP (tanh rows and biases added in f32), then
//
//   jl = lvb + sum_s f_s @ lv[s*O:(s+1)*O]
//   kv = bf16(relu(kmb + sum_s f_s @ km[s*O:(s+1)*O])) @ k2 + k2b,
//
// in the fixed [self, cross_0, ...] order (no per-view swap), the sums over
// streams accumulated in f32 and rounded once, as the TPU kernel does.
//
// What bounds it on an H100: operations. About 3.74 MFLOP a sample (three
// fuse MLPs of 576 -> 576 -> 288, then 864 -> 288 and 864 -> 128 -> 128),
// 4.4 TFLOP a call at the V=3 flagship's 1,179,648 samples of an 8,192-ray
// block: ~4.5 ms at 989 TFLOP/s in bf16. The rows a call's cells reference
// are at most the three pyramid tables (~0.2 GB), far under that in time,
// but the kernel reads a 4.6 KB cell row per sample and stream (~16 GB a
// call) at random from L2 and device memory.
//
// What the design does about it. As in the V=2 kernel (the same kernel,
// exchange_epilogue.cuh), each block fetches its own cell rows with 16-byte
// loads straight into the bilinear combine, so the (3M, 2304) stack of taken
// rows that the TPU path wrote and read back never exists, and only the
// (M, 288) and (M, 128) outputs are written. The V=2 kernel's 64-sample tile
// keeps comb, the hidden layer and the [f_0 | f_1] row in 226 KB of shared
// memory; at S=3 the [f_0 | f_1 | f_2] row is 864 wide and that layout
// would need ~263 KB, over the 227 KB a block may use. Of the two ways out,
// this kernel takes the smaller tile: 48 samples (three m16 row tiles),
// 197 KB. The other way, the TPU kernel's, keeps only one f_s and folds
// f_s @ lv_s and f_s @ km_s into f32 accumulators per stream; at 64 rows
// those accumulators take about 110 f32 registers a thread on top of the
// products' own (or 104 KB of shared memory), so they would spill. The
// smaller tile keeps every stream's f_s, so jl and kh stay single products
// of depth S*O whose f32 sums span all streams, and the kernel is K2's
// unchanged; the price is that each weight fragment fetched from L2 serves
// three row tiles instead of four. A simple first kernel: no TMA, no wgmma,
// one block per SM.

#include "exchange_epilogue.cuh"

// tables[l]: (rows_l, 4 * channels[l]) bf16; cells[l]: (S*M,) int32,
// stream-major; aux[s]: (M, 16) bf16 per stream, 2 <= S <= 4. Weights as in
// exchange_epilogue::Args (bf16 matrices transposed to (out, in), f32
// biases and tanh rows). jl: (M, O), kv: (M, K) bf16. All contiguous.
// Returns a cudaError_t code.
extern "C" int fused_exchange_epilogue_multi_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, int S, void* const* aux, const void* w1t,
    const void* w1_tanh, const void* b1, const void* w2t, const void* b2,
    const void* lvt, const void* lvb, const void* kmt, const void* kmb,
    const void* k2t, const void* k2b, void* jl, void* kv, int M, int F,
    int H1, int O, int K, void* stream) {
  using namespace exchange_epilogue;
  const void* const w[11] = {w1t, w1_tanh, b1,  w2t, b2, lvt,
                             lvb, kmt,     kmb, k2t, k2b};
  Args a;
  // rp is read only by the V=2 view swap.
  const int err = fill_args(a, n_levels, tables, cells, channels, w, jl, kv,
                            S, M, F, H1, O, K, /*rp=*/1);
  if (err) return err;
  for (int s = 0; s < kMaxStreams; ++s)
    a.aux[s] = s < S ? static_cast<const bf16*>(aux[s]) : nullptr;
  return launch<3, false>(a, stream);
}
