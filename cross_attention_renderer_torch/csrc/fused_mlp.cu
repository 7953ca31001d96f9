// Fused two-layer per-sample MLP, out = relu(x1 @ W1a + x2 @ W1b + b1) @ W2
// + b2, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` launched by `fused_mlp2` in
// cross_attention_renderer_tpu/ops/experimental/fused_mlp.py. For a tile of
// 64 rows
//
//   h   = relu(x1 @ W1a + sum_j x2_j * W1b[j] + b1)  (f32 sums, f32 bias)
//   out = bf16(h) @ W2 + b2                          (f32 sum, f32 bias)
//
// with the cast points of the TPU kernel: x2 and the weight matrices in
// bf16, biases in f32, h rounded to the weight type before the second
// product.
//
// What bounds it on an H100: operations. At the renderer's fuse MLP
// (K1 = 576, H = 576, O = 288) a row costs ~1.0 MFLOP against 1.7 KB of x1
// and out; 393,216 rows a call (one view's samples of an 8,192-ray block at
// V=3, 48 samples) are 0.39 TFLOP, ~0.40 ms at 989 TFLOP/s, against
// ~0.68 GB, ~0.20 ms at 3.35 TB/s.
//
// What the design does about it: it is the exchange core's kMlp
// instantiation (exchange_core.cuh). A persistent block per SM walks over
// 64-row tiles: both consumer warpgroups load the tile's x1 rows with
// 16-byte loads into comb, the swizzled wgmma A tile, and x2 where the
// exchange reads tanh(pt/5); they split the hidden chunks and run both
// layers as wgmma (the hidden layer as the register A operand, never in
// shared memory) on weight stages that the producer warp streams into
// their rings with cp.async.bulk, laid out once per parameter set
// (layout_mlp in ops/gather_epilogue.py); f + b2 goes straight to out.

#include "exchange_core.cuh"

namespace {

template <bool kF32>
int launch_mlp(const void* x1, const void* x2, const void* stages,
               long long stage_bytes, const void* vecs, void* out, int M,
               int K1, int H, int O, void* scratch, long long scratch_bytes,
               int* info, void* stream) {
  using namespace exchange_core;
  CoreArgs a = {};
  a.x = x1;
  a.x2 = x2;
  a.stages = static_cast<const unsigned char*>(stages);
  a.vecs = static_cast<const float*>(vecs);
  a.jl = out;
  a.scratch = static_cast<unsigned char*>(scratch);
  const int err = fill_sizes(a, kMlp, 1, M, K1, H, O, 0, stage_bytes, 0, 0,
                             0, 0);
  if (err) return err;
  return launch_core<kMlp, kF32>(a, info, stream, scratch_bytes);
}

}  // namespace

// x1: (M, K1), x2: (M, 3), out: (M, O) bf16, contiguous; stages
// (stage_bytes) and vecs: the prepared weights (layout_mlp in
// ops/gather_epilogue.py: W1b (3, H rounded up to 64) | b1 | b2 (O rounded
// up to 96), f32). scratch: scratch_bytes of device memory, which the
// 'global' plan needs (launch_core; null and 0 do for the 'smem' plan).
// info (8 ints) receives the launch's shape and plan, as launch_core gives
// them. Returns a cudaError_t code. fused_mlp2_f32 takes the same with f32
// x1, x2 and out (exchange_core.cuh, "Element types"). Any K1, H and O:
// an odd O only in the library built with CORE_ODD_OUTPUT
// (exchange_core.cuh, "Output widths").
extern "C" int fused_mlp2_bf16(const void* x1, const void* x2,
                               const void* stages, long long stage_bytes,
                               const void* vecs, void* out, int M, int K1,
                               int H, int O, void* scratch,
                               long long scratch_bytes, int* info,
                               void* stream) {
  return launch_mlp<false>(x1, x2, stages, stage_bytes, vecs, out, M, K1, H,
                           O, scratch, scratch_bytes, info, stream);
}

extern "C" int fused_mlp2_f32(const void* x1, const void* x2,
                              const void* stages, long long stage_bytes,
                              const void* vecs, void* out, int M, int K1,
                              int H, int O, void* scratch,
                              long long scratch_bytes, int* info,
                              void* stream) {
  return launch_mlp<true>(x1, x2, stages, stage_bytes, vecs, out, M, K1, H,
                          O, scratch, scratch_bytes, info, stream);
}
