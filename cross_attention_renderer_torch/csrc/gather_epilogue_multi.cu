// Fused S-stream exchange epilogue (V>=3) with the cell-row gather inside,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_make_kernel_multi` launched by
// `_pallas_forward_multi` in cross_attention_renderer_tpu/ops/
// gather_epilogue.py (`fused_exchange_epilogue_multi`, the default V=3
// path). Per stream s of [self, cross_0, ..., cross_{S-2}] (S = V >= 3
// context views, any count) it combines the sample's
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
// block: ~4.5 ms at 989 TFLOP/s in bf16. The kernel also reads a 4.6 KB
// cell row per sample and stream (~16 GB a call), mostly from L2. Measured
// on the earlier mma.sync kernel (NVIDIA H100 80GB HBM3, 700 W), the gather
// alone took 4.4 ms of its 41.7 and the products alone 37.6.
//
// What the design does about it: the same wgmma core as the V=2 kernel
// (exchange_core.cuh, without the view swap), with its weight stages in
// shared-memory rings and the hidden layer in registers. The 64-sample
// tile keeps comb and the f rows of the first S - 1 streams in shared
// memory; the last stream's f rows go into the comb tile, which that stream
// no longer reads, so three streams need the shared memory of two (the old
// kernel cut its tile to 48 samples to fit them). jl and kh stay single
// products of depth S * O whose f32 sums span all streams. Measured on the
// same card: 16.46 ms a call.

#include "exchange_core.cuh"

namespace {

template <bool kF32, bool kI8>
int launch_streams(int n_levels, void* const* tables, void* const* cells,
                   const int* channels, int S, const void* aux,
                   const void* stages, long long stage_bytes,
                   const void* vecs, void* jl, void* kv, int M, int F,
                   int H1, int O, int K, void* scratch,
                   long long scratch_bytes, int* info, void* stream) {
  using namespace exchange_core;
  CoreArgs a = {};
  int F_sum = 0;
  int err = fill_levels(a, n_levels, tables, cells, channels, &F_sum);
  if (err) return err;
  if (F_sum != F || S < 2) return (int)cudaErrorInvalidValue;
  a.aux[0] = aux;
  a.stages = static_cast<const unsigned char*>(stages);
  a.vecs = static_cast<const float*>(vecs);
  a.jl = jl;
  a.kv = kv;
  a.rp = 1;
  a.scratch = static_cast<unsigned char*>(scratch);
  err = fill_sizes(a, kStreams, S, M, F, H1, O, K, stage_bytes, 0, 0, 0, 0);
  if (err) return err;
  return launch_core<kStreams, kF32, kI8>(a, info, stream, scratch_bytes);
}

}  // namespace

// tables[l]: (rows_l, 4 * channels[l]) bf16, 1 <= n_levels <= 4;
// cells[l]: (S*M,) int32, stream-major; aux: (S*M, 16) bf16, stream-major
// like the cells, (S*M, 24) with four levels (exchange_core.cuh, "Levels"),
// any S >= 2; stages
// (stage_bytes) and vecs: the prepared weights (layout_stages in
// ops/gather_epilogue.py). jl: (M, O), kv: (M, K) bf16. All contiguous.
// scratch: scratch_bytes of device memory, which the 'resident' and
// 'global' plans need (launch_core; null and 0 do for the 'smem' plan).
// info (8 ints) receives the launch's shape and plan, as launch_core gives
// them. Returns a cudaError_t code. fused_exchange_epilogue_multi_f32
// takes the same with f32 tables, aux, jl and kv (exchange_core.cuh,
// "Element types");
// fused_exchange_epilogue_multi_i8_bf16 and _i8_f32 the same as _bf16 and
// _f32 with int8 tables ("Table types"). Any O: an odd one only in the
// library built with CORE_ODD_OUTPUT (exchange_core.cuh, "Output widths").
extern "C" int fused_exchange_epilogue_multi_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, int S, const void* aux, const void* stages,
    long long stage_bytes, const void* vecs, void* jl, void* kv, int M,
    int F, int H1, int O, int K, void* scratch, long long scratch_bytes,
    int* info, void* stream) {
  return launch_streams<false, false>(n_levels, tables, cells, channels, S, aux,
                                      stages, stage_bytes, vecs, jl, kv, M, F,
                                      H1, O, K, scratch, scratch_bytes, info,
                                      stream);
}

extern "C" int fused_exchange_epilogue_multi_f32(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, int S, const void* aux, const void* stages,
    long long stage_bytes, const void* vecs, void* jl, void* kv, int M,
    int F, int H1, int O, int K, void* scratch, long long scratch_bytes,
    int* info, void* stream) {
  return launch_streams<true, false>(n_levels, tables, cells, channels, S, aux,
                                     stages, stage_bytes, vecs, jl, kv, M, F,
                                     H1, O, K, scratch, scratch_bytes, info,
                                     stream);
}

extern "C" int fused_exchange_epilogue_multi_i8_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, int S, const void* aux, const void* stages,
    long long stage_bytes, const void* vecs, void* jl, void* kv, int M,
    int F, int H1, int O, int K, void* scratch, long long scratch_bytes,
    int* info, void* stream) {
  return launch_streams<false, true>(n_levels, tables, cells, channels, S, aux,
                                     stages, stage_bytes, vecs, jl, kv, M, F,
                                     H1, O, K, scratch, scratch_bytes, info,
                                     stream);
}

extern "C" int fused_exchange_epilogue_multi_i8_f32(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, int S, const void* aux, const void* stages,
    long long stage_bytes, const void* vecs, void* jl, void* kv, int M,
    int F, int H1, int O, int K, void* scratch, long long scratch_bytes,
    int* info, void* stream) {
  return launch_streams<true, true>(n_levels, tables, cells, channels, S, aux,
                                    stages, stage_bytes, vecs, jl, kv, M, F, H1,
                                    O, K, scratch, scratch_bytes, info, stream);
}
