// Fused V=2 exchange epilogue with the cell-row gather inside, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` launched by `_pallas_forward` in
// cross_attention_renderer_tpu/ops/gather_epilogue.py (the V=2
// `fused_exchange_epilogue`). Per sample and stream (self, then cross) it
// combines the cell rows and runs the fuse MLP, places bf16(f) in the
// [a | b] halves of the sample's row by its view id (m // rp) % 2 (view 0:
// [self, cross], view 1: [cross, self]) and writes
//
//   jl = [a | b] @ lv + lvb
//   kv = bf16(relu([a | b] @ km + kmb)) @ k2 + k2b.
//
// What bounds it on an H100: operations, about 2.5 MFLOP a sample in the
// matrix products (2.6 TFLOP a call at the flagship's 1,048,576 samples,
// ~2.7 ms at 989 TFLOP/s in bf16), against ~9.7 GB of cell rows read at
// random, mostly from L2. Measured on the earlier mma.sync kernel (NVIDIA
// H100 80GB HBM3, 700 W), the gather alone took 2.6 ms of its 23.2 and the
// products alone 20.6: the products, and the weights they stream, are what
// to fix.
//
// What the design does about it (exchange_core.cuh): wgmma in place of
// mma.sync, from two consumer warpgroups that split the hidden chunks of
// the same 64-sample tile; the weights arrive as pre-swizzled stages
// through cp.async.bulk into shared-memory rings, where the old kernel read
// every weight fragment from L2 with 4-byte loads; the hidden layer stays
// in registers; the grid is persistent. As before, each block fetches its
// own cell rows with 16-byte loads straight into the combine, so the
// (2M, 2304) stack of taken rows that the TPU path wrote and read back
// never exists. Measured on the same card: 10.45 ms a call, of which the
// products and their weight stream alone take 8.3 (epilogue_ablation.py).

#include "exchange_core.cuh"

namespace {

template <bool kF32, bool kI8>
int launch_pair(int n_levels, void* const* tables, void* const* cells,
                const int* channels, const void* aux_self,
                const void* aux_cross, const void* stages,
                long long stage_bytes, const void* vecs, void* jl, void* kv,
                int M, int F, int H1, int O, int K, int rp, void* scratch,
                long long scratch_bytes, int* info, void* stream) {
  using namespace exchange_core;
  CoreArgs a = {};
  int F_sum = 0;
  int err = fill_levels(a, n_levels, tables, cells, channels, &F_sum);
  if (err) return err;
  if (F_sum != F || rp <= 0) return (int)cudaErrorInvalidValue;
  a.aux[0] = aux_self;
  a.aux[1] = aux_cross;
  a.stages = static_cast<const unsigned char*>(stages);
  a.vecs = static_cast<const float*>(vecs);
  a.jl = jl;
  a.kv = kv;
  a.rp = rp;
  a.scratch = static_cast<unsigned char*>(scratch);
  err = fill_sizes(a, kPair, 2, M, F, H1, O, K, stage_bytes, 0, 0, 0, 0);
  if (err) return err;
  return launch_core<kPair, kF32, kI8>(a, info, stream, scratch_bytes);
}

}  // namespace

// tables[l]: (rows_l, 4 * channels[l]) bf16, 1 <= n_levels <= 4;
// cells[l]: (2M,) int32, the self stream's rows then the cross stream's;
// aux_self, aux_cross: (M, 16) bf16, (M, 24) with four levels
// (exchange_core.cuh, "Levels"); stages (stage_bytes) and vecs: the
// prepared weights (layout_stages in ops/gather_epilogue.py). jl: (M, O),
// kv: (M, K) bf16.
// All contiguous. scratch: scratch_bytes of device memory, which the
// 'resident' and 'global' plans need (launch_core; null and 0 do for the
// 'smem' plan).
// info (8 ints) receives the launch's shape and plan, as launch_core gives
// them. Returns a cudaError_t code. fused_exchange_epilogue_f32 takes the
// same with f32 tables, aux, jl and kv (exchange_core.cuh, "Element
// types"); fused_exchange_epilogue_i8_bf16 and _i8_f32 the same as _bf16
// and _f32 with int8 tables ("Table types"). Any O: an odd one only in the
// library built with CORE_ODD_OUTPUT (exchange_core.cuh, "Output widths").
extern "C" int fused_exchange_epilogue_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* stages, long long stage_bytes, const void* vecs, void* jl,
    void* kv, int M, int F, int H1, int O, int K, int rp, void* scratch,
    long long scratch_bytes, int* info, void* stream) {
  return launch_pair<false, false>(n_levels, tables, cells, channels, aux_self,
                                   aux_cross, stages, stage_bytes, vecs, jl, kv,
                                   M, F, H1, O, K, rp, scratch, scratch_bytes,
                                   info, stream);
}

extern "C" int fused_exchange_epilogue_f32(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* stages, long long stage_bytes, const void* vecs, void* jl,
    void* kv, int M, int F, int H1, int O, int K, int rp, void* scratch,
    long long scratch_bytes, int* info, void* stream) {
  return launch_pair<true, false>(n_levels, tables, cells, channels, aux_self,
                                  aux_cross, stages, stage_bytes, vecs, jl, kv,
                                  M, F, H1, O, K, rp, scratch, scratch_bytes,
                                  info, stream);
}

extern "C" int fused_exchange_epilogue_i8_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* stages, long long stage_bytes, const void* vecs, void* jl,
    void* kv, int M, int F, int H1, int O, int K, int rp, void* scratch,
    long long scratch_bytes, int* info, void* stream) {
  return launch_pair<false, true>(n_levels, tables, cells, channels, aux_self,
                                  aux_cross, stages, stage_bytes, vecs, jl, kv,
                                  M, F, H1, O, K, rp, scratch, scratch_bytes,
                                  info, stream);
}

extern "C" int fused_exchange_epilogue_i8_f32(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* stages, long long stage_bytes, const void* vecs, void* jl,
    void* kv, int M, int F, int H1, int O, int K, int rp, void* scratch,
    long long scratch_bytes, int* info, void* stream) {
  return launch_pair<true, true>(n_levels, tables, cells, channels, aux_self,
                                 aux_cross, stages, stage_bytes, vecs, jl, kv,
                                 M, F, H1, O, K, rp, scratch, scratch_bytes,
                                 info, stream);
}
