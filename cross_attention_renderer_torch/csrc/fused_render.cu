// The fully fused V=2 render core for Hopper (sm_90a): from the cell rows of
// both exchange streams to the attention output, in one kernel.
//
// Replaces the TPU kernel `_make_kernel` launched by `_pallas_forward` in
// cross_attention_renderer_tpu/ops/fused_render.py (`fused_render_core`).
// A ray (b, r) has 2P samples, P of view 0 then P of view 1, sample j at
// m = ((b * 2 + j / P) * R + r) * P + j % P. Per 64-sample tile of one view
// it runs the V=2 exchange epilogue, K2's function (cell-row gather,
// bilinear combine, both fuse-MLP streams, the per-view [self, cross] /
// [cross, self] order, jl = [a | b] @ lv + lvb and
// kv = bf16(relu([a | b] @ km + kmb)) @ k2 + k2b), the query embedding
//
//   ce = bf16(relu(lc @ qe1 + qe1b)) @ qe2 + qe2b
//
// and the round-1 logits ce . kv / 16; then per ray the joint softmax over
// the 2P samples (f32), at_wt = bf16(w) and z1 = sum_j bf16(w_j) jl_j (f32
// sum). With repeat attention, per ray ze = bf16(bf16(z1) @ el + elb) and
// u = ze @ qr1[:K] + qr1b (the z_embed half of the repeat-query MLP, the
// same for every sample of the ray, so computed once), then per tile
//
//   q2 = bf16(relu(lc @ qr1[K:] + u)) @ qr2 + qr2b,
//
// the round-2 logits q2 . ce / 16, the softmax, z2 = sum_j bf16(w2_j) jl_j
// and z = bf16(z2 + 2 z1). Every product accumulates in f32 and rounds to
// bf16 at the next product's input; q . k takes f32 products of the bf16
// values, as the JAX reference does (the TPU kernel multiplies in bf16).
//
// What bounds it on an H100: the tensor-core products, ~1.29 M
// multiply-adds a sample (K2's 1.25 M plus the query and repeat MLPs), ~2.7
// TFLOP a call at the flagship's 1,048,576 samples, ~2.7 ms at 989 TFLOP/s,
// against ~9.7 GB of cell rows read at random (~2.9 ms at 3.35 TB/s).
//
// What the design does about it: it is the exchange core's kRender
// instantiation (exchange_core.cuh), so it runs K2's 64-sample wgmma tiles,
// weight rings and persistent grid; a block walks over whole rays, since
// the softmax spans both views of a ray. A tile holds samples of one view
// (P = 64: one view of one ray; P = 48 or 16 leave rows empty), so each
// tile runs its own view's stream first and the other stream's f rows go
// into the comb tile, which needs 40 KB less shared memory than K2 and
// leaves room for eight stage slots. The keys never leave registers: the
// warpgroup that computes kv meets the tile's ce there. The ray's jl and
// ce (2P x (O + K) bf16, 104 KB at the flagship) do not fit beside the
// core's buffers, so they go to a per-block scratch in device memory, sized
// by the grid (132 blocks, ~14 MB, which the 50 MB L2 holds), and are read
// back for the weighted sums and round 2. The query MLPs run as wgmma on
// stages of their own (the 16-deep first layers as one k-step from the
// local coordinates in registers); the per-ray weighted sums and ze, u
// products are warp-parallel reductions. No other per-sample intermediate
// goes to device memory: only the (B, R, O) output and the (B, 2, R, P)
// weights are written.

#include "exchange_core.cuh"

namespace {

template <bool kF32, bool kI8>
int launch_render(int n_levels, void* const* tables, void* const* cells,
                  const int* channels, const void* aux_self,
                  const void* aux_cross, const void* lc, const void* stages,
                  long long stage_bytes, const void* vecs, const void* mats,
                  void* scratch, long long scratch_bytes, void* z, void* wt,
                  int B, int R, int P, int F, int H1, int O, int K,
                  int repeat, int* info, void* stream) {
  using namespace exchange_core;
  CoreArgs a = {};
  int F_sum = 0;
  int err = fill_levels(a, n_levels, tables, cells, channels, &F_sum);
  if (err) return err;
  if (F_sum != F) return (int)cudaErrorInvalidValue;
  a.aux[0] = aux_self;
  a.aux[1] = aux_cross;
  a.lc = lc;
  a.stages = static_cast<const unsigned char*>(stages);
  a.vecs = static_cast<const float*>(vecs);
  a.mats = static_cast<const bf16*>(mats);
  a.scratch = static_cast<unsigned char*>(scratch);
  a.z = z;
  a.wt = wt;
  a.rp = R * P;
  const long long M = (long long)B * 2 * R * P;
  if (M > 0x7fffffff) return (int)cudaErrorInvalidValue;
  err = fill_sizes(a, kRender, 2, (int)M, F, H1, O, K, stage_bytes, B, R, P,
                   repeat);
  if (err) return err;
  return launch_core<kRender, kF32, kI8>(a, info, stream, scratch_bytes);
}

}  // namespace

// tables[l]: (rows_l, 4 * channels[l]) bf16, 1 <= n_levels <= 4;
// cells[l]: (2M,) int32, the self stream's rows then the cross stream's,
// M = B * 2 * R * P; aux_self, aux_cross: (M, 16) bf16, (M, 24) with four
// levels (exchange_core.cuh, "Levels"); lc: (M, 16) bf16; stages
// (stage_bytes), vecs and mats: the prepared weights (layout_render in
// ops/gather_epilogue.py);
// scratch: scratch_bytes of device memory, at least grid * 2P * (O + K) *
// 2 (grid: min(B * R, SMs)), and with the 'resident' plan grid * nkbf *
// 8 KB more, with the 'global' one grid * (nkbF + nkbf) * 8 KB
// (launch_core). z: (B, R, O), wt: (B, 2, R, P) bf16.
// All contiguous. info (8 ints) receives the launch's shape and plan, as
// launch_core gives them. Returns a cudaError_t code. fused_render_core_f32
// takes the same with f32 tables, aux, lc, z and wt (exchange_core.cuh,
// "Element types"; mats stays bf16); fused_render_core_i8_bf16 and _i8_f32
// the same as _bf16 and _f32 with int8 tables ("Table types").
extern "C" int fused_render_core_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* lc, const void* stages, long long stage_bytes,
    const void* vecs, const void* mats, void* scratch,
    long long scratch_bytes, void* z, void* wt, int B, int R, int P, int F,
    int H1, int O, int K, int repeat, int* info, void* stream) {
  return launch_render<false, false>(n_levels, tables, cells, channels,
                                     aux_self, aux_cross, lc, stages,
                                     stage_bytes, vecs, mats, scratch,
                                     scratch_bytes, z, wt, B, R, P, F, H1, O, K,
                                     repeat, info, stream);
}

extern "C" int fused_render_core_f32(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* lc, const void* stages, long long stage_bytes,
    const void* vecs, const void* mats, void* scratch,
    long long scratch_bytes, void* z, void* wt, int B, int R, int P, int F,
    int H1, int O, int K, int repeat, int* info, void* stream) {
  return launch_render<true, false>(n_levels, tables, cells, channels, aux_self,
                                    aux_cross, lc, stages, stage_bytes, vecs,
                                    mats, scratch, scratch_bytes, z, wt, B, R,
                                    P, F, H1, O, K, repeat, info, stream);
}

extern "C" int fused_render_core_i8_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* lc, const void* stages, long long stage_bytes,
    const void* vecs, const void* mats, void* scratch,
    long long scratch_bytes, void* z, void* wt, int B, int R, int P, int F,
    int H1, int O, int K, int repeat, int* info, void* stream) {
  return launch_render<false, true>(n_levels, tables, cells, channels, aux_self,
                                    aux_cross, lc, stages, stage_bytes, vecs,
                                    mats, scratch, scratch_bytes, z, wt, B, R,
                                    P, F, H1, O, K, repeat, info, stream);
}

extern "C" int fused_render_core_i8_f32(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* lc, const void* stages, long long stage_bytes,
    const void* vecs, const void* mats, void* scratch,
    long long scratch_bytes, void* z, void* wt, int B, int R, int P, int F,
    int H1, int O, int K, int repeat, int* info, void* stream) {
  return launch_render<true, true>(n_levels, tables, cells, channels, aux_self,
                                   aux_cross, lc, stages, stage_bytes, vecs,
                                   mats, scratch, scratch_bytes, z, wt, B, R, P,
                                   F, H1, O, K, repeat, info, stream);
}
