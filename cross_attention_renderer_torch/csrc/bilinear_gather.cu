// Bilinear gather from a flat feature table, for Hopper (sm_90a): the one
// routine behind four TPU kernels.
//
// For every sample m, with the four corner rows idx[m, c] and weights
// w[m, c] built outside the kernel,
//
//   out[m, :] = sum_{c < 4} s[m, c] * T[idx[m, c], :]
//
// Replaces, one entry point each (same arithmetic, different output type):
//   resident_gather_bf16  `_resident_kernel` / `resident_gather`
//                         (cross_attention_renderer_tpu/ops/sorted_gather.py)
//                         K5, output in the type the caller asks for;
//   windowed_gather_bf16  `_windowed_kernel` / `windowed_gather` (same file)
//                         K6, f32 output;
//   onehot_gather_bf16    `_gather_kernel` / `_onehot_gather`
//                         (ops/pallas_gather.py) K7, the table's type;
//   banded_gather_bf16    `_banded_kernel` / `_banded_gather`
//                         (ops/experimental/banded_gather.py) K8, f32 sums
//                         cast to the table's type.
//
// Numerics of the TPU kernels' selector: each corner's weight is rounded to
// bf16, corners that land on one row are summed in bf16 in corner order
// (that happens at the border, where clamped corners coincide), and the
// products with the bf16 table rows are summed in f32, in corner order,
// and rounded once to the output type. Corners whose selector entry is 0
// are skipped. The TPU kernels see only a window of rows per sample block
// and add the corners outside it in a residual take pass, in the table's
// type; here any thread reads any row, so no corner is ever outside a
// window and there is no residual pass. The results differ from the TPU's
// only by where that rounding happens.
//
// What bounds it on an H100: bytes. A sample costs ~8 C flops against its
// output row (C x 2 or 4 bytes), its 32 bytes of corners and weights and
// whatever table rows it is the first to touch; at K8's case (1,048,576
// samples of the V=2 level-0 table, 8,192 rows of C = 256, bf16 out) the
// 537 MB output alone is 0.160 ms at 3.35 TB/s, and the table (4 MiB)
// lives in L2 while the sorted stream's neighbours share its rows in L1.
//
// What the design does about it. The output stream has to run at the
// memory's rate, so the kernel keeps rows in flight and spends few
// instructions on anything else:
//
//   * a group of C/8 lanes (rounded up to a power of two, at most 32: a
//     warp at C = 256, a quarter warp at C = 64) takes one sample, one
//     16-byte chunk of each corner row a lane, so the rows are read and
//     the output written 16 bytes a lane, neighbouring lanes on
//     neighbouring addresses;
//   * a warp takes its samples 32 at a time (a batch). Lane l copies the
//     corners and weights of sample l into shared memory (cp.async, two
//     coalesced 512-byte copies a batch, the next batch's issued while
//     this batch's rows are in flight, so no register holds them), clamps
//     the rows, builds the sample's selector once (the bf16 rounding and
//     the merging of coincident corners) and leaves it in shared memory,
//     where every lane of the sample's group reads it by broadcast;
//   * each lane keeps kDepth samples' rows in flight (4 x 16-byte loads a
//     sample), all issued before the first product, and reads the
//     weights again for the products rather than hold them;
//   * the launch (grid, samples a lane has in flight) comes from the SM
//     count, the kernel's resident blocks an SM (its registers: two
//     waves of them, the warps walking the batches grid-stride) and the
//     shapes (ops/sorted_gather.py gather_plan, card_plan); 4 samples in
//     flight a lane and two waves were the fastest, or within 1.5%, of
//     depth 1-4 at one or two waves on the main paths' inputs
//     (tools/gather_study.py, on an H100 80GB HBM3 at 700 W); the index
//     math is 32-bit but for the address products;
//   * cache policy: the output is stored streaming (st.global.cs), up to
//     26% faster than plain stores on f32 outputs and the largest K7 cases
//     and at most 2% slower on the others (tools/gather_study.py), so the
//     output stream does not push the table out of L2; the table rows load
//     through L1 at L2's normal priority. Loads with an L2 evict_last
//     policy ran 0-4% faster alone, but their marks outlast the launch and
//     the V=2 sorted image's device time was no lower with them (~0.5 ms
//     of 280 higher in every image of two calls, tools/image_time.py, on
//     an H100 80GB HBM3 at 700 W), with K5's own total equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;              // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 32;             // samples a warp takes at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One 16-byte chunk of a table row, through L1, at L2's normal priority.
__device__ __forceinline__ uint4 load_row(const uint4* p) { return __ldg(p); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros where `valid` is false.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_issued() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void store_out(uint4* p, uint4 v) { __stcs(p, v); }
__device__ __forceinline__ void store_out(float4* p, float4 v) {
  __stcs(p, v);
}

// Channels [0, n) of an 8-channel chunk of a table row whose width is not
// a multiple of 8 (so that the row is not 16-byte aligned), one element at
// a time; zeros past n.
__device__ __forceinline__ uint4 load_tail(const bf16* p, int n) {
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = e < n ? p[e] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(v);
}

// Eight channels of one sample, rounded once to the output type.
__device__ __forceinline__ void store8(bf16* dst, const float (&a)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(a[2 * j], a[2 * j + 1]);
  store_out(reinterpret_cast<uint4*>(dst), v);
}

__device__ __forceinline__ void store8(float* dst, const float (&a)[8]) {
  store_out(reinterpret_cast<float4*>(dst),
            make_float4(a[0], a[1], a[2], a[3]));
  store_out(reinterpret_cast<float4*>(dst) + 1,
            make_float4(a[4], a[5], a[6], a[7]));
}

// The first n (< 8) channels of one sample, one element at a time.
__device__ __forceinline__ void store_tail(bf16* dst, const float (&a)[8],
                                           int n) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) __stcs(dst + e, __float2bfloat16(a[e]));
}

__device__ __forceinline__ void store_tail(float* dst, const float (&a)[8],
                                           int n) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (e < n) __stcs(dst + e, a[e]);
}

// Lane `lane`'s sample of batch b: its corner rows and weights copied into
// its slots (zeros past M or past the last batch, which give it an
// all-zero selector).
__device__ __forceinline__ void copy_corners(const int4* idx, const float4* w,
                                             int b, int batches, int M,
                                             int lane, int4* raw_idx,
                                             float4* raw_w) {
  const int m = b * kBatch + lane;
  const bool valid = b < batches && m < M;
  copy16(raw_idx, idx + (valid ? m : 0), valid);
  copy16(raw_w, w + (valid ? m : 0), valid);
  copies_issued();
}

// A sample's selector: its corner rows clamped to [0, rows) and, at each
// row's first corner, the bf16 sum in corner order of the bf16-rounded
// weights of the corners on that row; 0 at the row's later corners.
__device__ __forceinline__ void selector(int4 iv, float4 wv, int rows,
                                         int4& r_out, float4& s_out) {
  int r[4] = {iv.x, iv.y, iv.z, iv.w};
  const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) r[c] = min(max(r[c], 0), rows - 1);
  float s[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    bool first = true;
#pragma unroll
    for (int e = 0; e < c; ++e) first = first && r[e] != r[c];
    s[c] = round_bf16(wc[c]);
#pragma unroll
    for (int e = c + 1; e < 4; ++e)
      if (r[e] == r[c]) s[c] = round_bf16(s[c] + round_bf16(wc[e]));
    if (!first) s[c] = 0.f;
  }
  r_out = make_int4(r[0], r[1], r[2], r[3]);
  s_out = make_float4(s[0], s[1], s[2], s[3]);
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Warp w of block b takes the batches b * kWarps + w + k * gridDim.x *
// kWarps. In a batch, lane l of group g (l >> shift) takes chunks
// l & (2^shift - 1) + 2^shift * k of samples j0 + d * (32 >> shift) + g,
// for d < kDepth, at each step j0 of (32 >> shift) * kDepth samples;
// kDepth <= 2^shift, so the steps tile the batch. A chunk is 8 channels of
// the C; kWhole: C % 8 == 0, 16-byte loads and stores; else the rows are
// not 16-byte aligned and each chunk is read and written an element at a
// time, the last chunk's C % 8.
template <int kDepth, typename Out, bool kWhole>
__global__ void __launch_bounds__(kThreads)
    bilinear_gather_kernel(const uint4* __restrict__ table,
                           const int4* __restrict__ idx,
                           const float4* __restrict__ w, Out* __restrict__ out,
                           int M, int C, int rows, int shift) {
  __shared__ int4 raw_idx[kWarps][kBatch];
  __shared__ float4 raw_w[kWarps][kBatch];
  __shared__ int4 sel_rows[kWarps][kBatch];
  __shared__ float4 sel_wts[kWarps][kBatch];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = 1 << shift, per_row = kBatch >> shift;
  const int g = lane >> shift, sub = lane & (group - 1);
  const int chunks = (C + 7) / 8;
  const bf16* table_h = reinterpret_cast<const bf16*>(table);
  const int batches = (M + kBatch - 1) / kBatch;
  const int stride = gridDim.x * kWarps;
  int b = blockIdx.x * kWarps + warp;
  copy_corners(idx, w, b, batches, M, lane, &raw_idx[warp][lane],
               &raw_w[warp][lane]);
  for (; b < batches; b += stride) {
    copies_landed();  // a lane reads only the slots it copied itself
    int4 r;
    float4 s;
    selector(raw_idx[warp][lane], raw_w[warp][lane], rows, r, s);
    __syncwarp(kFull);  // every lane has read the last batch's selectors
    sel_rows[warp][lane] = r;
    sel_wts[warp][lane] = s;
    __syncwarp(kFull);
    // the next batch's corners, copied while this batch's rows are in
    // flight (the selector above has consumed the slots' last contents)
    copy_corners(idx, w, b + stride, batches, M, lane, &raw_idx[warp][lane],
                 &raw_w[warp][lane]);
    const int m0 = b * kBatch;
    for (int j0 = 0; j0 < kBatch; j0 += per_row * kDepth) {
      for (int c = sub; c < chunks; c += group) {
        uint4 v[kDepth][4];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          const int j = j0 + d * per_row + g;
          const int4 rr = sel_rows[warp][j];
          const float4 ss = sel_wts[warp][j];
          const int rv[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (lane_of(ss, q) != 0.f)
              v[d][q] = kWhole ? load_row(table + (size_t)rv[q] * chunks + c)
                               : load_tail(table_h + (size_t)rv[q] * C + c * 8,
                                           C - c * 8);
        }
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          // the weights again, by broadcast, rather than held over the loads
          const float4 ss = sel_wts[warp][j0 + d * per_row + g];
          float acc[8];
#pragma unroll
          for (int k = 0; k < 8; ++k) acc[k] = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float sq = lane_of(ss, q);
            if (sq == 0.f) continue;
            const __nv_bfloat162* h =
                reinterpret_cast<const __nv_bfloat162*>(&v[d][q]);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float2 f = __bfloat1622float2(h[k]);
              acc[2 * k] = fmaf(sq, f.x, acc[2 * k]);
              acc[2 * k + 1] = fmaf(sq, f.y, acc[2 * k + 1]);
            }
          }
          const int m = m0 + j0 + d * per_row + g;
          if (m < M && kWhole) store8(out + (size_t)m * C + c * 8, acc);
          if (m < M && !kWhole)
            store_tail(out + (size_t)m * C + c * 8, acc, min(8, C - c * 8));
        }
      }
    }
  }
}

// The kernel<kDepth, Out, true> instantiation of `depth`, or nullptr (the
// C % 8 != 0 ones run at the occupancy the launch plan assumes of these:
// the grid only sets how many batches a warp walks).
template <typename Out>
const void* kernel_of(int depth) {
  switch (depth) {
    case 1:
      return reinterpret_cast<const void*>(
          bilinear_gather_kernel<1, Out, true>);
    case 2:
      return reinterpret_cast<const void*>(
          bilinear_gather_kernel<2, Out, true>);
    case 4:
      return reinterpret_cast<const void*>(
          bilinear_gather_kernel<4, Out, true>);
  }
  return nullptr;
}

template <typename Out, bool kWhole>
int launch_depth(int depth, const void* table, const void* idx, const void* w,
                 void* out, int M, int C, int rows, int shift, int grid,
                 cudaStream_t s) {
  const auto t = static_cast<const uint4*>(table);
  const auto i = static_cast<const int4*>(idx);
  const auto wt = static_cast<const float4*>(w);
  const auto o = static_cast<Out*>(out);
  switch (depth) {
    case 1:
      bilinear_gather_kernel<1, Out, kWhole><<<grid, kThreads, 0, s>>>(
          t, i, wt, o, M, C, rows, shift);
      break;
    case 2:
      bilinear_gather_kernel<2, Out, kWhole><<<grid, kThreads, 0, s>>>(
          t, i, wt, o, M, C, rows, shift);
      break;
    case 4:
      bilinear_gather_kernel<4, Out, kWhole><<<grid, kThreads, 0, s>>>(
          t, i, wt, o, M, C, rows, shift);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename Out>
int launch_type(int depth, const void* table, const void* idx, const void* w,
                void* out, int M, int C, int rows, int shift, int grid,
                cudaStream_t s) {
  return C % 8 == 0 ? launch_depth<Out, true>(depth, table, idx, w, out, M, C,
                                              rows, shift, grid, s)
                    : launch_depth<Out, false>(depth, table, idx, w, out, M, C,
                                               rows, shift, grid, s);
}

int launch(const void* table, const void* idx, const void* w, void* out,
           int out_f32, int M, int C, int rows, int shift, int depth,
           int grid, void* stream) {
  // depth samples of 32 >> shift lanes' groups must tile a batch
  if (M <= 0 || C <= 0 || rows <= 0 || shift < 0 || shift > 5 ||
      depth > (1 << shift) || grid <= 0 || M > 0x7fffffff - kBatch)
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (out_f32)
    return launch_type<float>(depth, table, idx, w, out, M, C, rows, shift,
                              grid, s);
  return launch_type<bf16>(depth, table, idx, w, out, M, C, rows, shift, grid,
                           s);
}

}  // namespace

// The blocks of the instantiation of `depth` (1, 2, 4) and output type
// that an SM holds at once (its registers and shared memory) into
// *blocks; returns a cudaError_t code.
extern "C" int bilinear_gather_blocks_per_sm(int depth, int out_f32,
                                             int* blocks) {
  const void* k = out_f32 ? kernel_of<float>(depth) : kernel_of<bf16>(depth);
  if (!k) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k,
                                                            kThreads, 0);
}

// All four: table (rows, C) bf16, any C (16-byte loads where C % 8 == 0,
// else an element at a time); idx (M, 4) int32 corner rows (clamped to
// [0, rows) here); w (M, 4) f32 corner weights; out (M, C), f32 when
// out_f32 is set, else bf16. All contiguous and 16-byte aligned. The
// launch (ops/sorted_gather.py gather_plan): 2^shift lanes a sample (C / 8,
// rounded up, then up to a power of two, at most 32), depth (1, 2 or 4, at
// most 2^shift) samples a lane has in flight, grid blocks of 8 warps (any
// number: the warps walk the batches grid-stride). Returns a cudaError_t
// code.
extern "C" int resident_gather_bf16(const void* table, const void* idx,
                                    const void* w, void* out, int out_f32,
                                    int M, int C, int rows, int shift,
                                    int depth, int grid, void* stream) {
  return launch(table, idx, w, out, out_f32, M, C, rows, shift, depth, grid,
                stream);
}

extern "C" int windowed_gather_bf16(const void* table, const void* idx,
                                    const void* w, void* out, int out_f32,
                                    int M, int C, int rows, int shift,
                                    int depth, int grid, void* stream) {
  return launch(table, idx, w, out, out_f32, M, C, rows, shift, depth, grid,
                stream);
}

extern "C" int onehot_gather_bf16(const void* table, const void* idx,
                                  const void* w, void* out, int out_f32,
                                  int M, int C, int rows, int shift,
                                  int depth, int grid, void* stream) {
  return launch(table, idx, w, out, out_f32, M, C, rows, shift, depth, grid,
                stream);
}

extern "C" int banded_gather_bf16(const void* table, const void* idx,
                                  const void* w, void* out, int out_f32,
                                  int M, int C, int rows, int shift,
                                  int depth, int grid, void* stream) {
  return launch(table, idx, w, out, out_f32, M, C, rows, shift, depth, grid,
                stream);
}
