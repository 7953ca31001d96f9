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
// products with the bf16 table rows are summed in f32. The TPU kernels see
// only a window of rows per sample block and add the corners outside it in
// a residual take pass, in the table's type; here any thread reads any row,
// so no corner is ever outside a window and there is no residual pass. The
// results differ from the TPU's only by where that rounding happens.
//
// What bounds it on an H100: bytes. A sample costs ~8 C flops against its
// output row (C x 2 or 4 bytes), its 32 bytes of corners and weights and
// whatever table rows it is the first to touch; at the V=2 level-1 shape
// (1,048,576 samples, C = 256, bf16 out) the output alone is 512 MiB,
// ~0.16 ms at 3.35 TB/s.
//
// What the design does about it: the selector-matmul form of the TPU
// kernels exists only because Mosaic cannot address single rows. Here each
// thread owns one 16-byte chunk (8 channels) of one sample's output: it
// reads the sample's corners and weights (one 16-byte load each, shared
// through L1 by the C/8 threads of the sample), the corner rows' chunks
// with 16-byte loads (neighbouring threads read neighbouring chunks of one
// row), skips corners whose weight is 0, and writes its chunk once. A simple
// first kernel: no shared-memory window of the sorted stream's rows, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8 * 4;  // four waves of 8 blocks per SM

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store8(bf16* dst, const float (&a)[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(a[2 * j], a[2 * j + 1]);
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void store8(float* dst, const float (&a)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(a[4], a[5], a[6], a[7]);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    bilinear_gather_kernel(const bf16* __restrict__ table,
                           const int4* __restrict__ idx,
                           const float4* __restrict__ w, Out* __restrict__ out,
                           long long M, int C, int rows) {
  const int chunks = C / 8;
  const long long total = M * chunks;
  for (long long t = blockIdx.x * (long long)kThreads + threadIdx.x; t < total;
       t += (long long)gridDim.x * kThreads) {
    const long long m = t / chunks;
    const int c0 = (int)(t - m * chunks) * 8;
    const int4 iv = __ldg(idx + m);
    const float4 wv = __ldg(w + m);
    int r[4] = {iv.x, iv.y, iv.z, iv.w};
    const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) r[c] = min(max(r[c], 0), rows - 1);

    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // The selector entry of row r[c], built once, at its first corner.
      bool first = true;
#pragma unroll
      for (int e = 0; e < c; ++e) first = first && r[e] != r[c];
      if (!first) continue;
      float s = round_bf16(wc[c]);
#pragma unroll
      for (int e = c + 1; e < 4; ++e)
        if (r[e] == r[c]) s = round_bf16(s + round_bf16(wc[e]));
      if (s == 0.f) continue;
      const uint4 v =
          __ldg(reinterpret_cast<const uint4*>(table + (size_t)r[c] * C + c0));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        acc[2 * j] = fmaf(s, f.x, acc[2 * j]);
        acc[2 * j + 1] = fmaf(s, f.y, acc[2 * j + 1]);
      }
    }
    store8(out + m * C + c0, acc);
  }
}

int launch(const void* table, const void* idx, const void* w, void* out,
           int out_f32, long long M, int C, int rows, void* stream) {
  if (M <= 0 || C <= 0 || C % 8 || rows <= 0)
    return (int)cudaErrorInvalidValue;
  const long long total = M * (C / 8);
  const int blocks =
      (int)((total + kThreads - 1) / kThreads < kMaxBlocks
                ? (total + kThreads - 1) / kThreads
                : kMaxBlocks);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto t = static_cast<const bf16*>(table);
  const auto i = static_cast<const int4*>(idx);
  const auto wt = static_cast<const float4*>(w);
  if (out_f32)
    bilinear_gather_kernel<float><<<blocks, kThreads, 0, s>>>(
        t, i, wt, static_cast<float*>(out), M, C, rows);
  else
    bilinear_gather_kernel<bf16><<<blocks, kThreads, 0, s>>>(
        t, i, wt, static_cast<bf16*>(out), M, C, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// All four: table (rows, C) bf16, C % 8 == 0; idx (M, 4) int32 corner rows
// (clamped to [0, rows) here); w (M, 4) f32 corner weights; out (M, C), f32
// when out_f32 is set, else bf16. All contiguous and 16-byte aligned.
// Returns a cudaError_t code.
extern "C" int resident_gather_bf16(const void* table, const void* idx,
                                    const void* w, void* out, int out_f32,
                                    long long M, int C, int rows,
                                    void* stream) {
  return launch(table, idx, w, out, out_f32, M, C, rows, stream);
}

extern "C" int windowed_gather_bf16(const void* table, const void* idx,
                                    const void* w, void* out, int out_f32,
                                    long long M, int C, int rows,
                                    void* stream) {
  return launch(table, idx, w, out, out_f32, M, C, rows, stream);
}

extern "C" int onehot_gather_bf16(const void* table, const void* idx,
                                  const void* w, void* out, int out_f32,
                                  long long M, int C, int rows, void* stream) {
  return launch(table, idx, w, out, out_f32, M, C, rows, stream);
}

extern "C" int banded_gather_bf16(const void* table, const void* idx,
                                  const void* w, void* out, int out_f32,
                                  long long M, int C, int rows, void* stream) {
  return launch(table, idx, w, out, out_f32, M, C, rows, stream);
}
