// Joint (view, sample) softmax attention of one ray against its epipolar
// samples, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_attention_kernel` launched by `_forward_pallas`
// in cross_attention_renderer_tpu/ops/epipolar_attention.py. For every ray
// (b, r) and every row j = (v, p) of the V*P joint axis:
//
//   logit_j = sum_d q[b,v,r,p,d] * k[b,v,r,p,d] / 16        (f32)
//   at_wt_j = softmax_j(logit)                              (f32, joint)
//   out[b,r,c] = sum_j bf16(at_wt_j) * v[b,v,r,p,c]         (f32 sum)
//
// What bounds it on an H100: bytes. Each call reads q and k (V*P*D values
// per ray) and v (V*P*C per ray) once and writes C + V*P values per ray; at
// the flagship shapes (R = 8192, V*P = 128, D = 128, C = 288, bf16) that is
// about 1.14 GB, about 0.34 ms at 3.35 TB/s, against about 0.15 GFLOP.
//
// What the design does about it: one thread block per ray; every input
// byte is read exactly once, with 8-byte loads in which neighbouring lanes
// read neighbouring addresses (a warp reads one 256-byte q or k row, and
// C/4 threads read one v row). Logits, softmax weights and the per-slice
// partial sums stay in shared memory, so only the (B, R, C) output and the
// (B, V, R, P) weights are written. Unlike the TPU launcher, R is not padded
// to a ray block. Plain loads, no tensor cores: the dot products are 2
// FLOP per byte read, far below the card's balance point.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 load_bf16x4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide reduction; every thread gets the result. blockDim.x is a
// multiple of 32 (the launcher rounds it up).
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float y = lane < nwarps ? red[lane] : (kMax ? -INFINITY : 0.f);
    y = kMax ? warp_max(y) : warp_sum(y);
    if (lane == 0) red[0] = y;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

__global__ void epipolar_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    __nv_bfloat16* __restrict__ wt, int V, int R, int P, int D, int C,
    int slices, float scale) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int VP = V * P;
  float* weight = smem;       // (VP): logits, then bf16-rounded weights
  float* part = smem + VP;    // (slices, C) partial value sums

  const int ray = blockIdx.x;  // b * R + r
  const int b = ray / R, r = ray - b * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  // Logits: one warp per joint row, lanes stride over D.
  for (int j = warp; j < VP; j += nwarps) {
    const int vi = j / P, p = j - vi * P;
    const size_t off = ((size_t)((b * V + vi) * R + r) * P + p) * D;
    float s = 0.f;
    for (int d = 4 * lane; d < D; d += 128) {
      const float4 a = load_bf16x4(q + off + d);
      const float4 c = load_bf16x4(k + off + d);
      s += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
    }
    s = warp_sum(s);
    if (lane == 0) weight[j] = s * scale;
  }
  __syncthreads();

  // Joint softmax over the V*P rows, in f32.
  float m = -INFINITY;
  for (int j = threadIdx.x; j < VP; j += blockDim.x) m = fmaxf(m, weight[j]);
  m = block_reduce<true>(m, red);
  float denom = 0.f;
  for (int j = threadIdx.x; j < VP; j += blockDim.x) {
    const float e = expf(weight[j] - m);
    weight[j] = e;
    denom += e;
  }
  denom = block_reduce<false>(denom, red);
  for (int j = threadIdx.x; j < VP; j += blockDim.x) {
    const int vi = j / P, p = j - vi * P;
    const __nv_bfloat16 w = __float2bfloat16(weight[j] / denom);
    wt[((size_t)(b * V + vi) * R + r) * P + p] = w;
    weight[j] = __bfloat162float(w);
  }
  __syncthreads();

  // Weighted value sum: thread (s, g) sums channels [4g, 4g+4) over rows
  // s, s + slices, ...; the slices are then added in shared memory.
  const int groups = C / 4;
  if (threadIdx.x < groups * slices) {
    const int g = threadIdx.x % groups, s = threadIdx.x / groups;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = s; j < VP; j += slices) {
      const int vi = j / P, p = j - vi * P;
      const size_t off = ((size_t)((b * V + vi) * R + r) * P + p) * C + 4 * g;
      const float4 x = load_bf16x4(v + off);
      const float w = weight[j];
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    float* dst = part + s * C + 4 * g;
    dst[0] = acc.x;
    dst[1] = acc.y;
    dst[2] = acc.z;
    dst[3] = acc.w;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t = 0.f;
    for (int s = 0; s < slices; ++s) t += part[s * C + c];
    out[(size_t)ray * C + c] = __float2bfloat16(t);
  }
}

}  // namespace

// q, k: (B, V, R, P, D); v: (B, V, R, P, C); out: (B, R, C);
// wt: (B, V, R, P). All bf16, contiguous. Returns a cudaError_t code.
extern "C" int epipolar_attention_bf16(const void* q, const void* k,
                                       const void* v, void* out, void* wt,
                                       int B, int V, int R, int P, int D,
                                       int C, float scale, void* stream) {
  if (D % 4 != 0 || C % 4 != 0 || C / 4 > 1024 || B * R <= 0)
    return (int)cudaErrorInvalidValue;
  const int groups = C / 4;
  const int slices = groups >= 288 ? 1 : 288 / groups;
  const int threads = ((groups * slices + 31) / 32) * 32;
  const size_t smem = sizeof(float) * ((size_t)V * P + (size_t)slices * C);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  epipolar_attention_kernel<<<B * R, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(wt), V, R, P, D, C, slices, scale);
  return (int)cudaGetLastError();
}
