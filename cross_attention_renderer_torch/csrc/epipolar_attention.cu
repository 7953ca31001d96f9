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
//
// Widths: where C and D are multiples of 4 (every width of the flagship)
// the loads are as above. Where D is not, the q and k rows are not 8- or
// 16-byte aligned, and the logits read a value a lane (kVecD false); where
// C is not, the value sum reads a value at a time, one thread a group of
// four channels, the last group C % 4 wide (kVecC false). It takes any C
// and D, as the TPU kernel does.
//
// Element types: the kernel is a template of the inputs' and outputs' type,
// bf16 (epipolar_attention_bf16) or f32 (epipolar_attention_f32), as the
// TPU kernel runs in the value's type. Logits and softmax are f32 in both;
// the f32 instantiation keeps the weights in f32 (no bf16 rounding before
// the value sum) and writes f32 out and at_wt. Its loads are 16 bytes a
// lane (four f32), so a warp reads a 512-byte q or k row in one step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ float from_f32(float x) {
  return x;
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

template <typename T, bool kVecD, bool kVecC>
__global__ void epipolar_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, T* __restrict__ wt, int V,
    int R, int P, int D, int C, int slices, float scale) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  const int VP = V * P;
  float* weight = smem;       // (VP): logits, then the weights in T
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
    if (kVecD) {
      for (int d = 4 * lane; d < D; d += 128) {
        const float4 a = load4(q + off + d);
        const float4 c = load4(k + off + d);
        s += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
    } else {
      for (int d = lane; d < D; d += 32)
        s += to_f32(q[off + d]) * to_f32(k[off + d]);
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
    const T w = from_f32<T>(weight[j] / denom);
    wt[((size_t)(b * V + vi) * R + r) * P + p] = w;
    weight[j] = to_f32(w);
  }
  __syncthreads();

  // Weighted value sum: thread (s, g) sums channels [4g, 4g+4) over rows
  // s, s + slices, ...; the slices are then added in shared memory. (The
  // last group of a C that is not a multiple of 4 holds C % 4 channels.)
  const int groups = (C + 3) / 4;
  if (threadIdx.x < groups * slices) {
    const int g = threadIdx.x % groups, s = threadIdx.x / groups;
    const int n = min(4, C - 4 * g);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = s; j < VP; j += slices) {
      const int vi = j / P, p = j - vi * P;
      const size_t off = ((size_t)((b * V + vi) * R + r) * P + p) * C + 4 * g;
      float4 x;
      if (kVecC) {
        x = load4(v + off);
      } else {
        x.x = to_f32(v[off]);
        x.y = n > 1 ? to_f32(v[off + 1]) : 0.f;
        x.z = n > 2 ? to_f32(v[off + 2]) : 0.f;
        x.w = n > 3 ? to_f32(v[off + 3]) : 0.f;
      }
      const float w = weight[j];
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    float* dst = part + s * C + 4 * g;
    const float a[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) dst[e] = a[e];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float t = 0.f;
    for (int s = 0; s < slices; ++s) t += part[s * C + c];
    out[(size_t)ray * C + c] = from_f32<T>(t);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, void* wt,
           int B, int V, int R, int P, int D, int C, float scale,
           void* stream) {
  const int groups = (C + 3) / 4;
  if (D <= 0 || C <= 0 || groups > 1024 || B * R <= 0)
    return (int)cudaErrorInvalidValue;
  const int slices = groups >= 288 ? 1 : 288 / groups;
  const int threads = ((groups * slices + 31) / 32) * 32;
  const size_t smem = sizeof(float) * ((size_t)V * P + (size_t)slices * C);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto q_ = static_cast<const T*>(q);
  const auto k_ = static_cast<const T*>(k);
  const auto v_ = static_cast<const T*>(v);
  const auto o_ = static_cast<T*>(out);
  const auto w_ = static_cast<T*>(wt);
  const int vec = (D % 4 == 0) * 2 + (C % 4 == 0);
  if (vec == 3)
    epipolar_attention_kernel<T, true, true><<<B * R, threads, smem, s>>>(
        q_, k_, v_, o_, w_, V, R, P, D, C, slices, scale);
  else if (vec == 2)
    epipolar_attention_kernel<T, true, false><<<B * R, threads, smem, s>>>(
        q_, k_, v_, o_, w_, V, R, P, D, C, slices, scale);
  else if (vec == 1)
    epipolar_attention_kernel<T, false, true><<<B * R, threads, smem, s>>>(
        q_, k_, v_, o_, w_, V, R, P, D, C, slices, scale);
  else
    epipolar_attention_kernel<T, false, false><<<B * R, threads, smem, s>>>(
        q_, k_, v_, o_, w_, V, R, P, D, C, slices, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k: (B, V, R, P, D); v: (B, V, R, P, C); out: (B, R, C);
// wt: (B, V, R, P), any C and D. All bf16 (epipolar_attention_bf16) or all
// f32 (epipolar_attention_f32), contiguous, 16-byte aligned. Returns a
// cudaError_t code.
extern "C" int epipolar_attention_bf16(const void* q, const void* k,
                                       const void* v, void* out, void* wt,
                                       int B, int V, int R, int P, int D,
                                       int C, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, wt, B, V, R, P, D, C, scale,
                               stream);
}

extern "C" int epipolar_attention_f32(const void* q, const void* k,
                                      const void* v, void* out, void* wt,
                                      int B, int V, int R, int P, int D,
                                      int C, float scale, void* stream) {
  return launch<float>(q, k, v, out, wt, B, V, R, P, D, C, scale, stream);
}
