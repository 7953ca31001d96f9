// Tensor-core tile products for Hopper (sm_90a) on mma.sync, shared by the
// fused render core (fused_render.cu, through exchange_epilogue.cuh) and the
// fused MLP (fused_mlp.cu). K2 and K3 run on the wgmma core of
// exchange_core.cuh instead.
//
// A block of kThreads threads works on a tile of 16 * MT rows held in shared
// memory. Products run through mma.sync m16n8k16 (bf16 in, f32 accumulate);
// each warp owns a slice of output columns for all of the tile's rows, so
// every weight fragment it fetches (from L2: the weights are small and read
// by every block) serves MT row tiles, and the fragments of the next four
// k-steps are fetched before the current ones are multiplied.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tile {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;        // row padding of shared tiles, in elements

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const uint32_t*>(p));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(bf16* p, float x0, float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragments of four consecutive k-steps for this warp's NT column tiles
// j0, j0 + kWarps, ... of Wt (N, K) row-major (row n holds column n of the
// weight matrix). Tiles past ntiles and k-steps past K load zeros.
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[4][NT][2],
                                       const bf16* __restrict__ wt, int ldw,
                                       int K, int k0, int j0, int ntiles) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = j0 + nt * kWarps, k = k0 + 16 * kk;
      if (j < ntiles && k < K) {
        const bf16* p = wt + (size_t)(j * 8 + g) * ldw + k + 2 * t;
        b[kk][nt][0] = ldg32(p);
        b[kk][nt][1] = ldg32(p + 8);
      } else {
        b[kk][nt][0] = 0u;
        b[kk][nt][1] = 0u;
      }
    }
  }
}

// acc[mt][nt] += A[mt*16 : mt*16+16, :K] @ Wt[j*8 : j*8+8, :K]^T for this
// warp's column tiles j = j0 + nt * kWarps. A is a (16 * MT, K) bf16 tile in
// shared memory with row stride lda; K is a multiple of 16.
template <int MT, int NT>
__device__ __forceinline__ void warp_gemm(const bf16* a_smem, int lda,
                                          const bf16* __restrict__ wt,
                                          int ldw, int K, int j0, int ntiles,
                                          float (&acc)[MT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t bcur[4][NT][2], bnext[4][NT][2];
  load_b<NT>(bcur, wt, ldw, K, 0, j0, ntiles);
  for (int k0 = 0; k0 < K; k0 += 64) {
    if (k0 + 64 < K) load_b<NT>(bnext, wt, ldw, K, k0 + 64, j0, ntiles);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + 16 * kk;
      if (k < K) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* p = a_smem + (mt * 16 + g) * lda + k + 2 * t;
          a[mt][0] = lds32(p);
          a[mt][1] = lds32(p + 8 * lda);
          a[mt][2] = lds32(p + 8);
          a[mt][3] = lds32(p + 8 * lda + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (j0 + nt * kWarps < ntiles) {
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              mma_bf16(acc[mt][nt], a[mt], bcur[kk][nt][0], bcur[kk][nt][1]);
          }
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        bcur[kk][nt][0] = bnext[kk][nt][0];
        bcur[kk][nt][1] = bnext[kk][nt][1];
      }
  }
}

// Calls f(row, col, acc[row][col], acc[row][col + 1]) for every accumulator
// pair this thread holds (the m16n8 C-fragment layout).
template <int MT, int NT, typename Fn>
__device__ __forceinline__ void for_each_pair(const float (&acc)[MT][NT][4],
                                              int j0, int ntiles, Fn f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = j0 + nt * kWarps;
    if (j >= ntiles) continue;
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      f(mt * 16 + g, col, acc[mt][nt][0], acc[mt][nt][1]);
      f(mt * 16 + g + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// All output columns of one product of the tile: for every column pair of
// Wt (N, K) it calls f(row, col, v0, v1) with the f32 sums of A @ W. The
// warps split the N / 8 column tiles, NT at a time.
template <int MT, int NT, typename Fn>
__device__ __forceinline__ void tile_gemm(const bf16* a_smem, int lda,
                                          const bf16* __restrict__ wt, int K,
                                          int N, Fn f) {
  const int warp = threadIdx.x >> 5;
  const int ntiles = N / 8;
  for (int j0 = warp; j0 < ntiles; j0 += kWarps * NT) {
    float acc[MT][NT][4];
    zero<MT, NT>(acc);
    warp_gemm<MT, NT>(a_smem, lda, wt, K, K, j0, ntiles, acc);
    for_each_pair<MT, NT>(acc, j0, ntiles, f);
  }
}

// The two-layer MLP of a tile of 16 * MT rows:
//
//   h   = relu(x @ W1x + sum_j xs_j * W1s[j] + b1)  (f32 sum; bf16 into hbuf)
//   out = bf16(h) @ W2 + b2                         (f32, to store)
//
// x (rows, K) bf16 and xs (rows, NS) bf16 are in shared memory; the NS small
// input columns are added as outer products in f32 rather than padded into
// a product of depth 16. Calls store(row, col, out[row][col],
// out[row][col + 1]) for every output pair and syncs the block at the end.
template <int MT, int NS, typename Store>
__device__ __forceinline__ void mlp2_tile(
    const bf16* x, int ldx, int K, const bf16* xs, int ldxs,
    const bf16* __restrict__ w1t, const float* __restrict__ w1s,
    const float* __restrict__ b1, int H1, const bf16* __restrict__ w2t,
    const float* __restrict__ b2, int O, bf16* hbuf, int ldh, Store store) {
  tile_gemm<MT, 3>(x, ldx, w1t, K, H1,
                   [&](int row, int col, float x0, float x1) {
    const bf16* sr = xs + row * ldxs;
#pragma unroll
    for (int e = 0; e < NS; ++e) {
      const float sv = __bfloat162float(sr[e]);
      x0 = x0 + sv * w1s[e * H1 + col];
      x1 = x1 + sv * w1s[e * H1 + col + 1];
    }
    store2(hbuf + row * ldh + col, fmaxf(x0 + b1[col], 0.f),
           fmaxf(x1 + b1[col + 1], 0.f));
  });
  __syncthreads();
  tile_gemm<MT, 3>(hbuf, ldh, w2t, H1, O,
                   [&](int row, int col, float x0, float x1) {
    store(row, col, x0 + b2[col], x1 + b2[col + 1]);
  });
  __syncthreads();
}

// Opts the kernel in to `smem` bytes of dynamic shared memory; refuses
// (cudaErrorInvalidValue) when the card's per-block opt-in is smaller.
template <typename Kernel>
inline int set_smem(Kernel kernel, size_t smem) {
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace mma_tile
