// The exchange epilogue's tile pieces on mma.sync (mma_tile.cuh), used by
// the fused render core (fused_render.cu): the launch arguments, the
// cell-row gather with the bilinear combine into a padded (rows, F) tile,
// and fill_args. For a tile of 16 * MT samples the render core does, per
// stream s,
//
//   comb = sum_k w_k * row[k*C:(k+1)*C] per pyramid level    (bf16, as the
//          TPU kernels' combine runs in the table type)
//   h    = relu(comb @ W1[:F] + sum_j tanh_j * W1[F+j] + b1) (f32 sum)
//   f_s  = bf16(h) @ W2 + b2                                 (f32 sum)
//
// with mlp2_tile, then jl and kv with tile_gemm. K2 and K3 run the same
// function on the wgmma core of exchange_core.cuh.

#pragma once

#include "mma_tile.cuh"

namespace exchange_epilogue {

using namespace mma_tile;

constexpr int kMaxLevels = 3;   // aux rows hold 4 slot weights per level
constexpr int kMaxStreams = 4;

struct Args {
  const bf16* table[kMaxLevels];     // packed cell tables (rows, 4 * C_l)
  const int32_t* cells[kMaxLevels];  // (S*M,) cell rows, stream-major
  int channels[kMaxLevels];
  int n_levels;
  const bf16* aux[kMaxStreams];  // (M, 16) per stream: 12 slot weights,
                                 // tanh(pt/5), pad
  const bf16* w1t;       // (H1, F)  = W1[:F]^T
  const float* w1_tanh;  // (3, H1) = W1[F:F+3]
  const float* b1;       // (H1,)
  const bf16* w2t;       // (O, H1)
  const float* b2;       // (O,)
  const bf16* lvt;       // (O, S*O)
  const float* lvb;      // (O,)
  const bf16* kmt;       // (K, S*O)
  const float* kmb;      // (K,)
  const bf16* k2t;       // (K, K)
  const float* k2b;      // (K,)
  bf16* jl;              // (M, O)
  bf16* kv;              // (M, K)
  int S, M, F, H1, O, K, rp;
};

// Copies the 16-wide bf16 rows of the tile's samples from src (rows, 16) to
// dst (BM, 16); sample(r) is the sample of tile row r, or -1 for a row past
// the end, which gets zeros.
template <int BM, typename SampleFn>
__device__ void load_rows16(const bf16* __restrict__ src, SampleFn sample,
                            bf16* dst) {
  for (int i = threadIdx.x; i < BM * 2; i += kThreads) {
    const int r = i >> 1, half = i & 1, m = sample(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m >= 0)
      val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)m * 16) + half);
    reinterpret_cast<uint4*>(dst + r * 16)[half] = val;
  }
}

// Fetches the tile's cell rows of stream s and combines each level's four
// slots into comb (BM, F); copies the tile's aux rows to aux_s (BM, 16).
// sample(r) maps tile row r to its sample, or to -1 past the end.
template <int BM, typename SampleFn>
__device__ void gather_combine(const Args& p, int s, SampleFn sample,
                               bf16* comb, int ldc, bf16* aux_s) {
  load_rows16<BM>(p.aux[s], sample, aux_s);
  __syncthreads();
  int off = 0;
  for (int l = 0; l < p.n_levels; ++l) {
    const int C = p.channels[l];
    const int tps = C / 8;  // threads per sample, 8 channels each
    const bf16* __restrict__ table = p.table[l];
    const int32_t* __restrict__ cells = p.cells[l] + (size_t)s * p.M;
#pragma unroll 4
    for (int i = threadIdx.x; i < BM * tps; i += kThreads) {
      const int r = i / tps, c0 = (i - r * tps) * 8, m = sample(r);
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (m >= 0) {
        const bf16* src = table + (size_t)__ldg(cells + m) * 4 * C + c0;
        uint4 x[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          x[k] = __ldg(reinterpret_cast<const uint4*>(src + k * C));
        __nv_bfloat162* acc = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bf16 w = aux_s[r * 16 + l * 4 + k];
          const __nv_bfloat162 w2 = __halves2bfloat162(w, w);
          const __nv_bfloat162* xv =
              reinterpret_cast<const __nv_bfloat162*>(&x[k]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __nv_bfloat162 term = __hmul2(xv[e], w2);
            acc[e] = k == 0 ? term : __hadd2(acc[e], term);
          }
        }
      }
      *reinterpret_cast<uint4*>(comb + r * ldc + off + c0) = out;
    }
    off += C;
  }
  __syncthreads();
}

// Fills the level, weight and output fields of `a` from the C interface's
// pointers and checks the sizes the kernel relies on. Returns a cudaError_t
// code.
inline int fill_args(Args& a, int n_levels, void* const* tables,
                     void* const* cells, const int* channels,
                     const void* const* w, void* jl, void* kv, int S, int M,
                     int F, int H1, int O, int K, int rp) {
  if (n_levels < 1 || n_levels > kMaxLevels || S < 2 || S > kMaxStreams ||
      M <= 0 || rp <= 0)
    return (int)cudaErrorInvalidValue;
  int F_sum = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < n_levels;
    a.table[l] = used ? static_cast<const bf16*>(tables[l]) : nullptr;
    a.cells[l] = used ? static_cast<const int32_t*>(cells[l]) : nullptr;
    a.channels[l] = used ? channels[l] : 0;
    if (used && (channels[l] <= 0 || channels[l] % 8 != 0))
      return (int)cudaErrorInvalidValue;
    F_sum += a.channels[l];
  }
  // kh reuses the comb tile, so K <= F.
  if (F_sum != F || F % 16 || H1 % 16 || (S * O) % 16 || O % 8 || K % 16 ||
      K > F)
    return (int)cudaErrorInvalidValue;
  a.n_levels = n_levels;
  a.w1t = static_cast<const bf16*>(w[0]);
  a.w1_tanh = static_cast<const float*>(w[1]);
  a.b1 = static_cast<const float*>(w[2]);
  a.w2t = static_cast<const bf16*>(w[3]);
  a.b2 = static_cast<const float*>(w[4]);
  a.lvt = static_cast<const bf16*>(w[5]);
  a.lvb = static_cast<const float*>(w[6]);
  a.kmt = static_cast<const bf16*>(w[7]);
  a.kmb = static_cast<const float*>(w[8]);
  a.k2t = static_cast<const bf16*>(w[9]);
  a.k2b = static_cast<const float*>(w[10]);
  a.jl = static_cast<bf16*>(jl);
  a.kv = static_cast<bf16*>(kv);
  a.S = S;
  a.M = M;
  a.F = F;
  a.H1 = H1;
  a.O = O;
  a.K = K;
  a.rp = rp;
  return 0;
}

}  // namespace exchange_epilogue
