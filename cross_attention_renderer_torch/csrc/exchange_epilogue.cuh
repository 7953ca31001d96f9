// The exchange epilogue kernel for Hopper (sm_90a), shared by the V=2
// epilogue (gather_epilogue.cu) and the S-stream epilogue
// (gather_epilogue_multi.cu); the fused render core (fused_render.cu) runs
// its gather, combine and fuse MLP on other tiles. For a tile of 16 * MT samples it does, per
// stream s:
//
//   comb = sum_k w_k * row[k*C:(k+1)*C] per pyramid level    (bf16, as the
//          TPU kernels' combine runs in the table type)
//   h    = relu(comb @ W1[:F] + sum_j tanh_j * W1[F+j] + b1) (f32 sum)
//   f_s  = bf16(h) @ W2 + b2                                 (f32 sum)
//
// and places bf16(f_s) in slot s of the sample's [f_0 | f_1 | ...] row; with
// kViewSwap (V=2) the slot is 0 for the stream of the sample's own view id
// (m // rp) % 2 and 1 for the other, so view 0 reads [self, cross] and view
// 1 [cross, self]. Then
//
//   jl = [f_0 | ... | f_{S-1}] @ lv + lvb
//   kv = bf16(relu([f_0 | ... ] @ km + kmb)) @ k2 + k2b,
//
// every product accumulated in f32 across all S streams and rounded once.
// Each block fetches its own cell rows with 16-byte loads straight into the
// combine; every intermediate of a tile lives in shared memory.

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

template <int MT, bool kViewSwap>
__global__ void __launch_bounds__(kThreads, 1)
    exchange_epilogue_kernel(const Args p) {
  constexpr int BM = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldc = p.F + kPad, ldh = p.H1 + kPad, ldf = p.S * p.O + kPad;
  bf16* comb = reinterpret_cast<bf16*>(smem_raw);  // (BM, F); later kh
  bf16* hbuf = comb + BM * ldc;                     // (BM, H1)
  bf16* fbuf = hbuf + BM * ldh;                     // (BM, S*O): [f_0 | ...]
  bf16* aux_s = fbuf + BM * ldf;                    // (BM, 16)
  const int m0 = blockIdx.x * BM;
  const auto sample = [&](int r) { return m0 + r < p.M ? m0 + r : -1; };

  for (int s = 0; s < p.S; ++s) {
    gather_combine<BM>(p, s, sample, comb, ldc, aux_s);
    mlp2_tile<MT, 3>(comb, ldc, p.F, aux_s + 12, 16, p.w1t, p.w1_tanh, p.b1,
                     p.H1, p.w2t, p.b2, p.O, hbuf, ldh,
                     [&](int row, int col, float x0, float x1) {
      int slot = s;
      if (kViewSwap) slot = (((m0 + row) / p.rp) & 1) == s ? 0 : 1;
      store2(fbuf + row * ldf + slot * p.O + col, x0, x1);
    });
  }

  // jl = [f_0 | ...] @ lv + lvb
  const int KF = p.S * p.O;
  tile_gemm<MT, 3>(fbuf, ldf, p.lvt, KF, p.O,
                   [&](int row, int col, float x0, float x1) {
    const int m = m0 + row;
    if (m < p.M)
      store2(p.jl + (size_t)m * p.O + col, x0 + p.lvb[col],
             x1 + p.lvb[col + 1]);
  });

  // kh = relu([f_0 | ...] @ km + kmb), into the free comb tile
  bf16* kh = comb;
  const int ldk = p.K + kPad;
  tile_gemm<MT, 2>(fbuf, ldf, p.kmt, KF, p.K,
                   [&](int row, int col, float x0, float x1) {
    store2(kh + row * ldk + col, fmaxf(x0 + p.kmb[col], 0.f),
           fmaxf(x1 + p.kmb[col + 1], 0.f));
  });
  __syncthreads();

  // kv = kh @ k2 + k2b
  tile_gemm<MT, 2>(kh, ldk, p.k2t, p.K, p.K,
                   [&](int row, int col, float x0, float x1) {
    const int m = m0 + row;
    if (m < p.M)
      store2(p.kv + (size_t)m * p.K + col, x0 + p.k2b[col],
             x1 + p.k2b[col + 1]);
  });
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

// Launches the kernel for tiles of 16 * MT samples on `stream`; refuses
// when the tiles do not fit in the card's shared memory.
template <int MT, bool kViewSwap>
int launch(const Args& a, void* stream) {
  constexpr int BM = 16 * MT;
  const size_t smem = sizeof(bf16) * (size_t)BM *
                      ((a.F + kPad) + (a.H1 + kPad) + (a.S * a.O + kPad) + 16);
  const int err = set_smem(exchange_epilogue_kernel<MT, kViewSwap>, smem);
  if (err) return err;
  const int grid = (a.M + BM - 1) / BM;
  exchange_epilogue_kernel<MT, kViewSwap>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace exchange_epilogue
