// Fused V=2 exchange epilogue with the cell-row gather inside, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_make_kernel` launched by `_pallas_forward` in
// cross_attention_renderer_tpu/ops/gather_epilogue.py (the V=2
// `fused_exchange_epilogue`). For a tile of 64 samples it does, per stream
// (self, then cross):
//
//   comb = sum_k w_k * row[k*C:(k+1)*C] per pyramid level    (bf16, as the
//          TPU kernel's combine runs in the table type)
//   h    = relu(comb @ W1[:F] + sum_j tanh_j * W1[F+j] + b1) (f32 sum)
//   f    = bf16(h) @ W2 + b2                                 (f32 sum)
//
// then places bf16(f) in the [a | b] halves of the sample's row by its view
// id (m // rp) % 2 (view 0: [self, cross], view 1: [cross, self]) and writes
//
//   jl = [a | b] @ lv + lvb
//   kv = bf16(relu([a | b] @ km + kmb)) @ k2 + k2b.
//
// What bounds it on an H100: about 2.5 MFLOP a sample in the matrix
// products (2.6 TFLOP a call at the flagship's 1,048,576 samples, ~2.7 ms at
// 989 TFLOP/s in bf16) against ~9.7 GB of cell rows read at random (~2.9 ms
// at 3.35 TB/s): both sides are close, so neither may be wasted.
//
// What the design does about it. On the TPU the row take ran outside the
// kernel, only because Mosaic cannot address single rows; outside a kernel
// that take writes a (2M, 2304) bf16 stack (~9.7 GB) and reads it back. Here
// each block fetches its own cell rows with 16-byte loads straight into the
// bilinear combine, so rows cross device memory once and nothing but the
// (M, 288) and (M, 128) outputs is written. Every intermediate of a tile
// (the combine, the hidden layer, the [a | b] latent pair) lives in shared
// memory, 226 KB at the flagship widths. The products run on the tensor
// cores through mma.sync m16n8k16 (bf16 in, f32 accumulate); each warp owns
// a slice of output columns for all 64 rows, so every weight fragment it
// fetches from L2 (the ~1.5 MB of bf16 weights stay there) serves four row
// tiles, and the fetches for the next four k-steps are issued before the
// current ones are multiplied. A simple first kernel: no TMA, no wgmma, one
// block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // samples per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMT = kBM / 16;  // m16 row tiles per block
constexpr int kMaxLevels = 3;  // aux rows hold 4 slot weights per level
constexpr int kPad = 8;        // row padding of shared tiles, in elements

typedef __nv_bfloat16 bf16;

struct Args {
  const bf16* table[kMaxLevels];     // packed cell tables (rows, 4 * C_l)
  const int32_t* cells[kMaxLevels];  // (2M,) self rows, then cross rows
  int channels[kMaxLevels];
  int n_levels;
  const bf16* aux[2];  // (M, 16) per stream: 12 slot weights, tanh(pt/5), pad
  const bf16* w1t;     // (H1, F)  = W1[:F]^T
  const float* w1_tanh;  // (3, H1) = W1[F:F+3]
  const float* b1;     // (H1,)
  const bf16* w2t;     // (O, H1)
  const float* b2;     // (O,)
  const bf16* lvt;     // (O, 2O)
  const float* lvb;    // (O,)
  const bf16* kmt;     // (K, 2O)
  const float* kmb;    // (K,)
  const bf16* k2t;     // (K, K)
  const float* k2b;    // (K,)
  bf16* jl;            // (M, O)
  bf16* kv;            // (M, K)
  int M, F, H1, O, K, rp;
};

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
// warp's column tiles j = j0 + nt * kWarps. A is a (kBM, K) bf16 tile in
// shared memory with row stride lda; K is a multiple of 16.
template <int NT>
__device__ __forceinline__ void warp_gemm(const bf16* a_smem, int lda,
                                          const bf16* __restrict__ wt,
                                          int ldw, int K, int j0, int ntiles,
                                          float (&acc)[kMT][NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t bcur[4][NT][2], bnext[4][NT][2];
  load_b<NT>(bcur, wt, ldw, K, 0, j0, ntiles);
  for (int k0 = 0; k0 < K; k0 += 64) {
    if (k0 + 64 < K) load_b<NT>(bnext, wt, ldw, K, k0 + 64, j0, ntiles);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int k = k0 + 16 * kk;
      if (k < K) {
        uint32_t a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
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
            for (int mt = 0; mt < kMT; ++mt)
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
template <int NT, typename Fn>
__device__ __forceinline__ void for_each_pair(const float (&acc)[kMT][NT][4],
                                              int j0, int ntiles, Fn f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = j0 + nt * kWarps;
    if (j >= ntiles) continue;
    const int col = j * 8 + 2 * t;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      f(mt * 16 + g, col, acc[mt][nt][0], acc[mt][nt][1]);
      f(mt * 16 + g + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[kMT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}

// Fetches the tile's cell rows of stream s and combines each level's four
// slots into comb (kBM, F); copies the tile's aux rows to aux_s (kBM, 16).
__device__ void gather_combine(const Args& p, int s, int m0, bf16* comb,
                               int ldc, bf16* aux_s) {
  const bf16* __restrict__ aux = p.aux[s];
  for (int i = threadIdx.x; i < kBM * 2; i += kThreads) {
    const int r = i >> 1, half = i & 1, m = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m < p.M)
      val = __ldg(reinterpret_cast<const uint4*>(aux + (size_t)m * 16) + half);
    reinterpret_cast<uint4*>(aux_s + r * 16)[half] = val;
  }
  __syncthreads();
  int off = 0;
  for (int l = 0; l < p.n_levels; ++l) {
    const int C = p.channels[l];
    const int tps = C / 8;  // threads per sample, 8 channels each
    const bf16* __restrict__ table = p.table[l];
    const int32_t* __restrict__ cells = p.cells[l] + (size_t)s * p.M;
#pragma unroll 4
    for (int i = threadIdx.x; i < kBM * tps; i += kThreads) {
      const int r = i / tps, c0 = (i - r * tps) * 8, m = m0 + r;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (m < p.M) {
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

__global__ void __launch_bounds__(kThreads, 1)
    exchange_epilogue_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldc = p.F + kPad, ldh = p.H1 + kPad, ldab = 2 * p.O + kPad;
  bf16* comb = reinterpret_cast<bf16*>(smem_raw);  // (kBM, F); later kh
  bf16* hbuf = comb + kBM * ldc;                    // (kBM, H1)
  bf16* ab = hbuf + kBM * ldh;                      // (kBM, 2O): [a | b]
  bf16* aux_s = ab + kBM * ldab;                    // (kBM, 16)
  const int m0 = blockIdx.x * kBM;
  const int warp = threadIdx.x >> 5;

  for (int s = 0; s < 2; ++s) {
    gather_combine(p, s, m0, comb, ldc, aux_s);

    // h = relu(comb @ W1[:F] + tanh rows as outer products + b1)
    const int nt1 = p.H1 / 8;
    for (int j0 = warp; j0 < nt1; j0 += kWarps * 3) {
      float acc[kMT][3][4];
      zero<3>(acc);
      warp_gemm<3>(comb, ldc, p.w1t, p.F, p.F, j0, nt1, acc);
      for_each_pair<3>(acc, j0, nt1, [&](int row, int col, float x0, float x1) {
        const bf16* tr = aux_s + row * 16 + 12;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const float tv = __bfloat162float(tr[e]);
          x0 = x0 + tv * p.w1_tanh[e * p.H1 + col];
          x1 = x1 + tv * p.w1_tanh[e * p.H1 + col + 1];
        }
        store2(hbuf + row * ldh + col, fmaxf(x0 + p.b1[col], 0.f),
               fmaxf(x1 + p.b1[col + 1], 0.f));
      });
    }
    __syncthreads();

    // f = h @ W2 + b2, into the a or b half of the row by its view id.
    const int nt2 = p.O / 8;
    for (int j0 = warp; j0 < nt2; j0 += kWarps * 3) {
      float acc[kMT][3][4];
      zero<3>(acc);
      warp_gemm<3>(hbuf, ldh, p.w2t, p.H1, p.H1, j0, nt2, acc);
      for_each_pair<3>(acc, j0, nt2, [&](int row, int col, float x0, float x1) {
        const int vid = ((m0 + row) / p.rp) & 1;
        const int half = vid == s ? 0 : p.O;
        store2(ab + row * ldab + half + col, x0 + p.b2[col],
               x1 + p.b2[col + 1]);
      });
    }
    __syncthreads();
  }

  // jl = [a | b] @ lv + lvb
  const int nto = p.O / 8;
  for (int j0 = warp; j0 < nto; j0 += kWarps * 3) {
    float acc[kMT][3][4];
    zero<3>(acc);
    warp_gemm<3>(ab, ldab, p.lvt, 2 * p.O, 2 * p.O, j0, nto, acc);
    for_each_pair<3>(acc, j0, nto, [&](int row, int col, float x0, float x1) {
      const int m = m0 + row;
      if (m < p.M)
        store2(p.jl + (size_t)m * p.O + col, x0 + p.lvb[col],
               x1 + p.lvb[col + 1]);
    });
  }

  // kh = relu([a | b] @ km + kmb), into the free comb tile
  bf16* kh = comb;
  const int ldk = p.K + kPad;
  const int ntk = p.K / 8;
  for (int j0 = warp; j0 < ntk; j0 += kWarps * 2) {
    float acc[kMT][2][4];
    zero<2>(acc);
    warp_gemm<2>(ab, ldab, p.kmt, 2 * p.O, 2 * p.O, j0, ntk, acc);
    for_each_pair<2>(acc, j0, ntk, [&](int row, int col, float x0, float x1) {
      store2(kh + row * ldk + col, fmaxf(x0 + p.kmb[col], 0.f),
             fmaxf(x1 + p.kmb[col + 1], 0.f));
    });
  }
  __syncthreads();

  // kv = kh @ k2 + k2b
  for (int j0 = warp; j0 < ntk; j0 += kWarps * 2) {
    float acc[kMT][2][4];
    zero<2>(acc);
    warp_gemm<2>(kh, ldk, p.k2t, p.K, p.K, j0, ntk, acc);
    for_each_pair<2>(acc, j0, ntk, [&](int row, int col, float x0, float x1) {
      const int m = m0 + row;
      if (m < p.M)
        store2(p.kv + (size_t)m * p.K + col, x0 + p.k2b[col],
               x1 + p.k2b[col + 1]);
    });
  }
}

size_t smem_bytes(int F, int H1, int O) {
  return sizeof(bf16) * (size_t)kBM *
         ((F + kPad) + (H1 + kPad) + (2 * O + kPad) + 16);
}

}  // namespace

// tables[l]: (rows_l, 4 * channels[l]) bf16; cells[l]: (2M,) int32, the
// self stream's rows then the cross stream's; aux_self, aux_cross: (M, 16)
// bf16. Weights as in Args (bf16 matrices transposed to (out, in), f32
// biases and tanh rows). jl: (M, O), kv: (M, K) bf16. All contiguous.
// Returns a cudaError_t code.
extern "C" int fused_exchange_epilogue_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* w1t, const void* w1_tanh, const void* b1, const void* w2t,
    const void* b2, const void* lvt, const void* lvb, const void* kmt,
    const void* kmb, const void* k2t, const void* k2b, void* jl, void* kv,
    int M, int F, int H1, int O, int K, int rp, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || M <= 0 || rp <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
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
  if (F_sum != F || F % 16 || H1 % 16 || (2 * O) % 16 || O % 8 || K % 16 ||
      K > F)
    return (int)cudaErrorInvalidValue;
  a.n_levels = n_levels;
  a.aux[0] = static_cast<const bf16*>(aux_self);
  a.aux[1] = static_cast<const bf16*>(aux_cross);
  a.w1t = static_cast<const bf16*>(w1t);
  a.w1_tanh = static_cast<const float*>(w1_tanh);
  a.b1 = static_cast<const float*>(b1);
  a.w2t = static_cast<const bf16*>(w2t);
  a.b2 = static_cast<const float*>(b2);
  a.lvt = static_cast<const bf16*>(lvt);
  a.lvb = static_cast<const float*>(lvb);
  a.kmt = static_cast<const bf16*>(kmt);
  a.kmb = static_cast<const float*>(kmb);
  a.k2t = static_cast<const bf16*>(k2t);
  a.k2b = static_cast<const float*>(k2b);
  a.jl = static_cast<bf16*>(jl);
  a.kv = static_cast<bf16*>(kv);
  a.M = M;
  a.F = F;
  a.H1 = H1;
  a.O = O;
  a.K = K;
  a.rp = rp;

  const size_t smem = smem_bytes(F, H1, O);
  int device = 0, optin = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      exchange_epilogue_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + kBM - 1) / kBM;
  exchange_epilogue_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
