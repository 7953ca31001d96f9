// The fully fused V=2 render core for Hopper (sm_90a): from the cell rows of
// both exchange streams to the attention output, in one kernel.
//
// Replaces the TPU kernel `_make_kernel` launched by `_pallas_forward` in
// cross_attention_renderer_tpu/ops/fused_render.py (`fused_render_core`).
// One block renders one ray (b, r): its 2P samples, P of view 0 then P of
// view 1, sample j at m = ((b * 2 + j / P) * R + r) * P + j % P. In tiles
// of 32 samples it runs the V=2 exchange epilogue of gather_epilogue.cu
// (cell-row gather, bilinear combine, both fuse-MLP streams, the per-view
// [self, cross] / [cross, self] order, jl = [a | b] @ lv + lvb and
// kv = bf16(relu([a | b] @ km + kmb)) @ k2 + k2b), the query embedding
//
//   ce = bf16(relu(lc @ qe1 + qe1b)) @ qe2 + qe2b
//
// and the round-1 logits ce . kv / 16; then the joint softmax over the 2P
// samples (f32), at_wt = bf16(w) and z1 = sum_j bf16(w_j) jl_j (f32 sum).
// With repeat attention, per ray ze = bf16(bf16(z1) @ el + elb) and
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
// What the design does about it. As on the TPU, no per-sample intermediate
// (joint latent, key, query embedding, round-2 query) goes to device
// memory: only the (B, R, O) output and the (B, 2, R, P) weights are
// written. The softmax spans both views of a ray, whose samples lie R * P
// apart, so a block owns whole rays. Shared memory decides the tiling: K2's
// 64-sample tile alone takes 226 KB (comb, hidden and [a | b] rows, each
// 64 x 584 bf16), and round 2 needs the ray's whole joint latent
// (2P x 288) and query embedding (2P x 128) after round 1 ends. So the
// exchange runs on 32-sample tiles (113,152 bytes) while the ray's jl and
// ce stay resident (110,592 bytes at P = 64): with the f32 logits and sums,
// 227,712 of the 232,448 bytes a block may use. The
// round-1 keys never leave the tile: each tile's logits are taken as soon
// as its keys exist. The price is half of K2's weight-fragment reuse (each
// fragment fetched from L2 serves two 16-row tiles instead of four). A
// persistent grid with per-block scratch in L2 would keep 64-sample tiles;
// it is left for the kernel's redesign. A simple first kernel: mma.sync,
// no TMA, no wgmma, one block per SM.

#include <math.h>

#include "exchange_epilogue.cuh"

namespace {

using namespace exchange_epilogue;

constexpr int kMT = 2;              // 16-row tiles per exchange tile
constexpr int kBM = 16 * kMT;       // samples per exchange tile
constexpr int kCoords = 16;         // local-coordinate width
constexpr float kAttnScale = 1.0f / 16.0f;

struct RenderArgs {
  Args ex;              // the exchange half (jl and kv unused)
  const bf16* lc;       // (M, 16) local coordinates
  const bf16* qe1t;     // (K, 16)  query_embed^T
  const float* qe1b;    // (K,)
  const bf16* qe2t;     // (K, K)   query_embed_2^T
  const float* qe2b;    // (K,)
  const bf16* el;       // (O, K)   encode_latent, (in, out)
  const float* elb;     // (K,)
  const bf16* qr1z;     // (K, K)   query_repeat_embed[:K], (in, out)
  const bf16* qr1lt;    // (K, 16)  query_repeat_embed[K:]^T
  const float* qr1b;    // (K,)
  const bf16* qr2t;     // (K, K)   query_repeat_embed_2^T
  const float* qr2b;    // (K,)
  bf16* z;              // (B, R, O)
  bf16* wt;             // (B, 2, R, P)
  int R, P, n_tiles, repeat;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// Block-wide max or sum; every thread gets the result.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float y = lane < kWarps ? red[lane] : (kMax ? -INFINITY : 0.f);
    y = kMax ? warp_max(y) : warp_sum(y);
    if (lane == 0) red[0] = y;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

// The sample of row j of ray (b, r): view j / P, sample j % P; the two
// views lie R * P apart. -1 past the ray's 2P samples.
__device__ __forceinline__ int ray_sample(const RenderArgs& p, int b, int r,
                                          int j) {
  if (j >= 2 * p.P) return -1;
  const int v = j >= p.P;
  return ((b * 2 + v) * p.R + r) * p.P + (j - v * p.P);
}

// logit[j0 + row] = q[row] . k[row] / 16 for the tile's rows before n: one
// warp per row, f32 products of the bf16 values.
__device__ void tile_logits(const bf16* q, const bf16* k, int ld, int K,
                            int j0, int n, float* logit) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = warp; row < kBM && j0 + row < n; row += kWarps) {
    float s = 0.f;
    for (int d = 2 * lane; d < K; d += 64) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(q + row * ld + d));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(k + row * ld + d));
      s += a.x * b.x + a.y * b.y;
    }
    s = warp_sum(s);
    if (lane == 0) logit[j0 + row] = s * kAttnScale;
  }
}

// Joint softmax of logit[0:n] in f32, in place, each weight rounded to
// bf16 (the value type, as the attention sums it).
__device__ void softmax_bf16(float* logit, int n, float* red) {
  float m = -INFINITY;
  for (int j = threadIdx.x; j < n; j += kThreads) m = fmaxf(m, logit[j]);
  m = block_reduce<true>(m, red);
  float den = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float e = expf(logit[j] - m);
    logit[j] = e;
    den += e;
  }
  den = block_reduce<false>(den, red);
  for (int j = threadIdx.x; j < n; j += kThreads)
    logit[j] = bf16_round(logit[j] / den);
  __syncthreads();
}

// out[c] = sum_j w[j] * jl[j][c] (f32) for c < O.
__device__ void weighted_sum(const float* w, const bf16* jl, int ldj, int n,
                             int O, float* out) {
  for (int c = threadIdx.x; c < O; c += kThreads) {
    float acc = 0.f;
    for (int j = 0; j < n; ++j)
      acc += w[j] * __bfloat162float(jl[j * ldj + c]);
    out[c] = acc;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    fused_render_kernel(const RenderArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Args& e = p.ex;
  const int F = e.F, H1 = e.H1, O = e.O, K = e.K;
  const int ldc = F + kPad, ldh = H1 + kPad, ldf = 2 * O + kPad;
  const int ldj = O + kPad, ldk = K + kPad;
  const int rows = p.n_tiles * kBM;
  bf16* comb = reinterpret_cast<bf16*>(smem_raw);  // (kBM, F); later kh,
                                                    // the query MLPs' hidden
  bf16* hbuf = comb + kBM * ldc;   // (kBM, H1); later kv, then q2
  bf16* fbuf = hbuf + kBM * ldh;   // (kBM, 2 O): [a | b]
  bf16* aux_s = fbuf + kBM * ldf;  // (kBM, 16): aux, then local coordinates
  bf16* jl_s = aux_s + kBM * 16;   // (rows, O): the ray's joint latent
  bf16* ce_s = jl_s + rows * ldj;  // (rows, K): the ray's query embedding
  float* logit = reinterpret_cast<float*>(ce_s + rows * ldk);  // (rows)
  float* z1 = logit + rows;        // (O) round-1 output
  float* z2 = z1 + O;              // (O) round-2 output
  float* ze = z2 + O;              // (K) bf16(z1) @ el + elb
  float* u = ze + K;               // (K) ze @ qr1[:K] + qr1b
  float* red = u + K;              // (32) reduction scratch

  const int ray = blockIdx.x;      // b * R + r
  const int b = ray / p.R, r = ray - b * p.R;
  const int n = 2 * p.P;

  // -- round 1: exchange, query embedding and logits, tile by tile --------
  for (int t = 0; t < p.n_tiles; ++t) {
    const int j0 = t * kBM;
    const auto sample = [&](int row) { return ray_sample(p, b, r, j0 + row); };
    for (int s = 0; s < 2; ++s) {
      gather_combine<kBM>(e, s, sample, comb, ldc, aux_s);
      mlp2_tile<kMT, 3>(comb, ldc, F, aux_s + 12, 16, e.w1t, e.w1_tanh, e.b1,
                        H1, e.w2t, e.b2, O, hbuf, ldh,
                        [&](int row, int col, float x0, float x1) {
        // view 0 reads [self, cross], view 1 [cross, self]
        const int slot = (j0 + row >= p.P) == s ? 0 : 1;
        store2(fbuf + row * ldf + slot * O + col, x0, x1);
      });
    }
    bf16* jl_t = jl_s + j0 * ldj;
    tile_gemm<kMT, 3>(fbuf, ldf, e.lvt, 2 * O, O,
                      [&](int row, int col, float x0, float x1) {
      store2(jl_t + row * ldj + col, x0 + e.lvb[col], x1 + e.lvb[col + 1]);
    });
    tile_gemm<kMT, 2>(fbuf, ldf, e.kmt, 2 * O, K,
                      [&](int row, int col, float x0, float x1) {
      store2(comb + row * ldk + col, fmaxf(x0 + e.kmb[col], 0.f),
             fmaxf(x1 + e.kmb[col + 1], 0.f));
    });
    __syncthreads();
    tile_gemm<kMT, 2>(comb, ldk, e.k2t, K, K,
                      [&](int row, int col, float x0, float x1) {
      store2(hbuf + row * ldk + col, x0 + e.k2b[col], x1 + e.k2b[col + 1]);
    });
    load_rows16<kBM>(p.lc, sample, aux_s);
    __syncthreads();
    bf16* ce_t = ce_s + j0 * ldk;
    mlp2_tile<kMT, 0>(aux_s, 16, kCoords, aux_s, 16, p.qe1t, nullptr, p.qe1b,
                      K, p.qe2t, p.qe2b, K, comb, ldk,
                      [&](int row, int col, float x0, float x1) {
      store2(ce_t + row * ldk + col, x0, x1);
    });
    tile_logits(ce_t, hbuf, ldk, K, j0, n, logit);
    __syncthreads();
  }

  softmax_bf16(logit, n, red);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int v = j >= p.P;
    p.wt[((size_t)(b * 2 + v) * p.R + r) * p.P + (j - v * p.P)] =
        __float2bfloat16(logit[j]);
  }
  weighted_sum(logit, jl_s, ldj, n, O, z1);
  __syncthreads();
  bf16* z_out = p.z + (size_t)ray * O;
  if (!p.repeat) {
    for (int c = threadIdx.x; c < O; c += kThreads)
      z_out[c] = __float2bfloat16(z1[c]);
    return;
  }

  // -- round 2: the ray's z_embed, then the repeat query tile by tile ------
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < O; ++i)
      acc += bf16_round(z1[i]) * __bfloat162float(p.el[i * K + k]);
    ze[k] = bf16_round(acc + p.elb[k]);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < K; ++i)
      acc += ze[i] * __bfloat162float(p.qr1z[i * K + k]);
    u[k] = acc + p.qr1b[k];
  }
  __syncthreads();
  for (int t = 0; t < p.n_tiles; ++t) {
    const int j0 = t * kBM;
    load_rows16<kBM>(
        p.lc, [&](int row) { return ray_sample(p, b, r, j0 + row); }, aux_s);
    __syncthreads();
    mlp2_tile<kMT, 0>(aux_s, 16, kCoords, aux_s, 16, p.qr1lt, nullptr, u, K,
                      p.qr2t, p.qr2b, K, comb, ldk,
                      [&](int row, int col, float x0, float x1) {
      store2(hbuf + row * ldk + col, x0, x1);
    });
    tile_logits(hbuf, ce_s + j0 * ldk, ldk, K, j0, n, logit);
    __syncthreads();
  }
  softmax_bf16(logit, n, red);
  weighted_sum(logit, jl_s, ldj, n, O, z2);
  __syncthreads();
  for (int c = threadIdx.x; c < O; c += kThreads)
    z_out[c] = __float2bfloat16(z2[c] + 2.f * z1[c]);
}

}  // namespace

// Shared memory of one block at these widths, in bytes.
extern "C" size_t fused_render_core_smem(int F, int H1, int O, int K, int P) {
  const size_t rows = (size_t)((2 * P + kBM - 1) / kBM) * kBM;
  return sizeof(bf16) * ((size_t)kBM * ((F + kPad) + (H1 + kPad) +
                                        (2 * O + kPad) + 16) +
                         rows * ((O + kPad) + (K + kPad))) +
         sizeof(float) * (rows + 2 * O + 2 * K + 32);
}

// tables[l]: (rows_l, 4 * channels[l]) bf16; cells[l]: (2M,) int32, the
// self stream's rows then the cross stream's, M = B * 2 * R * P;
// aux_self, aux_cross, lc: (M, 16) bf16. w: 22 weight pointers, the 11 of
// exchange_epilogue::Args then qe1t, qe1b, qe2t, qe2b, el, elb, qr1z,
// qr1lt, qr1b, qr2t, qr2b as in RenderArgs (bf16 matrices, f32 vectors).
// z: (B, R, O), wt: (B, 2, R, P) bf16. All contiguous. Returns a
// cudaError_t code.
extern "C" int fused_render_core_bf16(
    int n_levels, void* const* tables, void* const* cells,
    const int* channels, const void* aux_self, const void* aux_cross,
    const void* lc, const void* const* w, void* z, void* wt, int B, int R,
    int P, int F, int H1, int O, int K, int repeat, void* stream) {
  if (B <= 0 || R <= 0 || P <= 0 || K > H1)
    return (int)cudaErrorInvalidValue;
  RenderArgs a;
  const int M = B * 2 * R * P;
  int err = fill_args(a.ex, n_levels, tables, cells, channels, w, nullptr,
                      nullptr, 2, M, F, H1, O, K, R * P);
  if (err) return err;
  a.ex.aux[0] = static_cast<const bf16*>(aux_self);
  a.ex.aux[1] = static_cast<const bf16*>(aux_cross);
  a.ex.aux[2] = a.ex.aux[3] = nullptr;
  a.lc = static_cast<const bf16*>(lc);
  a.qe1t = static_cast<const bf16*>(w[11]);
  a.qe1b = static_cast<const float*>(w[12]);
  a.qe2t = static_cast<const bf16*>(w[13]);
  a.qe2b = static_cast<const float*>(w[14]);
  a.el = static_cast<const bf16*>(w[15]);
  a.elb = static_cast<const float*>(w[16]);
  a.qr1z = static_cast<const bf16*>(w[17]);
  a.qr1lt = static_cast<const bf16*>(w[18]);
  a.qr1b = static_cast<const float*>(w[19]);
  a.qr2t = static_cast<const bf16*>(w[20]);
  a.qr2b = static_cast<const float*>(w[21]);
  a.z = static_cast<bf16*>(z);
  a.wt = static_cast<bf16*>(wt);
  a.R = R;
  a.P = P;
  a.n_tiles = (2 * P + kBM - 1) / kBM;
  a.repeat = repeat;
  const size_t smem = fused_render_core_smem(F, H1, O, K, P);
  err = set_smem(fused_render_kernel, smem);
  if (err) return err;
  fused_render_kernel<<<B * R, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
