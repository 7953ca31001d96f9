// Fused two-layer per-sample MLP, out = relu(x1 @ W1a + x2 @ W1b + b1) @ W2
// + b2, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` launched by `fused_mlp2` in
// cross_attention_renderer_tpu/ops/experimental/fused_mlp.py. For a tile of
// 64 rows it loads x1 (bf16) and x2 (3 columns, bf16) into shared memory,
// then
//
//   h   = relu(x1 @ W1a + sum_j x2_j * W1b[j] + b1)  (f32 sums, f32 bias)
//   out = bf16(h) @ W2 + b2                          (f32 sum, f32 bias)
//
// with the cast points of the TPU kernel: x2 and the weight matrices in
// bf16, biases in f32, h rounded to the weight type before the second
// product.
//
// What bounds it on an H100: operations. At the renderer's fuse MLP
// (K1 = 576, H = 576, O = 288) a row costs ~1.0 MFLOP against 1.7 KB of x1
// and out; 393,216 rows a call (one view's samples of an 8,192-ray block at
// V=3, 48 samples) are 0.39 TFLOP, ~0.40 ms at 989 TFLOP/s, against
// ~0.68 GB, ~0.20 ms at 3.35 TB/s.
//
// What the design does about it: x1 crosses device memory once, with
// 16-byte loads, and the (M, H) hidden layer never leaves shared memory
// (the 64-row x1 tile and hidden tile take 150 KB); the products run on the
// tensor cores through mma.sync m16n8k16 (mma_tile.cuh), each weight
// fragment fetched from L2 serving four row tiles. A simple first kernel:
// no TMA, no wgmma, one block per SM.

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

constexpr int kMT = 4;          // m16 row tiles per block
constexpr int kBM = 16 * kMT;   // rows per block
constexpr int kNX2 = 3;         // x2 columns
constexpr int kLdx2 = 8;        // row stride of the x2 tile, in elements

struct Args {
  const bf16* x1;   // (M, K1)
  const bf16* x2;   // (M, 3)
  const bf16* w1t;  // (H, K1) = W1a^T
  const float* w1x; // (3, H)  = W1b
  const float* b1;  // (H,)
  const bf16* w2t;  // (O, H)
  const float* b2;  // (O,)
  bf16* out;        // (M, O)
  int M, K1, H, O;
};

__global__ void __launch_bounds__(kThreads, 1) fused_mlp2_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = p.K1 + kPad, ldh = p.H + kPad;
  bf16* xt = reinterpret_cast<bf16*>(smem_raw);  // (kBM, K1)
  bf16* hbuf = xt + kBM * ldx;                    // (kBM, H)
  bf16* x2t = hbuf + kBM * ldh;                   // (kBM, kLdx2)
  const int m0 = blockIdx.x * kBM;

  const int vpr = p.K1 / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kBM * vpr; i += kThreads) {
    const int r = i / vpr, c0 = (i - r * vpr) * 8, m = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m < p.M)
      val = __ldg(reinterpret_cast<const uint4*>(p.x1 + (size_t)m * p.K1 +
                                                 c0));
    *reinterpret_cast<uint4*>(xt + r * ldx + c0) = val;
  }
  for (int i = threadIdx.x; i < kBM * kNX2; i += kThreads) {
    const int r = i / kNX2, e = i - r * kNX2, m = m0 + r;
    x2t[r * kLdx2 + e] = m < p.M ? p.x2[(size_t)m * kNX2 + e]
                                 : __float2bfloat16(0.f);
  }
  __syncthreads();

  mlp2_tile<kMT, kNX2>(xt, ldx, p.K1, x2t, kLdx2, p.w1t, p.w1x, p.b1, p.H,
                       p.w2t, p.b2, p.O, hbuf, ldh,
                       [&](int row, int col, float x0, float x1) {
    const int m = m0 + row;
    if (m < p.M) store2(p.out + (size_t)m * p.O + col, x0, x1);
  });
}

}  // namespace

// x1: (M, K1), x2: (M, 3), out: (M, O) bf16; w1t: (H, K1) and w2t: (O, H)
// bf16 (the weight matrices transposed); w1x: (3, H), b1: (H,), b2: (O,)
// f32. All contiguous. Returns a cudaError_t code.
extern "C" int fused_mlp2_bf16(const void* x1, const void* x2,
                               const void* w1t, const void* w1x,
                               const void* b1, const void* w2t,
                               const void* b2, void* out, int M, int K1,
                               int H, int O, void* stream) {
  if (M <= 0 || K1 % 16 || H % 16 || O % 8) return (int)cudaErrorInvalidValue;
  Args a;
  a.x1 = static_cast<const bf16*>(x1);
  a.x2 = static_cast<const bf16*>(x2);
  a.w1t = static_cast<const bf16*>(w1t);
  a.w1x = static_cast<const float*>(w1x);
  a.b1 = static_cast<const float*>(b1);
  a.w2t = static_cast<const bf16*>(w2t);
  a.b2 = static_cast<const float*>(b2);
  a.out = static_cast<bf16*>(out);
  a.M = M;
  a.K1 = K1;
  a.H = H;
  a.O = O;
  const size_t smem =
      sizeof(bf16) * (size_t)kBM * ((K1 + kPad) + (H + kPad) + kLdx2);
  const int err = set_smem(fused_mlp2_kernel, smem);
  if (err) return err;
  const int grid = (M + kBM - 1) / kBM;
  fused_mlp2_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
