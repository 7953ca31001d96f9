// The exchange streams' address math, for Hopper (sm_90a): every stream's
// cell rows and aux rows of one ray block in one launch.
//
// Replaces no TPU kernel. In the JAX package this math is plain jnp code
// (cross_attention_renderer_tpu/models/renderer.py:591-655 at V=2,
// :710-754 at V>=3) that XLA fuses into the programs around it. Run
// eagerly by PyTorch it is ~150 small kernels a stream and pyramid level
// (~1,150 a ray block at V=2, ~1,800 at V=3) and two host syncs, which
// left the card idle for most of a render. The plain version is
// ops/stream_takes.py:stream_takes_reference; this kernel computes the
// same values.
//
// For sample m = ((b V + v) R + r) P + p of view v and stream s:
//   s = 0, the self stream: the point pt_in[b, v, v] and the ndc coords
//     pixel_val[m] on image row b V + v, 'border' padding;
//   s >= 1: k = the (s-1)-th view other than v in ascending order, the
//     point pt_in[b, k, v] = rel[b, k, v] applied to pt_views[m]
//     (non-finite -> 0), projected with k's intrinsics (non-finite ->
//     1e10), to ndc; image row b V + k, 'zeros' padding.
//   For each level l: cells[l][s M + m], the row of the level's packed
//   table, and its four slot weights (ops/grid_sample.py:
//   cell_rows_and_slot_weights: the 2^24 clamp, the slot folding at the
//   edges, dead 'zeros' samples on row 0 with zero weights); aux[s][m] =
//   [the weights of each level | tanh(pt / 5) | zeros] in the model type
//   (gather_epilogue.aux_layout).
//
// Bit-equal to the plain version on the card: every float operation is the
// one PyTorch's elementwise kernel computes, in the same order, rounded to
// nearest by the __f*_rn intrinsics, which nvcc never contracts into an
// fma. A tensor divided by a host scalar (pt / 5, pixel / (W - 1)) is a
// product with the scalar's reciprocal, as PyTorch computes it on the card
// (div_true_kernel_cuda).
//
// What bounds it on an H100: bytes. A sample reads 20 bytes (its ndc
// coords and its point) and writes, for each of V streams, a 4-byte cell a
// level and an aux row (32 bytes in bf16 at three levels): at the 2-view
// flagship's ray block (M = 1,048,576) 21 MB in and 92 MB out, 34 us at
// 3.35 TB/s. What the design does about it: one thread a sample reads its
// inputs once (neighbouring threads, neighbouring samples); the B V V
// relative transforms and B V intrinsics, a few hundred floats, are staged
// in shared memory once a block; each stream's aux row is assembled in
// registers and written with 16-byte stores, and the cells of a warp are
// 128 contiguous bytes. The arithmetic, ~60 operations and a tanh a stream
// and level, hides under the stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;
// Transforms and intrinsics staged in shared memory up to this many bytes;
// beyond it (more than ~700 batch-view pairs) they are read where they lie.
constexpr int kStagedBytes = 48 * 1024;
// ops/grid_sample.py _COORD_LIMIT: cell origins are clamped here before
// the int32 conversion
constexpr float kCoordLimit = 16777216.0f;
// geometry/rays.py _FAR_SENTINEL, and project_pinhole's denominator guard,
// both cast from the double PyTorch holds them in
constexpr float kFar = static_cast<float>(1e10);
constexpr float kGuard = static_cast<float>(1e-12);

struct Params {
  const float* pixel_val;   // (M, 2): the self stream's ndc coords
  const float* pt_views;    // (M, 3)
  const float* rel;         // (B, V, V, 4, 4): inv(c2w[b, k]) @ c2w[b, v]
  const float* intr;        // (B, V, 4, 4), pixel units
  int* cells[kMaxLevels];   // per level (V M,), stream-major
  void* aux;                // (V, M, width)
  int level_h[kMaxLevels], level_w[kMaxLevels];
  long long M;
  int B, V, RP, H, W;
  int staged;               // transforms and intrinsics in shared memory
};

// (column of tanh(pt / 5), width) of an aux row: gather_epilogue.aux_layout
__host__ __device__ constexpr int aux_t_col(int L) {
  return 4 * (L > 3 ? L : 3);
}
__host__ __device__ constexpr int aux_width(int L) {
  return (aux_t_col(L) + 3 + 7) / 8 * 8;
}

// The clamp to +-2^24, through which NaN passes (PyTorch's clamp), then
// the int32 conversion, which takes NaN to 0 as PyTorch's does on the card
// (both are cvt.rzi.s32.f32).
__device__ __forceinline__ int origin(float v) {
  if (!isnan(v)) v = fminf(fmaxf(v, -kCoordLimit), kCoordLimit);
  return __float2int_rz(v);
}

// cell_rows_and_slot_weights for one sample and level: returns the cell
// row and writes the four slot weights (f32).
template <bool kZeros>
__device__ __forceinline__ int cell_and_slots(float cx, float cy, int h,
                                              int w, int image,
                                              float (&ws)[4]) {
  const float x = __fsub_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(cx, 1.0f), static_cast<float>(w)), 0.5f),
      0.5f);
  const float y = __fsub_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(cy, 1.0f), static_cast<float>(h)), 0.5f),
      0.5f);
  const float x0 = floorf(x), y0 = floorf(y);
  const float wx = __fsub_rn(x, x0), wy = __fsub_rn(y, y0);
  const int x0i = origin(x0), y0i = origin(y0);
  const int x0c = min(max(x0i, 0), w - 2), y0c = min(max(y0i, 0), h - 2);
  const int cell = image * (h * w) + y0c * w + x0c;
#pragma unroll
  for (int k = 0; k < 4; ++k) ws[k] = 0.0f;
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const float wy_c = dy ? wy : __fsub_rn(1.0f, wy);
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float wx_c = dx ? wx : __fsub_rn(1.0f, wx);
      float w_c = __fmul_rn(wx_c, wy_c);
      if (kZeros) {
        const bool inb = x0i + dx >= 0 && x0i + dx <= w - 1 &&
                         y0i + dy >= 0 && y0i + dy <= h - 1;
        w_c = __fmul_rn(w_c, inb ? 1.0f : 0.0f);
      }
      const int sx = min(max(x0i + dx, 0), w - 1) - x0c;
      const int sy = min(max(y0i + dy, 0), h - 1) - y0c;
      const int slot = sy * 2 + sx;
      // every slot takes w_c * (hit): a NaN weight reaches all four, as in
      // the plain version
#pragma unroll
      for (int k = 0; k < 4; ++k)
        ws[k] = __fadd_rn(ws[k], __fmul_rn(w_c, slot == k ? 1.0f : 0.0f));
    }
  }
  // the weights are >= 0 or NaN, so their sum is <= 0 exactly when all
  // four are zero, in any order of summation
  if (kZeros && __fadd_rn(__fadd_rn(__fadd_rn(ws[0], ws[1]), ws[2]), ws[3]) <=
                    0.0f)
    return 0;
  return cell;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          << 16);
}

template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* dst,
                                          const float (&row)[N]) {
  static_assert(N % 8 == 0, "aux rows are whole 16-byte chunks");
  uint4* out = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int c = 0; c < N / 8; ++c)
    out[c] = make_uint4(pack_bf16(row[8 * c], row[8 * c + 1]),
                        pack_bf16(row[8 * c + 2], row[8 * c + 3]),
                        pack_bf16(row[8 * c + 4], row[8 * c + 5]),
                        pack_bf16(row[8 * c + 6], row[8 * c + 7]));
}

template <int N>
__device__ __forceinline__ void store_row(float* dst, const float (&row)[N]) {
  static_assert(N % 4 == 0, "aux rows are whole 16-byte chunks");
  float4* out = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int c = 0; c < N / 4; ++c)
    out[c] = make_float4(row[4 * c], row[4 * c + 1], row[4 * c + 2],
                         row[4 * c + 3]);
}

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
    stream_takes_kernel(const Params p) {
  constexpr int kWidth = aux_width(L), kTCol = aux_t_col(L);
  extern __shared__ float table[];
  const int V = p.V;
  const int n_rel = p.B * V * V * 16;
  const float* rel = p.rel;
  const float* intr = p.intr;
  if (p.staged) {
    for (int i = threadIdx.x; i < n_rel + p.B * V * 16; i += kThreads)
      table[i] = i < n_rel ? p.rel[i] : p.intr[i - n_rel];
    __syncthreads();
    rel = table;
    intr = table + n_rel;
  }
  const long long m = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (m >= p.M) return;
  const int bv = static_cast<int>(m / p.RP);
  const int b = bv / V, v = bv % V;
  const float pv_x = __ldg(p.pixel_val + 2 * m);
  const float pv_y = __ldg(p.pixel_val + 2 * m + 1);
  const float p0 = __ldg(p.pt_views + 3 * m);
  const float p1 = __ldg(p.pt_views + 3 * m + 1);
  const float p2 = __ldg(p.pt_views + 3 * m + 2);
  // pixel_to_ndc's divisions by the host scalars W - 1 and H - 1
  const float inv_w1 = __fdiv_rn(1.0f, static_cast<float>(p.W - 1));
  const float inv_h1 = __fdiv_rn(1.0f, static_cast<float>(p.H - 1));
  const float fifth = __fdiv_rn(1.0f, 5.0f);  // tanh(pt / 5.0)
  T* aux = static_cast<T*>(p.aux);

  for (int s = 0; s < V; ++s) {
    const int k = s == 0 ? v : (s - 1 < v ? s - 1 : s);
    // geometry/rays.py transform_points, then the isfinite scrub
    const float* t = rel + (static_cast<size_t>(b * V + k) * V + v) * 16;
    float q[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float e = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(p0, t[4 * i]),
                              __fmul_rn(p1, t[4 * i + 1])),
                    __fmul_rn(p2, t[4 * i + 2])),
          t[4 * i + 3]);
      q[i] = isfinite(e) ? e : 0.0f;
    }
    float cx = pv_x, cy = pv_y;
    int image = bv;
    if (s > 0) {
      // project_pinhole with k's intrinsics, then pixel_to_ndc
      const float* K = intr + static_cast<size_t>(b * V + k) * 16;
      const float den = __fadd_rn(q[2], kGuard);
      float xp = __fadd_rn(__fdiv_rn(__fmul_rn(K[0], q[0]), den), K[2]);
      float yp = __fadd_rn(__fdiv_rn(__fmul_rn(K[5], q[1]), den), K[6]);
      xp = isfinite(xp) ? xp : kFar;
      yp = isfinite(yp) ? yp : kFar;
      cx = __fsub_rn(__fmul_rn(__fmul_rn(xp, inv_w1), 2.0f), 1.0f);
      cy = __fsub_rn(__fmul_rn(__fmul_rn(yp, inv_h1), 2.0f), 1.0f);
      image = b * V + k;
    }
    float row[kWidth];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float ws[4];
      const int cell =
          s == 0 ? cell_and_slots<false>(cx, cy, p.level_h[l], p.level_w[l],
                                         image, ws)
                 : cell_and_slots<true>(cx, cy, p.level_h[l], p.level_w[l],
                                        image, ws);
      p.cells[l][s * p.M + m] = cell;
#pragma unroll
      for (int c = 0; c < 4; ++c) row[4 * l + c] = ws[c];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) row[kTCol + i] = tanhf(__fmul_rn(q[i], fifth));
#pragma unroll
    for (int c = kTCol + 3; c < kWidth; ++c) row[c] = 0.0f;
    store_row(aux + (s * p.M + m) * kWidth, row);
  }
}

template <typename T>
int launch(const Params& p, int n_levels, cudaStream_t stream) {
  const long long blocks = (p.M + kThreads - 1) / kThreads;
  const int smem =
      p.staged ? (p.B * p.V * p.V + p.B * p.V) * 16 * 4 : 0;
  if (n_levels == 3)
    stream_takes_kernel<T, 3><<<static_cast<unsigned>(blocks), kThreads,
                                smem, stream>>>(p);
  else if (n_levels == 4)
    stream_takes_kernel<T, 4><<<static_cast<unsigned>(blocks), kThreads,
                                smem, stream>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int run(bool bf16, const float* pixel_val, const float* pt_views,
        const float* rel, const float* intr, int* const* cells, void* aux,
        const int* level_hw, int n_levels, long long M, int B, int V, int RP,
        int H, int W, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || M <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.pixel_val = pixel_val;
  p.pt_views = pt_views;
  p.rel = rel;
  p.intr = intr;
  for (int l = 0; l < n_levels; ++l) {
    p.cells[l] = cells[l];
    p.level_h[l] = level_hw[2 * l];
    p.level_w[l] = level_hw[2 * l + 1];
  }
  p.aux = aux;
  p.M = M;
  p.B = B;
  p.V = V;
  p.RP = RP;
  p.H = H;
  p.W = W;
  p.staged = (B * V * V + B * V) * 16 * 4 <= kStagedBytes;
  return bf16 ? launch<__nv_bfloat16>(p, n_levels, stream)
              : launch<float>(p, n_levels, stream);
}

}  // namespace

// Every stream's cells and aux of one ray block (see the top of the file).
// level_hw holds (H_l, W_l) of each of n_levels (3 or 4) levels; cells,
// n_levels pointers to (V M,) int32; aux, (V, M, width) in the entry's
// type. Returns a CUDA error code (0: launched).
extern "C" int stream_takes_bf16(const float* pixel_val, const float* pt_views,
                                 const float* rel, const float* intr,
                                 int* const* cells, void* aux,
                                 const int* level_hw, int n_levels,
                                 long long M, int B, int V, int RP, int H,
                                 int W, cudaStream_t stream) {
  return run(true, pixel_val, pt_views, rel, intr, cells, aux, level_hw,
             n_levels, M, B, V, RP, H, W, stream);
}

extern "C" int stream_takes_f32(const float* pixel_val, const float* pt_views,
                                const float* rel, const float* intr,
                                int* const* cells, void* aux,
                                const int* level_hw, int n_levels,
                                long long M, int B, int V, int RP, int H,
                                int W, cudaStream_t stream) {
  return run(false, pixel_val, pt_views, rel, intr, cells, aux, level_hw,
             n_levels, M, B, V, RP, H, W, stream);
}
