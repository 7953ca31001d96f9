// The exchange core for Hopper (sm_90a): one persistent wgmma kernel, four
// instantiations (Mode):
//
//   kPair    K2, the V=2 exchange epilogue (gather_epilogue.cu);
//   kStreams K3, the S-stream epilogue (gather_epilogue_multi.cu);
//   kMlp     K9, the fuse MLP alone on rows read as they are (fused_mlp.cu);
//   kRender  K4, K2's function per view tile, then both attention rounds
//            per ray (fused_render.cu).
//
// For a tile of 64 samples it computes, per stream s,
//
//   comb = sum_k w_k * row[k*C:(k+1)*C] per pyramid level    (bf16, corner
//          order, as the TPU kernels' combine runs in the table type; kMlp:
//          the input rows x1 themselves)
//   h    = relu(comb @ W1[:F] + sum_j tanh_j * W1[F+j] + b1) (f32 sum; kMlp:
//          x2 in place of the tanh rows)
//   f_s  = bf16(h) @ W2 + b2                                 (f32 sum)
//
// kMlp writes bf16(f) and stops. The others place bf16(f_s) in slot s of
// the sample's [f_0 | f_1 | ...] row (kPair: slot 0 for the stream of the
// row's own view id (m // rp) % 2, 1 for the other; kRender: the same, the
// view being the tile's), then
//
//   jl = [f_0 | ... | f_{S-1}] @ lv + lvb
//   kv = bf16(relu([f_0 | ... ] @ km + kmb)) @ k2 + k2b,
//
// every product accumulated in f32 across all S streams and rounded once.
// K2 and K3 write jl and kv. K4 keeps them: kv meets the query embedding
// ce = bf16(bf16(relu(lc @ qe1 + qe1b)) @ qe2 + qe2b) in registers as the
// round-1 logits ce . kv / 16, and the ray's 2P rows of jl and ce go to a
// per-block scratch in device memory (104 KB at the flagship, so 132
// blocks hold ~14 MB, which L2 keeps); see ray_tail for the rest.
//
// The schedule. A block is two consumer warpgroups (warps 0-7), which run
// every product as wgmma m64nNk16 with f32 sums, and one producer warp
// (warp 8). The weights a tile needs are read as stages: for each chunk of
// 64 hidden units, the chunk's W1 columns by 64-deep k-blocks (8 KB each)
// then its W2 rows by 96-column tiles (12 KB each); then lv, km and k2, and
// K4's query weights (layout_stages and its siblings in
// ops/gather_epilogue.py lay them out once, already swizzled). Each
// consumer warpgroup has a ring of shared-memory slots of its own, which
// lane w of the producer warp fills in that warpgroup's order with
// cp.async.bulk, each copy completing on the slot's mbarrier. The grid is
// persistent, one block per SM walking over tiles (K4: over rays), and the
// rings run on across tiles, so the next tile's first stages arrive while
// this tile's rows are gathered. (Sharing each stage across a cluster of 2
// or 4 blocks by multicast halves or quarters the weights' L2 reads, but
// measured slower on the H100: the blocks of a cluster then wait for each
// other at every slot.)
//
// Per stream both warpgroups fetch the tile's cell rows (16-byte loads)
// and combine them into comb, a (64, F) tile in the swizzled wgmma layout.
// Up to O = 288 (three O tiles: the f accumulators of one warpgroup fill
// 144 registers) the fuse MLP runs over chunks of 64 hidden units,
// warpgroup w taking the chunks c with c % 2 == w ^ (s % 2) (so with an
// even S each takes half): h_c = relu(comb @ W1[:, c] + ...) stays in
// registers, is rounded to bf16 and is the register A operand of
// f += h_c @ W2[c, :], so no hidden layer is kept in shared memory. The two
// warpgroups' partial f (f32) are summed through shared memory; f + b2 goes
// to the tile's f rows in bf16, which jl and kh read as a shared-memory A
// operand; kh is rounded to bf16 in registers and is the A operand of kv.
// Above O = 288 (osplit) each warpgroup owns half of the O tiles instead and
// runs every chunk's layer 1 itself, once per group of up to three of its O
// tiles: layer 1 is computed twice or more, but no accumulator spills and
// no partial sums are exchanged. Two warpgroups on one tile keep the tensor
// cores busy while either waits for a stage or runs its epilogue
// arithmetic: a warpgroup waits for its products before it releases their
// stage, so a ring of three slots keeps two stages in flight. Where the
// slot order allows (kStreams, and kRender, whose tile is of one view and
// runs its own view's stream first), the last stream's f goes into the comb
// tile, which it no longer needs, so three streams fit in the shared memory
// of two.
//
// Three plans (template kPlan; launch_core takes the first that fits a
// block's shared memory beside kMinStages stage slots, three a ring;
// ops/gather_epilogue.py core_plan mirrors it). 'smem': comb and the f
// rows are swizzled tiles in shared memory, read by wgmma as its
// shared-memory A operand; the flagship's widths (K3 at S = 3) take it.
// 'resident', for tiles whose f rows do not fit beside comb (K3 from S = 4
// at the flagship's widths, the U-Net's): comb stays in shared memory, so
// layer 1 reads it by descriptor as in 'smem' (H1 / 64 times a stream), and
// only the f rows go to a per-block scratch in device memory (L2), stored
// in the register A operand's fragment order so that each thread reads a
// k-step's four words with one 16-byte load. jl and kh take them as their
// register A operand, each k-block's words loaded while the previous
// k-block's products run (frag_products), so no product waits for L2.
// 'global', where even comb does not fit beside the slots (F above ~1,000,
// K9's input rows): comb goes to the scratch too, and layer 1 reads it
// there (load_frags before each k-block). Only the stage ring, aux, the
// cells, the vectors and a small reduction buffer stay in shared memory,
// so that plan has no ceiling below widths whose vectors alone fill it (H1
// in the tens of thousands). The weight stream and the schedule are the
// same in all three. K9 keeps no f rows, so its 'resident' plan would be
// its 'smem' one: it takes 'smem' down to two slots (one a ring), else
// 'global', since at fusion_features 512 its 'global' plan measured 1.8x
// the time of 'smem' with two slots a ring.
//
// Element types (template kF32). The bf16 instantiation reads and writes
// bf16. The f32 one takes f32 tables, aux, x, x2 and local coordinates and
// writes f32 outputs (jl, kv; K9's out; K4's z and at_wt), as the TPU
// kernels run in their inputs' float type. Its products are still bf16
// wgmma with f32 sums: every f32 operand is rounded to bf16 on its way in,
// as the TPU's matrix unit rounds f32 operands at default precision. The
// cell rows' combine runs in f32 on the f32 rows and the bf16-rounded slot
// weights, and comb is rounded once; aux, x, x2 and the local coordinates
// are rounded as they go to shared memory or the A fragments; the weights
// were rounded once on the host when their stages were laid out (the
// layout cache of ops/gather_epilogue.py); the outputs are written as f32
// straight from the accumulators, and K4 keeps its softmax weights in f32.
// Its internal rows (K4's jl and ce scratch, the f rows) stay bf16. So the
// shared-memory plans are the same for both types (the same plan at the
// same widths); only the cell rows' gather moves twice the bytes (a
// 16-byte chunk of comb is two 16-byte loads of each corner's row, 4C f32
// being 16 C bytes, a multiple of 128 for C % 8 == 0).
//
// Levels. The pyramid has one to four levels (the DPT encoder three, the
// ResNet34 and U-Net encoders four); a level's columns of comb start at
// level_col[l], and its four slot weights are columns 4l..4l+3 of the aux
// rows. Up to three levels the aux rows are 16 wide with tanh(pt/5) at 12
// (the TPU kernels' layout); with four they are 24 wide with it at 16, so
// that a 4-level epilogue computes what the JAX package's unfused exchange
// does (its fused kernels read tanh at 12 whatever the level count).
//
// Table types (template kI8). K2, K3 and K4 also take int8 cell tables
// (the quantized pyramid of fast evaluation, train/evaluation.py
// quantize_pyramid), in both instantiations above: aux, the local
// coordinates and the outputs stay bf16 or f32, and only the cell rows are
// int8. A 16-byte chunk of comb (8 columns) is one 8-byte load of each
// corner's row (4C int8 being 4 C bytes, a multiple of 32), its values
// converted exactly (|q| <= 127 fits bf16's 8 bits of mantissa); they are
// combined as that instantiation combines float rows: in bf16, each product
// and partial sum rounded (the bf16 one), or in f32 with comb rounded once
// (kF32). The dequantization scales are folded into W1 by the caller, so
// the kernel does nothing else differently. K9 reads no table.

#pragma once

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

namespace exchange_core {

using namespace hopper;
typedef __nv_bfloat16 bf16;

enum Mode : int { kPair = 0, kStreams = 1, kMlp = 2, kRender = 3 };
// Where comb and the f rows live (see "Three plans" above).
enum Plan : int { kSmem = 0, kGlobal = 1, kResident = 2 };

constexpr int kMaxLevels = 4;
constexpr int kRows = 64;              // samples per tile: wgmma's M
constexpr int kKBlock = kRows * 128;   // a (64, 64) bf16 A tile, 8 KB
constexpr int kNC = 64;                // hidden units per chunk
constexpr int kNO = 96;                // columns of an O tile
constexpr int kMaxOT = 3;              // O tiles a warpgroup holds at once
constexpr int kNK = 64;                // columns of a K tile
constexpr int kMaxKT = 4;              // K <= 256: kh stays in registers
constexpr int kSmallStage = kNC * 128;  // 8 KB: W1, km, k2, query stages
constexpr int kLargeStage = kNO * 128;  // 12 KB: W2, lv stages (the slot)
constexpr int kMaxStages = 8;          // slots of both rings
constexpr int kMinStages = 6;          // a plan needs three a ring (K9: 2)
constexpr int kWG = 128;               // threads of a warpgroup
constexpr int kConsumers = 2 * kWG;    // warps 0-7
constexpr int kProducerWarp = 8;       // the first of warpgroup 2
constexpr int kThreads = kConsumers + kWG;  // + the producer warpgroup
constexpr int kGatherBar = 1;          // named barrier ids (0 is
constexpr int kPairBar = 2;            // __syncthreads)
constexpr int kCeBar = 3;              // K4: the tile's ce is stored
constexpr int kFragWords = kKBlock / 4;  // 32-bit words of a k-block
constexpr float kAttnScale = 1.0f / 16.0f;

// The vectors in shared memory: bf16 (their values are bf16-rounded), but
// f32 for K9, whose biases stay f32 as the TPU kernel keeps them.
template <int kMode>
using Vec = typename std::conditional<kMode == kMlp, float, bf16>::type;

struct CoreArgs {
  const void* table[kMaxLevels];     // packed cell tables (rows, 4 * C_l)
  const int32_t* cells[kMaxLevels];  // (S*M,) cell rows, stream-major
  int channels[kMaxLevels];
  int level_col[kMaxLevels + 1];  // the first comb column of each level
                                  // (F for those past n_levels, and last)
  int n_levels;
  // The aux rows (aux_layout in ops/gather_epilogue.py): 4 slot weights a
  // level from column 0, tanh(pt/5) at tanh_col = 4 * max(n_levels, 3),
  // zero pad to aux_w = 16 (up to three levels) or 24 (four).
  int level_slots, tanh_col, aux_w;
  // kPair, kRender: aux[s] is stream s's (M, aux_w); kStreams: aux[0]
  // holds all S streams' rows, (S*M, aux_w) stream-major, as cells[l].
  const void* aux[2];
  const void* x;                 // kMlp: (M, F) input rows
  const void* x2;                // kMlp: (M, 3)
  const void* lc;                // kRender: (M, 16) local coordinates
  const unsigned char* stages;   // the weight stages of one tile
  const float* vecs;             // [W1[F:F+3] | b1 | b2 | lvb | kmb | k2b |
                                 //  qe1b | qe2b | elb | qr1b | qr2b]
  const bf16* mats;              // kRender: el (O, K), qr1[:K] (K, K)
  void* jl;                      // (M, O); kMlp: the output
  void* kv;                      // (M, K)
  void* z;                       // kRender: (B, R, O)
  void* wt;                      // kRender: (B, 2, R, P)
                                 // (table to wt: bf16, or f32 with kF32)
  unsigned char* scratch;        // per block (scr_stride bytes): kRender
                                 // the ray's jl (2P, O) then its ce (2P,
                                 // K); then, with the 'global' plan, comb
                                 // and the f rows in fragment order, with
                                 // the 'resident' one the f rows
  int S, M, F, H1, O, K, rp;      // F: comb's width; O: the f rows' (the
                                 // core's) width, see fill_sizes
  int O_out;                     // columns of jl, z and K9's out (their
                                 // row stride), O before it was rounded up
  int F_in;                      // kMlp: columns of x (its row stride), F
                                 // before it was rounded up
  int B, R, P, tv, repeat;       // kRender; tv: tiles of one view of a ray
  int n_units;                   // tiles, or rays (kRender)
  // Derived by fill_sizes: tile counts of each product and where things sit.
  int nch, nkbF, OT, osplit, KT, nkbf, nkbK, nkb_fbuf, n_stages;
  int plan;                      // Plan
  int nkb_tiles;                 // k-blocks of shared memory for tiles
  long long scr_stride, scr_wide0;  // scratch bytes a block; the offset of
                                    // the tiles in device memory in them
  int chunk_bytes;               // one hidden chunk's W1 and W2 stages
  int jl_split;                  // O tiles [0, jl_split) go to WG 0
  long long jl0, kh0, kv0, qe0, qe20, qr0, qr20;  // stage offsets
  int v_b1, v_b2, v_lvb, v_kmb, v_k2b, v_q, ldv;  // offsets into vecs
  int n_vecs, n_rsm;
};

// Two adjacent values of a vector in shared memory, as f32.
__device__ __forceinline__ float2 lds2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float2 lds2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes of a table row, not kept in L1: a block reads each row once per
// tile and stream, and L1 is what shared memory leaves (under 30 KB).
__device__ __forceinline__ uint4 ldg_row(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Elements [idx, idx + 8) of a bf16 or (kF32) f32 array as eight bf16
// values in 16 bytes; kNoL1: loaded past L1, as ldg_row.
template <bool kF32, bool kNoL1>
__device__ __forceinline__ uint4 load8(const void* base, size_t idx) {
  if (kF32) {
    const float* f = static_cast<const float*>(base) + idx;
    const uint4 a =
        kNoL1 ? ldg_row(f) : __ldg(reinterpret_cast<const uint4*>(f));
    const uint4 b = kNoL1 ? ldg_row(f + 4)
                          : __ldg(reinterpret_cast<const uint4*>(f + 4));
    return make_uint4(pack_bf16(__uint_as_float(a.x), __uint_as_float(a.y)),
                      pack_bf16(__uint_as_float(a.z), __uint_as_float(a.w)),
                      pack_bf16(__uint_as_float(b.x), __uint_as_float(b.y)),
                      pack_bf16(__uint_as_float(b.z), __uint_as_float(b.w)));
  }
  const bf16* h = static_cast<const bf16*>(base) + idx;
  return kNoL1 ? ldg_row(h) : __ldg(reinterpret_cast<const uint4*>(h));
}

// Element idx of a bf16 or (kF32) f32 array, as bf16.
template <bool kF32>
__device__ __forceinline__ bf16 load1(const void* base, size_t idx) {
  return kF32 ? __float2bfloat16(static_cast<const float*>(base)[idx])
              : static_cast<const bf16*>(base)[idx];
}

// Stores (lo, hi) as elements idx, idx + 1 (idx even) of a bf16 or (kF32)
// f32 output.
template <bool kF32>
__device__ __forceinline__ void store2(void* out, size_t idx, float lo,
                                       float hi) {
  if (kF32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) =
        make_float2(lo, hi);
  else
    *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + idx) =
        pack_bf16(lo, hi);
}

template <bool kF32>
__device__ __forceinline__ void store1(void* out, size_t idx, float x) {
  if (kF32)
    static_cast<float*>(out)[idx] = x;
  else
    static_cast<bf16*>(out)[idx] = __float2bfloat16(x);
}

// Output widths. jl (K2, K3) and K9's out are written O_out columns wide,
// O_out their row stride. An odd O_out leaves every other row's column
// pairs unaligned, so such a width takes the core built with
// CORE_ODD_OUTPUT (a library of its own, ops/_build.py VARIANTS), whose
// stores are single; the usual build keeps the paired stores alone
// (sharing one kernel between the two cost the even widths 2% of K2's
// time, measured) and refuses an odd O_out. K4 keeps its rows in its
// scratch at the even width O and writes z a value at a time, so it takes
// any O_out in the usual build.
#ifndef CORE_ODD_OUTPUT
#define CORE_ODD_OUTPUT 0
#endif
constexpr bool kOddOutput = CORE_ODD_OUTPUT != 0;

// Columns col and col + 1 (col even, col < n) of an output row n columns
// wide that starts at element `row`: one paired store, or (kOdd: n is odd)
// each of them that exists on its own.
template <bool kF32, bool kOdd>
__device__ __forceinline__ void store_cols(void* out, size_t row, int col,
                                           int n, float lo, float hi) {
  if (!kOdd) {
    store2<kF32>(out, row + col, lo, hi);
    return;
  }
  store1<kF32>(out, row + col, lo);
  if (col + 1 < n) store1<kF32>(out, row + col + 1, hi);
}

// Elements [idx, idx + min(n, 8)) of a bf16 or (kF32) f32 array as eight
// bf16 values in 16 bytes, zeros past n: the rows of an x whose width is
// not a multiple of 8, which 16-byte loads cannot read.
template <bool kF32>
__device__ __forceinline__ uint4 load_tail(const void* base, size_t idx,
                                           int n) {
  __align__(16) bf16 v[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = e < n ? load1<kF32>(base, idx + e) : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(v);
}

// The f32 tables' combine of one 8-column chunk: sum_k w[k] * row_k[0:8]
// in f32, in corner order, over the four corners' rows (C apart, two
// 16-byte loads each, past L1) and their bf16 slot weights w; rounded to
// bf16 once.
__device__ __forceinline__ uint4 combine_f32(const float* src, int C,
                                             const bf16* w) {
  uint4 x[4][2];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[k][0] = ldg_row(src + k * C);
    x[k][1] = ldg_row(src + k * C + 4);
  }
  float a[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float wk = __bfloat162float(w[k]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float term = wk * __uint_as_float(word(x[k][e >> 2], e & 3));
      a[e] = k == 0 ? term : a[e] + term;
    }
  }
  return make_uint4(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]),
                    pack_bf16(a[4], a[5]), pack_bf16(a[6], a[7]));
}

// 8 bytes of an int8 table row, past L1 (as ldg_row).
__device__ __forceinline__ uint2 ldg_row8(const void* p) {
  uint2 v;
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];\n"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
  return v;
}

// Element e (0-7) of eight int8 values in two words, as f32 (exact).
__device__ __forceinline__ float i8_at(const uint2& x, int e) {
  const uint32_t w = e < 4 ? x.x : x.y;
  return (float)(int)(int8_t)(w >> (8 * (e & 3)));
}

// The int8 tables' combine of one 8-column chunk: the four corners' rows
// (C apart, one 8-byte load each, past L1), converted exactly, times their
// bf16 slot weights w, summed in corner order: in f32 and rounded to bf16
// once (kF32), else in bf16 with each product and sum rounded, as the bf16
// rows' combine.
template <bool kF32>
__device__ __forceinline__ uint4 combine_i8(const int8_t* src, int C,
                                            const bf16* w) {
  uint2 x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = ldg_row8(src + k * C);
  if (kF32) {
    float a[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float wk = __bfloat162float(w[k]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float term = wk * i8_at(x[k], e);
        a[e] = k == 0 ? term : a[e] + term;
      }
    }
    return make_uint4(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]),
                      pack_bf16(a[4], a[5]), pack_bf16(a[6], a[7]));
  }
  uint4 out;
  __nv_bfloat162* acc = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 w2 = __halves2bfloat162(w[k], w[k]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 xv = __floats2bfloat162_rn(
          i8_at(x[k], 2 * e), i8_at(x[k], 2 * e + 1));
      const __nv_bfloat162 term = __hmul2(xv, w2);
      acc[e] = k == 0 ? term : __hadd2(acc[e], term);
    }
  }
  return out;
}

// The 'global' plan's tiles: a (64, 64 n) bf16 tile in the order of the
// register A operand, the four words that thread `lane` of warp g of a
// warpgroup holds for k-step ks being 16 contiguous bytes. Word of element
// (row, col), col even.
__device__ __forceinline__ int frag_word(int row, int col) {
  return ((((col >> 4) * 4 + (row >> 4)) * 32 + ((row & 7) << 2) +
           ((col & 7) >> 1))
          << 2) +
         (((col >> 3) & 1) << 1) + ((row >> 3) & 1);
}

// The register A operand of k-block kb's four k-steps from a tile in
// fragment order (read through L2: the block wrote it).
__device__ __forceinline__ void load_frags(const uint32_t* g, int kb,
                                           uint32_t (&af)[4][4]) {
  const int lane = threadIdx.x & 31, grp = (threadIdx.x >> 5) & 3;
  const uint4* src = reinterpret_cast<const uint4*>(g);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint4 v = __ldcg(src + ((kb * 4 + ks) * 4 + grp) * 32 + lane);
    af[ks][0] = v.x;
    af[ks][1] = v.y;
    af[ks][2] = v.z;
    af[ks][3] = v.w;
  }
}

// product(af) for k-blocks 0 .. nkb - 1 of a tile in fragment order, each
// k-block's words loaded while the previous k-block's products run (two
// fragment buffers, one k-block ahead), so that a product waits for L2
// only at the first k-block.
template <typename Product>
__device__ __forceinline__ void frag_products(const uint32_t* g, int nkb,
                                              Product product) {
  uint32_t fa[4][4], fb[4][4];
  load_frags(g, 0, fa);
  for (int kb = 0; kb < nkb; kb += 2) {
    if (kb + 1 < nkb) load_frags(g, kb + 1, fb);
    product(fa);
    if (kb + 1 == nkb) break;
    if (kb + 2 < nkb) load_frags(g, kb + 2, fa);
    product(fb);
  }
}

// Stores columns col..col+7 (col % 8 == 0) of comb's row r: into the
// swizzled shared-memory tile, or (kWide) into the fragment-order tile g.
template <bool kWide>
__device__ __forceinline__ void put_chunk(unsigned char* comb, uint32_t* g,
                                          int r, int col, uint4 v) {
  if (kWide) {
    uint32_t* w = g + frag_word(r, col);
    __stcg(w, v.x);
    __stcg(w + 4, v.y);
    __stcg(w + 8, v.z);
    __stcg(w + 12, v.w);
  } else {
    *reinterpret_cast<uint4*>(comb + (col >> 6) * kKBlock +
                              swizzle(r, col & 63)) = v;
  }
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// A consumer warpgroup's side of its stage ring: wait for a slot to fill,
// and hand it back to the producer once the wgmma that read it are done.
// (Keeping a group in flight across stages holds a second slot, and with
// three slots a ring the producer's lead then drops to one stage: measured
// slower.)
struct Ring {
  uint32_t slots, full, empty;
  int n, idx;
  uint32_t phase;

  __device__ uint32_t acquire() {
    mbar_wait(full + 8 * idx, phase);
    return slots + idx * kLargeStage;
  }
  // After committing the products of the acquired slot.
  __device__ void release() {
    wgmma_wait<0>();
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty + 8 * idx);
    if (++idx == n) {
      idx = 0;
      phase ^= 1;
    }
  }
};

// The O tiles warpgroup w computes of a stream's f: all of them (at most
// kMaxOT, chunks split between the warpgroups), or with osplit its half.
__device__ __forceinline__ void mlp_tiles(const CoreArgs& p, int w, int& t0,
                                          int& t1) {
  t0 = p.osplit && w == 1 ? p.jl_split : 0;
  t1 = p.osplit && w == 0 ? p.jl_split : p.OT;
}

// Lane w of the producer warp: the stages of consumer warpgroup w for every
// unit of this block, in that warpgroup's order, into its ring.
template <int kMode>
__device__ void produce(const CoreArgs& p, int w, uint32_t slots,
                        uint32_t full, uint32_t empty) {
  int idx = 0;
  uint32_t phase = 0;
  const int n = p.n_stages / 2;
  slots += w * n * kLargeStage;
  full += 8 * w * n;
  empty += 8 * w * n;
  const auto fetch = [&](long long off, uint32_t bytes) {
    mbar_wait(empty + 8 * idx, phase ^ 1);
    mbar_expect_tx(full + 8 * idx, bytes);
    bulk_copy(slots + idx * kLargeStage, p.stages + off, bytes,
              full + 8 * idx);
    if (++idx == n) {
      idx = 0;
      phase ^= 1;
    }
  };
  int t0, t1;
  mlp_tiles(p, w, t0, t1);
  // One stream's fuse MLP (si: the stream's place in the tile's order).
  const auto mlp = [&](int si) {
    for (int g0 = t0; g0 < t1; g0 += kMaxOT) {
      const int g1 = min(g0 + kMaxOT, t1);
      for (int c = p.osplit ? 0 : w ^ (si & 1); c < p.nch;
           c += p.osplit ? 1 : 2) {
        long long off = (long long)c * p.chunk_bytes;
        for (int kb = 0; kb < p.nkbF; ++kb, off += kSmallStage)
          fetch(off, kSmallStage);
        for (int nt = g0; nt < g1; ++nt)
          fetch(off + (long long)nt * kLargeStage, kLargeStage);
      }
    }
  };
  // A 16 -> K -> K query MLP (K4): the first layer's K tiles, then the
  // second's, each by k-blocks.
  const auto query = [&](long long l1, long long l2) {
    for (int nt = 0; nt < p.KT; ++nt)
      fetch(l1 + (long long)nt * kSmallStage, kSmallStage);
    for (int nt = 0; nt < p.KT; ++nt)
      for (int kb = 0; kb < p.nkbK; ++kb)
        fetch(l2 + ((long long)nt * p.nkbK + kb) * kSmallStage, kSmallStage);
  };
  // jl over this warpgroup's O tiles, then kh and kv (WG 1) or K4's query
  // MLP (WG 0).
  const auto tail = [&]() {
    const int a = w == 0 ? 0 : p.jl_split, e = w == 0 ? p.jl_split : p.OT;
    for (int g0 = a; g0 < e; g0 += kMaxOT)
      for (int kb = 0; kb < p.nkbf; ++kb)
        for (int nt = g0; nt < min(g0 + kMaxOT, e); ++nt)
          fetch(p.jl0 + ((long long)kb * p.OT + nt) * kLargeStage,
                kLargeStage);
    if (w == 1) {
      for (int kb = 0; kb < p.nkbf; ++kb)
        for (int nt = 0; nt < p.KT; ++nt)
          fetch(p.kh0 + ((long long)kb * p.KT + nt) * kSmallStage,
                kSmallStage);
      for (int nt = 0; nt < p.KT; ++nt)
        for (int kb = 0; kb < p.nkbK; ++kb)
          fetch(p.kv0 + ((long long)nt * p.nkbK + kb) * kSmallStage,
                kSmallStage);
    } else if (kMode == kRender) {
      query(p.qe0, p.qe20);
    }
  };
  for (int unit = blockIdx.x; unit < p.n_units; unit += gridDim.x) {
    if (kMode == kRender) {
      for (int k = 0; k < 2 * p.tv; ++k) {
        mlp(0);
        mlp(1);
        tail();
      }
      if (p.repeat)
        for (int k = w; k < 2 * p.tv; k += 2) query(p.qr0, p.qr20);
    } else {
      for (int si = 0; si < p.S; ++si) mlp(si);
      if (kMode != kMlp) tail();
    }
  }
}

// Gathers the cell rows of stream s for the tile's samples m0 + r, r <
// n_live, and combines each level's four slots into comb (64, F), swizzled
// k-blocks of 64 columns; copies the tile's aux rows to aux (64, aux_w). Rows
// past n_live get zeros. Run by the kConsumers threads, t = threadIdx.x.
// kWide: comb goes to the fragment-order tile gcomb in device memory.
// kF32: aux (rounded to bf16 here) and, unless kI8, the tables are f32.
// kI8: the tables are int8.
template <int kMode, bool kWide, bool kF32, bool kI8>
__device__ void gather_tile(const CoreArgs& p, int s, int m0, int n_live,
                            unsigned char* comb, uint32_t* gcomb, bf16* aux,
                            int* cell) {
  const int t = threadIdx.x;
  const int aw = p.aux_w, nq = aw / 8;
  for (int i = t; i < kRows * nq; i += kConsumers) {
    const int r = i / nq, q = i - r * nq;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_live)
      val = kMode == kStreams
                ? load8<kF32, false>(p.aux[0],
                                     ((size_t)s * p.M + m0 + r) * aw + 8 * q)
                : load8<kF32, false>(p.aux[s], (size_t)(m0 + r) * aw + 8 * q);
    reinterpret_cast<uint4*>(aux + r * aw)[q] = val;
  }
  // The tile's cell rows of every level first, so that the row loads below
  // wait on no other load from device memory.
  for (int i = t; i < kRows * p.n_levels; i += kConsumers) {
    const int l = i / kRows, r = i % kRows;
    cell[i] = r < n_live ? __ldg(p.cells[l] + (size_t)s * p.M + m0 + r) : -1;
  }
  bar_sync(kGatherBar, kConsumers);
  // One pass over the 16-byte chunks of all the tile's comb rows, eight per
  // thread in flight (f32 rows: four, each twice the loads); chunk q of a
  // row is column 8q, of the level whose columns hold it.
  const int ch8 = p.F / 8, off1 = p.level_col[1], off2 = p.level_col[2],
            off3 = p.level_col[3];
#pragma unroll (kF32 && !kI8 ? 4 : 8)
  for (int i = t; i < kRows * ch8; i += kConsumers) {
    const int r = i / ch8, col = (i - r * ch8) * 8;
    const int l = (col >= off1) + (col >= off2) + (col >= off3);
    const int C = p.channels[l];
    const int c0 = col - (l == 0 ? 0 : l == 1 ? off1 : l == 2 ? off2 : off3);
    const int row = cell[l * kRows + r];
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0 && kF32) {
      out = kI8 ? combine_i8<true>(static_cast<const int8_t*>(p.table[l]) +
                                       (size_t)row * 4 * C + c0,
                                   C, aux + r * aw + l * 4)
                : combine_f32(static_cast<const float*>(p.table[l]) +
                                  (size_t)row * 4 * C + c0,
                              C, aux + r * aw + l * 4);
    } else if (row >= 0 && kI8) {
      out = combine_i8<false>(static_cast<const int8_t*>(p.table[l]) +
                                  (size_t)row * 4 * C + c0,
                              C, aux + r * aw + l * 4);
    } else if (row >= 0) {
      const bf16* src =
          static_cast<const bf16*>(p.table[l]) + (size_t)row * 4 * C + c0;
      uint4 x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = ldg_row(src + k * C);
      __nv_bfloat162* acc = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bf16 w = aux[r * aw + l * 4 + k];
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
    put_chunk<kWide>(comb, gcomb, r, col, out);
  }
  fence_proxy_async();
  bar_sync(kGatherBar, kConsumers);
}

// K9's tile: rows m0 + r (r < n_live) of x (M, F_in) into comb as they
// are, and x2's three columns into aux's tanh columns (12-14: K9 has no
// levels). Rows past n_live, and comb's columns past F_in, get zeros.
// kWide: comb goes to gcomb, as in gather_tile. kF32: x and x2 are f32,
// rounded to bf16 here. An F_in that is not a multiple of 8 is read an
// element at a time.
template <bool kWide, bool kF32>
__device__ void load_rows(const CoreArgs& p, int m0, int n_live,
                          unsigned char* comb, uint32_t* gcomb, bf16* aux) {
  const int t = threadIdx.x;
  for (int i = t; i < kRows * 3; i += kConsumers) {
    const int r = i / 3, e = i - 3 * r;
    aux[r * p.aux_w + p.tanh_col + e] = r < n_live
                               ? load1<kF32>(p.x2, (size_t)(m0 + r) * 3 + e)
                               : __float2bfloat16(0.f);
  }
  const int ch8 = p.F / 8;
  if (p.F_in % 8 == 0) {  // F == F_in
#pragma unroll 8
    for (int i = t; i < kRows * ch8; i += kConsumers) {
      const int r = i / ch8, col = (i - r * ch8) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_live)
        val = load8<kF32, true>(p.x, (size_t)(m0 + r) * p.F + col);
      put_chunk<kWide>(comb, gcomb, r, col, val);
    }
  } else {
    for (int i = t; i < kRows * ch8; i += kConsumers) {
      const int r = i / ch8, col = (i - r * ch8) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_live)
        val = load_tail<kF32>(p.x, (size_t)(m0 + r) * p.F_in + col,
                              p.F_in - col);
      put_chunk<kWide>(comb, gcomb, r, col, val);
    }
  }
  fence_proxy_async();
  bar_sync(kGatherBar, kConsumers);
}

// Warpgroup w's part of one stream's fuse MLP on the tile in comb:
// acc[nt - g0] (64 x 96 f32 fragments) for O tiles [g0, g1) = the sum over
// the chunks c = c0, c0 + cstep, ... of bf16(h_c) @ W2[c, :], h_c =
// relu(comb @ W1[:F, c] + tanh terms + b1[c]) in registers. b2 is not added.
// kWide: layer 1 reads comb from gcomb as the register A operand.
template <bool kWide, typename V>
__device__ void stream_mlp(const CoreArgs& p, int c0, int cstep, int g0,
                           int g1, Ring& ring, uint32_t comb,
                           const uint32_t* gcomb, const bf16* aux,
                           const V* vsm, float (&acc)[kMaxOT][kNO / 2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int tq = 2 * (lane & 3);
  float th[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      th[h][j] = __bfloat162float(
          aux[(r0 + 8 * h) * p.aux_w + p.tanh_col + j]);
#pragma unroll
  for (int nt = 0; nt < kMaxOT; ++nt)
#pragma unroll
    for (int i = 0; i < kNO / 2; ++i) acc[nt][i] = 0.f;
  for (int c = c0; c < p.nch; c += cstep) {
    // a1 starts at b1 + sum_j tanh_j * W1[F+j] (f32); layer 1 then adds
    // comb @ W1[:F].
    float a1[kNC / 2];
#pragma unroll
    for (int j = 0; j < kNC / 8; ++j) {
      const int col = c * kNC + j * 8 + tq;
      float2 wq[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) wq[q] = lds2(vsm + q * p.ldv + col);
      const float2 b = lds2(vsm + p.v_b1 + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = e & 1 ? b.y : b.x;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          x = x + th[e >> 1][q] * (e & 1 ? wq[q].y : wq[q].x);
        a1[4 * j + e] = x;
      }
    }
    fence_regs(a1);
    for (int kb = 0; kb < p.nkbF; ++kb) {
      if (kWide) {
        uint32_t af[4][4];
        load_frags(gcomb, kb, af);
        const uint64_t db = wgmma_desc(ring.acquire());
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) wgmma_rs_n64(a1, af[ks], db + 2 * ks);
        wgmma_commit();
        ring.release();
      } else {
        const uint64_t db = wgmma_desc(ring.acquire());
        const uint64_t da = wgmma_desc(comb + kb * kKBlock);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss_n64(a1, da + 2 * ks, db + 2 * ks);
        wgmma_commit();
        ring.release();
      }
    }
    fence_regs(a1);

    // h_c = relu(a1), rounded to bf16 as the A operand of layer 2 (the
    // accumulator layout is the A layout).
    uint32_t hf[kNC / 16][4];
#pragma unroll
    for (int j = 0; j < kNC / 8; ++j) {
      hf[j >> 1][(j & 1) * 2 + 0] =
          pack_bf16(fmaxf(a1[4 * j], 0.f), fmaxf(a1[4 * j + 1], 0.f));
      hf[j >> 1][(j & 1) * 2 + 1] =
          pack_bf16(fmaxf(a1[4 * j + 2], 0.f), fmaxf(a1[4 * j + 3], 0.f));
    }
    fence_regs(hf);

#pragma unroll
    for (int nt = 0; nt < kMaxOT; ++nt) {
      if (g0 + nt < g1) {
        const uint64_t db = wgmma_desc(ring.acquire());
        fence_regs(acc[nt]);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_rs_n96(acc[nt], hf[ks], db + 2 * ks);
        wgmma_commit();
        ring.release();
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kMaxOT; ++nt) fence_regs(acc[nt]);
}

// Where k-block kb of the tile's [f_0 | f_1 | ...] rows lives.
__device__ __forceinline__ unsigned char* f_block(const CoreArgs& p,
                                                  unsigned char* fbuf,
                                                  unsigned char* comb,
                                                  int kb) {
  return kb < p.nkb_fbuf ? fbuf + kb * kKBlock
                         : comb + (kb - p.nkb_fbuf) * kKBlock;
}

template <int kMode>
struct Smem {
  unsigned char* comb;   // (64, F) tile; then the last stream's f rows
  unsigned char* fbuf;   // the other f rows
  uint32_t* gcomb;       // 'global': comb in device memory, fragment order
  uint32_t* gf;          // 'global', 'resident': all f rows there
  bf16* aux;             // (64, aux_w)
  int* cell;             // (level_slots, 64)
  const Vec<kMode>* vsm;
  float* rsm;            // K4's per-ray vectors (ray_tail)
};

// The local coordinates of the tile's rows m0 + r (r < n_live, else zeros)
// as the register A operand of one k-step (16 columns): words (row, cols
// tq, tq + 1) of rows r0 and r0 + 8, then of cols 8 + tq, 9 + tq (kF32:
// f32 coordinates, rounded to bf16).
template <bool kF32>
__device__ __forceinline__ void load_lc(const CoreArgs& p, int m0, int n_live,
                                        uint32_t (&la)[4]) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int tq = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    la[h] = la[2 + h] = 0u;
    if (row < n_live && kF32) {
      const float* src =
          static_cast<const float*>(p.lc) + (size_t)(m0 + row) * 16;
      const float2 lo = __ldg(reinterpret_cast<const float2*>(src + tq));
      const float2 hi = __ldg(reinterpret_cast<const float2*>(src + 8 + tq));
      la[h] = pack_bf16(lo.x, lo.y);
      la[2 + h] = pack_bf16(hi.x, hi.y);
    } else if (row < n_live) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          static_cast<const bf16*>(p.lc) + (size_t)(m0 + row) * 16);
      la[h] = __ldg(src + tq / 2);
      la[2 + h] = __ldg(src + 4 + tq / 2);
    }
  }
}

// A warpgroup's 16 -> K -> K query MLP of its tile (K4): layer 1 is one
// k-step from the local coordinates la on the K tiles of the ring's next
// stages, its sums starting at init(col) (f32 pairs), then relu and bf16;
// layer 2 by k-blocks of the next stages. Calls out(nt, av) with each K
// tile's f32 sums, the second bias not added.
template <typename Init, typename Out>
__device__ void query_mlp(const CoreArgs& p, Ring& ring,
                          const uint32_t (&la)[4], Init init, Out out) {
  const int tq = 2 * (threadIdx.x & 3);
  uint32_t hq[kMaxKT * 4][4];
#pragma unroll
  for (int nt = 0; nt < kMaxKT; ++nt) {
    float a[kNK / 2];
#pragma unroll
    for (int j = 0; j < kNK / 8; ++j) {
      const float2 b = nt < p.KT ? init(nt * kNK + j * 8 + tq)
                                 : make_float2(0.f, 0.f);
      a[4 * j] = a[4 * j + 2] = b.x;
      a[4 * j + 1] = a[4 * j + 3] = b.y;
    }
    if (nt < p.KT) {
      fence_regs(a);
      const uint64_t db = wgmma_desc(ring.acquire());
      wgmma_fence();
      wgmma_rs_n64(a, la, db);
      wgmma_commit();
      ring.release();
      fence_regs(a);
    }
#pragma unroll
    for (int j = 0; j < kNK / 8; ++j) {
      hq[nt * 4 + (j >> 1)][(j & 1) * 2 + 0] =
          pack_bf16(fmaxf(a[4 * j], 0.f), fmaxf(a[4 * j + 1], 0.f));
      hq[nt * 4 + (j >> 1)][(j & 1) * 2 + 1] =
          pack_bf16(fmaxf(a[4 * j + 2], 0.f), fmaxf(a[4 * j + 3], 0.f));
    }
  }
  fence_regs(hq);
#pragma unroll
  for (int nt = 0; nt < kMaxKT; ++nt) {
    if (nt < p.KT) {
      float av[kNK / 2];
#pragma unroll
      for (int i = 0; i < kNK / 2; ++i) av[i] = 0.f;
      fence_regs(av);
#pragma unroll
      for (int kb = 0; kb < kMaxKT; ++kb) {
        if (kb < p.nkbK) {
          const uint64_t db = wgmma_desc(ring.acquire());
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_rs_n64(av, hq[kb * 4 + ks], db + 2 * ks);
          wgmma_commit();
          ring.release();
        }
      }
      fence_regs(av);
      out(nt, av);
    }
  }
}

// sum over this thread's columns of bf16(q) . ce for its two rows, q =
// av + bias (one K tile's sums); ce (bf16) of the ray's joint rows j0 + row
// in K4's scratch. Rows past n_live add nothing.
template <typename V>
__device__ __forceinline__ void dot_ce(const CoreArgs& p, int nt,
                                       const float (&av)[kNK / 2],
                                       const V* bias, const bf16* ce, int j0,
                                       int n_live, float (&lg)[2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int tq = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < kNK / 8; ++j) {
      const int col = nt * kNK + j * 8 + tq;
      if (col < p.K && row < n_live) {
        const float2 b = lds2(bias + col);
        const float2 c = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                ce + (size_t)(j0 + row) * p.K + col));
        lg[h] += bf16_round(av[4 * j + 2 * h] + b.x) * c.x +
                 bf16_round(av[4 * j + 2 * h + 1] + b.y) * c.y;
      }
    }
  }
}

// The four lanes of a row hold its partial sums: logit[j0 + row] = their
// sum / 16, for the rows before n_live.
__device__ __forceinline__ void store_logits(float (&lg)[2], int j0,
                                             int n_live, float* logit) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lg[h] += __shfl_xor_sync(0xffffffffu, lg[h], 1);
    lg[h] += __shfl_xor_sync(0xffffffffu, lg[h], 2);
    if ((lane & 3) == 0 && r0 + 8 * h < n_live)
      logit[j0 + r0 + 8 * h] = lg[h] * kAttnScale;
  }
}

// One tile of warpgroup w: rows m0 + r, r < n_live. K4 (view: the tile's
// view; j0: the ray's joint index of row 0) keeps jl and ce in the block's
// scratch (scr_jl, scr_ce) and writes the tile's round-1 logits. kPlan:
// where comb (kWide: 'global') and the f rows (kFG) live. kF32: f32 inputs
// and outputs; kI8: int8 tables.
template <int kMode, int kPlan, bool kF32, bool kI8>
__device__ void run_tile(const CoreArgs& p, const Smem<kMode>& sm,
                         Ring& ring, int w, int m0, int n_live, int view,
                         int j0, bf16* scr_jl, bf16* scr_ce) {
  constexpr bool kWide = kPlan == kGlobal, kFG = kPlan != kSmem;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tw = threadIdx.x & (kWG - 1);
  const int r0 = (warp & 3) * 16 + (lane >> 2), tq = 2 * (lane & 3);
  const uint32_t comb_s = smem_u32(sm.comb);
  const bool f_in_comb = p.nkb_fbuf < p.nkbf;
  float acc[kMaxOT][kNO / 2];
  int t0, t1;
  mlp_tiles(p, w, t0, t1);
  for (int si = 0; si < p.S; ++si) {
    // K4 runs the stream of the tile's own view (slot 0) first.
    const int s = kMode == kRender ? (si == 0 ? view : 1 - view) : si;
    bar_sync(kGatherBar, kConsumers);  // comb and aux are free
    if (kMode == kMlp)
      load_rows<kWide, kF32>(p, m0, n_live, sm.comb, sm.gcomb, sm.aux);
    else
      gather_tile<kMode, kWide, kF32, kI8>(p, s, m0, n_live, sm.comb,
                                           sm.gcomb, sm.aux, sm.cell);
    for (int g0 = t0; g0 < t1; g0 += kMaxOT) {
      const int g1 = min(g0 + kMaxOT, t1);
      stream_mlp<kWide>(p, p.osplit ? 0 : w ^ (si & 1), p.osplit ? 1 : 2, g0,
                        g1, ring, comb_s, sm.gcomb, sm.aux, sm.vsm, acc);
      if (!p.osplit) {
        // f = WG 0's partial sums + WG 1's + b2: WG 1 hands its f32 sums
        // to WG 0 through the first 8 KB of comb, 16 columns a thread at a
        // time (thread tw of both warpgroups holds the same fragment
        // positions). WG 0 zeroes each value it takes, so that no f32 bits
        // stay behind: read as bf16 they can be Inf or NaN, and k-block
        // 0's columns past F (F < 64) or past S*O (the last stream's f rows
        // ending there) are read again by products whose weights are zero
        // there. ('global': the first 8 KB of shared memory for tiles,
        // which no product reads.)
        bar_sync(kPairBar, kConsumers);  // comb is no longer read
        float4* xbuf = reinterpret_cast<float4*>(sm.comb);  // (4, 128)
#pragma unroll
        for (int nt = 0; nt < kMaxOT; ++nt)
#pragma unroll
          for (int jq = 0; jq < kNO / 32; ++jq) {
            if (nt < p.OT) {
              if (w == 1)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float* a = &acc[nt][16 * jq + 4 * q];
                  xbuf[q * kWG + tw] = make_float4(a[0], a[1], a[2], a[3]);
                }
              bar_sync(kPairBar, kConsumers);
              if (w == 0)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const float4 v = xbuf[q * kWG + tw];
                  xbuf[q * kWG + tw] = make_float4(0.f, 0.f, 0.f, 0.f);
                  float* a = &acc[nt][16 * jq + 4 * q];
                  a[0] += v.x;
                  a[1] += v.y;
                  a[2] += v.z;
                  a[3] += v.w;
                }
              bar_sync(kPairBar, kConsumers);
            }
          }
      } else if (f_in_comb) {
        // Each warpgroup has one group; the last stream's f goes into comb,
        // which neither may read any more.
        bar_sync(kPairBar, kConsumers);
      }
      if (p.osplit || w == 0) {
        // f_s + b2 in bf16: to the output (K9), or to the tile's f rows,
        // slot by view or stream.
        const Vec<kMode>* b2 = sm.vsm + p.v_b2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          int slot = kMode == kRender ? si : s;
          if (kMode == kPair) slot = (((m0 + row) / p.rp) & 1) == s ? 0 : 1;
#pragma unroll
          for (int nt = 0; nt < kMaxOT; ++nt)
#pragma unroll
            for (int j = 0; j < kNO / 8; ++j) {
              const int col = (g0 + nt) * kNO + j * 8 + tq;
              if (g0 + nt < g1 && col < p.O) {
                const float2 b = lds2(b2 + col);
                const float f0 = acc[nt][4 * j + 2 * h] + b.x,
                            f1 = acc[nt][4 * j + 2 * h + 1] + b.y;
                const uint32_t v = pack_bf16(f0, f1);
                if (kMode == kMlp) {
                  if (row < n_live)
                    store_cols<kF32, kOddOutput>(
                        p.jl, (size_t)(m0 + row) * p.O_out, col, p.O_out, f0,
                        f1);
                } else if (kFG) {
                  __stcg(sm.gf + frag_word(row, slot * p.O + col), v);
                } else {
                  const int fc = slot * p.O + col;
                  *reinterpret_cast<uint32_t*>(
                      f_block(p, sm.fbuf, sm.comb, fc >> 6) +
                      swizzle(row, fc & 63)) = v;
                }
              }
            }
        }
      }
    }
  }
  if (kMode == kMlp) return;
  fence_proxy_async();
  bar_sync(kPairBar, kConsumers);  // the f rows are complete

  // jl = [f_0 | ...] @ lv + lvb, WG 0 on O tiles [0, jl_split), WG 1 on
  // the rest, up to kMaxOT at a time
  const int ja = w == 0 ? 0 : p.jl_split, je = w == 0 ? p.jl_split : p.OT;
  for (int g0 = ja; g0 < je; g0 += kMaxOT) {
    const int g1 = min(g0 + kMaxOT, je);
#pragma unroll
    for (int nt = 0; nt < kMaxOT; ++nt)
#pragma unroll
      for (int i = 0; i < kNO / 2; ++i) acc[nt][i] = 0.f;
    if (kFG)
      frag_products(sm.gf, p.nkbf, [&](const uint32_t(&af)[4][4]) {
#pragma unroll
        for (int nt = 0; nt < kMaxOT; ++nt) {
          if (g0 + nt < g1) {
            const uint64_t db = wgmma_desc(ring.acquire());
            fence_regs(acc[nt]);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_rs_n96(acc[nt], af[ks], db + 2 * ks);
            wgmma_commit();
            ring.release();
          }
        }
      });
    for (int kb = 0; kb < (kFG ? 0 : p.nkbf); ++kb) {
      const uint64_t da =
          wgmma_desc(smem_u32(f_block(p, sm.fbuf, sm.comb, kb)));
#pragma unroll
      for (int nt = 0; nt < kMaxOT; ++nt) {
        if (g0 + nt < g1) {
          const uint64_t db = wgmma_desc(ring.acquire());
          fence_regs(acc[nt]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n96(acc[nt], da + 2 * ks, db + 2 * ks);
          wgmma_commit();
          ring.release();
        }
      }
    }
    // K4 keeps all O columns in its scratch (those past O_out are zeros,
    // which the per-ray sums read); K2 and K3 write the O_out of jl.
    const Vec<kMode>* lvb = sm.vsm + p.v_lvb;
    const int n_jl = kMode == kRender ? p.O : p.O_out;
#pragma unroll
    for (int nt = 0; nt < kMaxOT; ++nt) {
      fence_regs(acc[nt]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        const size_t dst = (size_t)((kMode == kRender ? j0 : m0) + row) * n_jl;
#pragma unroll
        for (int j = 0; j < kNO / 8; ++j) {
          const int col = (g0 + nt) * kNO + j * 8 + tq;
          if (g0 + nt < g1 && col < n_jl && row < n_live) {
            const float2 b = lds2(lvb + col);
            const float x0 = acc[nt][4 * j + 2 * h] + b.x,
                        x1 = acc[nt][4 * j + 2 * h + 1] + b.y;
            if (kMode == kRender)
              *reinterpret_cast<uint32_t*>(scr_jl + dst + col) =
                  pack_bf16(x0, x1);
            else
              store_cols<kF32, kOddOutput>(p.jl, dst, col, n_jl, x0, x1);
          }
        }
      }
    }
  }
  if (w == 1) {
    // kh = relu([f_0 | ...] @ km + kmb), bf16 in registers
    float ak[kMaxKT][kNK / 2];
#pragma unroll
    for (int nt = 0; nt < kMaxKT; ++nt)
#pragma unroll
      for (int i = 0; i < kNK / 2; ++i) ak[nt][i] = 0.f;
    if (kFG)
      frag_products(sm.gf, p.nkbf, [&](const uint32_t(&af)[4][4]) {
#pragma unroll
        for (int nt = 0; nt < kMaxKT; ++nt) {
          if (nt < p.KT) {
            const uint64_t db = wgmma_desc(ring.acquire());
            fence_regs(ak[nt]);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_rs_n64(ak[nt], af[ks], db + 2 * ks);
            wgmma_commit();
            ring.release();
          }
        }
      });
    for (int kb = 0; kb < (kFG ? 0 : p.nkbf); ++kb) {
      const uint64_t da =
          wgmma_desc(smem_u32(f_block(p, sm.fbuf, sm.comb, kb)));
#pragma unroll
      for (int nt = 0; nt < kMaxKT; ++nt) {
        if (nt < p.KT) {
          const uint64_t db = wgmma_desc(ring.acquire());
          fence_regs(ak[nt]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            wgmma_ss_n64(ak[nt], da + 2 * ks, db + 2 * ks);
          wgmma_commit();
          ring.release();
        }
      }
    }
    const Vec<kMode>* kmb = sm.vsm + p.v_kmb;
    uint32_t kf[kMaxKT * 4][4];
#pragma unroll
    for (int nt = 0; nt < kMaxKT; ++nt) {
      fence_regs(ak[nt]);
#pragma unroll
      for (int j = 0; j < kNK / 8; ++j) {
        const int col = nt * kNK + j * 8 + tq;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (nt < p.KT) {
          const float2 b = lds2(kmb + col);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = fmaxf(ak[nt][4 * j + e] + (e & 1 ? b.y : b.x), 0.f);
        }
        kf[nt * 4 + (j >> 1)][(j & 1) * 2 + 0] = pack_bf16(v[0], v[1]);
        kf[nt * 4 + (j >> 1)][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
      }
    }
    fence_regs(kf);

    // kv = kh @ k2 + k2b, one 64-column tile at a time; K4 takes the
    // round-1 logits bf16(kv) . ce in place of writing it
    const Vec<kMode>* k2b = sm.vsm + p.v_k2b;
    float lg[2] = {0.f, 0.f};
    if (kMode == kRender) bar_sync(kCeBar, kConsumers);  // ce is stored
#pragma unroll
    for (int nt = 0; nt < kMaxKT; ++nt) {
      if (nt < p.KT) {
        float av[kNK / 2];
#pragma unroll
        for (int i = 0; i < kNK / 2; ++i) av[i] = 0.f;
        fence_regs(av);
#pragma unroll
        for (int kb = 0; kb < kMaxKT; ++kb) {
          if (kb < p.nkbK) {
            const uint64_t db = wgmma_desc(ring.acquire());
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              wgmma_rs_n64(av, kf[kb * 4 + ks], db + 2 * ks);
            wgmma_commit();
            ring.release();
          }
        }
        fence_regs(av);
        if (kMode == kRender) {
          dot_ce(p, nt, av, k2b, scr_ce, j0, n_live, lg);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
#pragma unroll
            for (int j = 0; j < kNK / 8; ++j) {
              const int col = nt * kNK + j * 8 + tq;
              if (col < p.K && row < n_live) {
                const float2 b = lds2(k2b + col);
                store2<kF32>(p.kv, (size_t)(m0 + row) * p.K + col,
                             av[4 * j + 2 * h] + b.x,
                             av[4 * j + 2 * h + 1] + b.y);
              }
            }
          }
        }
      }
    }
    if (kMode == kRender) store_logits(lg, j0, n_live, sm.rsm);
  } else if (kMode == kRender) {
    // ce = bf16(relu(lc @ qe1 + qe1b)) @ qe2 + qe2b, bf16 to the scratch
    uint32_t la[4];
    load_lc<kF32>(p, m0, n_live, la);
    const Vec<kMode>* qe1b = sm.vsm + p.v_q;
    const Vec<kMode>* qe2b = qe1b + p.KT * kNK;
    query_mlp(
        p, ring, la, [&](int col) { return lds2(qe1b + col); },
        [&](int nt, const float (&av)[kNK / 2]) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
#pragma unroll
            for (int j = 0; j < kNK / 8; ++j) {
              const int col = nt * kNK + j * 8 + tq;
              if (col < p.K && row < n_live) {
                const float2 b = lds2(qe2b + col);
                *reinterpret_cast<uint32_t*>(
                    scr_ce + (size_t)(j0 + row) * p.K + col) =
                    pack_bf16(av[4 * j + 2 * h] + b.x,
                              av[4 * j + 2 * h + 1] + b.y);
              }
            }
          }
        });
    bar_arrive(kCeBar, kConsumers);
  }
}

// Sum (or max) of x over the kConsumers threads; every one gets it.
template <bool kMax>
__device__ float consumers_reduce(float x, float* red8) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  if (lane == 0) red8[warp] = x;
  bar_sync(kPairBar, kConsumers);
  float y = red8[0];
#pragma unroll
  for (int i = 1; i < kConsumers / 32; ++i)
    y = kMax ? fmaxf(y, red8[i]) : y + red8[i];
  bar_sync(kPairBar, kConsumers);
  return y;
}

// Joint softmax of x[0:n] in f32, in place, each weight rounded to bf16
// (the value type, as the attention sums it) unless kF32.
template <bool kF32>
__device__ void softmax(float* x, int n, float* red8) {
  const int t = threadIdx.x;
  float m = -INFINITY;
  for (int j = t; j < n; j += kConsumers) m = fmaxf(m, x[j]);
  m = consumers_reduce<true>(m, red8);
  float den = 0.f;
  for (int j = t; j < n; j += kConsumers) {
    const float e = expf(x[j] - m);
    x[j] = e;
    den += e;
  }
  den = consumers_reduce<false>(den, red8);
  for (int j = t; j < n; j += kConsumers)
    x[j] = kF32 ? x[j] / den : bf16_round(x[j] / den);
  bar_sync(kPairBar, kConsumers);
}

// out[c] = sum_j wgt[j] * src[j][c] (f32) for c < O, src (n, O) bf16: warp
// q sums the rows j = q (mod 8), each lane 8 columns at a time (16-byte
// loads), into red (8, ldr); then one thread a column adds the 8 partial
// sums.
__device__ void weighted_sum(const bf16* src, const float* wgt, int n, int O,
                             float* red, int ldr, float* out) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int ch = lane; ch < O / 8; ch += 32) {
    float a[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) a[e] = 0.f;
    for (int j = warp; j < n; j += kConsumers / 32) {
      const uint4 v =
          *reinterpret_cast<const uint4*>(src + (size_t)j * O + ch * 8);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float wj = wgt[j];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(x[e]);
        a[2 * e] += wj * f.x;
        a[2 * e + 1] += wj * f.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) red[warp * ldr + ch * 8 + e] = a[e];
  }
  bar_sync(kPairBar, kConsumers);
  for (int c = t; c < O; c += kConsumers) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kConsumers / 32; ++q) s += red[q * ldr + c];
    out[c] = s;
  }
  bar_sync(kPairBar, kConsumers);
}

// fin(c, sum_i x_i * W[i][c]) for c < n_pad (the sum 0 past K), W (n_in,
// K) bf16, x in shared memory (rounded to bf16 first with round_x): warp q
// sums the rows i = q (mod 8), each lane 4 columns at a time, into red
// (8, ldr); then one thread a column adds the 8 partial sums.
template <typename Fin>
__device__ void vecmat(const float* x, bool round_x, const bf16* W, int n_in,
                       int K, int n_pad, float* red, int ldr, Fin fin) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int c4 = lane; c4 < K / 4; c4 += 32) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i = warp; i < n_in; i += kConsumers / 32) {
      const float xi = round_x ? bf16_round(x[i]) : x[i];
      const uint2 v =
          __ldg(reinterpret_cast<const uint2*>(W + (size_t)i * K + c4 * 4));
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v.y));
      a[0] += xi * lo.x;
      a[1] += xi * lo.y;
      a[2] += xi * hi.x;
      a[3] += xi * hi.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp * ldr + c4 * 4 + e] = a[e];
  }
  bar_sync(kPairBar, kConsumers);
  for (int c = t; c < n_pad; c += kConsumers) {
    float s = 0.f;
    if (c < K)
#pragma unroll
      for (int q = 0; q < kConsumers / 32; ++q) s += red[q * ldr + c];
    fin(c, s);
  }
  bar_sync(kPairBar, kConsumers);
}

// K4's end of a ray (b, r) = (unit / R, unit % R), once its tiles have
// written their jl and ce rows and round-1 logits: the joint softmax over
// the 2P samples, at_wt = bf16(w), z1 = sum_j bf16(w_j) jl_j (f32). With
// repeat: ze = bf16(bf16(z1) @ el + elb) and u = ze @ qr1[:K] + qr1b (the
// z_embed half of the repeat-query MLP, the same for every sample of the
// ray, so computed once), then per tile (warpgroup w taking every other)
// q2 = bf16(relu(lc @ qr1[K:] + u)) @ qr2 + qr2b and the round-2 logits
// bf16(q2) . ce / 16, the softmax, z2 = sum_j bf16(w2_j) jl_j and
// z = bf16(z2 + 2 z1). The per-ray sums are warp-parallel reductions into
// comb and fbuf, which the next tile overwrites, and which are zeroed
// after. kF32: f32 weights (not rounded), z and at_wt.
template <int kMode, bool kF32>
__device__ void ray_tail(const CoreArgs& p, const Smem<kMode>& sm,
                         Ring& ring, int w, int unit, const bf16* scr_jl,
                         const bf16* scr_ce) {
  const int b = unit / p.R, r = unit - b * p.R, n = 2 * p.P;
  const int t = threadIdx.x;
  const int Op = p.OT * kNO, Kp = p.KT * kNK, ldr = max(Op, Kp);
  float* logit = sm.rsm;
  float* z1 = logit + ((n + 3) & ~3);
  float* z2 = z1 + Op;
  float* ze = z2 + Op;
  float* u = ze + Kp;
  float* red8 = u + Kp;
  float* red = reinterpret_cast<float*>(sm.comb);
  bar_sync(kPairBar, kConsumers);  // the ray's logits, jl and ce are there
  softmax<kF32>(logit, n, red8);
  for (int j = t; j < n; j += kConsumers) {
    const int v = j >= p.P;
    store1<kF32>(p.wt, ((size_t)(b * 2 + v) * p.R + r) * p.P + (j - v * p.P),
                 logit[j]);
  }
  weighted_sum(scr_jl, logit, n, p.O, red, ldr, z1);
  const size_t z_out = (size_t)unit * p.O_out;
  if (!p.repeat) {
    for (int c = t; c < p.O_out; c += kConsumers)
      store1<kF32>(p.z, z_out + c, z1[c]);
  } else {
    const Vec<kMode>* elb = sm.vsm + p.v_q + 2 * Kp;
    const Vec<kMode>* qr1b = elb + Kp;
    const Vec<kMode>* qr2b = qr1b + Kp;
    vecmat(z1, true, p.mats, p.O, p.K, Kp, red, ldr, [&](int c, float s) {
      ze[c] = bf16_round(s + float(elb[c]));
    });
    vecmat(ze, false, p.mats + (size_t)p.O * p.K, p.K, p.K, Kp, red, ldr,
           [&](int c, float s) { u[c] = s + float(qr1b[c]); });
    for (int k = w; k < 2 * p.tv; k += 2) {
      const int v = k / p.tv, sub = k - v * p.tv;
      const int m0 = ((b * 2 + v) * p.R + r) * p.P + sub * kRows;
      const int n_live = min(kRows, p.P - sub * kRows);
      const int j0 = v * p.P + sub * kRows;
      uint32_t la[4];
      load_lc<kF32>(p, m0, n_live, la);
      float lg[2] = {0.f, 0.f};
      query_mlp(
          p, ring, la, [&](int col) { return make_float2(u[col], u[col + 1]); },
          [&](int nt, const float (&av)[kNK / 2]) {
            dot_ce(p, nt, av, qr2b, scr_ce, j0, n_live, lg);
          });
      store_logits(lg, j0, n_live, logit);
    }
    bar_sync(kPairBar, kConsumers);  // the round-2 logits are there
    softmax<kF32>(logit, n, red8);
    weighted_sum(scr_jl, logit, n, p.O, red, ldr, z2);
    for (int c = t; c < p.O_out; c += kConsumers)
      store1<kF32>(p.z, z_out + c, z2[c] + 2.f * z1[c]);
  }
  // Padding columns of comb and the f rows are read again by products with
  // zero weights, so they must not keep f32 bits.
  for (int i = t * 4; i < 8 * ldr; i += kConsumers * 4)
    *reinterpret_cast<float4*>(red + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  fence_proxy_async();
}

template <int kMode, int kPlan, bool kF32, bool kI8>
__global__ void __launch_bounds__(kThreads, 1)
    exchange_core_kernel(const CoreArgs p) {
  using V = Vec<kMode>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* slots = base;
  Smem<kMode> sm;
  sm.comb = slots + p.n_stages * kLargeStage;
  sm.fbuf = sm.comb + p.nkbF * kKBlock;
  sm.aux = reinterpret_cast<bf16*>(sm.comb + p.nkb_tiles * kKBlock);
  sm.cell = reinterpret_cast<int*>(sm.aux + kRows * p.aux_w);
  V* vsm = reinterpret_cast<V*>(sm.cell + kRows * p.level_slots);
  sm.vsm = vsm;
  sm.rsm = reinterpret_cast<float*>(vsm + p.n_vecs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm.rsm + p.n_rsm);
  const uint32_t full = smem_u32(bars), empty = full + 8 * p.n_stages;
  unsigned char* scr = p.scratch + (size_t)blockIdx.x * p.scr_stride;
  sm.gcomb = reinterpret_cast<uint32_t*>(scr + p.scr_wide0);
  sm.gf = sm.gcomb + (kPlan == kGlobal ? (size_t)p.nkbF * kFragWords : 0);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < p.n_stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 4);  // each warp of the consumer warpgroup
    }
    fence_mbar_init();
  }
  // Every product runs all four k-steps of every k-block: the weight stages
  // are zero past each depth, so the tiles' columns past F and S*O only
  // need to hold finite values (0 * Inf is NaN). Zero them once; later they
  // hold only combined rows, f values or zeros (the partial-sum exchange
  // through k-block 0 and K4's per-ray sums leave zeros behind).
  for (int i = threadIdx.x * 16; i < p.nkb_tiles * kKBlock;
       i += kThreads * 16)
    *reinterpret_cast<uint4*>(sm.comb + i) = make_uint4(0u, 0u, 0u, 0u);
  if (kPlan != kSmem)  // the same for the block's tiles in device memory
    for (int i = threadIdx.x;
         i < ((kPlan == kGlobal ? p.nkbF : 0) + p.nkbf) * kKBlock / 16;
         i += kThreads)
      __stcg(reinterpret_cast<uint4*>(sm.gcomb) + i,
             make_uint4(0u, 0u, 0u, 0u));
  // The vectors, out of reach of L1's misses: every chunk's first step
  // reads W1[F:F+3] and b1.
  for (int i = threadIdx.x; i < p.n_vecs; i += kThreads)
    vsm[i] = V(p.vecs[i]);
  fence_proxy_async();
  __syncthreads();

  // Three warpgroups start at 168 registers a thread; the producer's (one
  // warp works, three wait) gives its share to the consumers, 232 each.
  if (warp >= kProducerWarp) {
    reg_dealloc<40>();
    if (warp == kProducerWarp && lane < 2)
      produce<kMode>(p, lane, smem_u32(slots), full, empty);
  } else {
    reg_alloc<232>();
    const int w = warp >> 2;
    const int nh = p.n_stages / 2;
    Ring ring{smem_u32(slots) + w * nh * kLargeStage, full + 8 * w * nh,
              empty + 8 * w * nh, nh, 0, 0u};
    bf16* scr_jl = nullptr;
    bf16* scr_ce = nullptr;
    if (kMode == kRender) {
      scr_jl = reinterpret_cast<bf16*>(scr);
      scr_ce = scr_jl + (size_t)2 * p.P * p.O;
    }
    for (int unit = blockIdx.x; unit < p.n_units; unit += gridDim.x) {
      if (kMode == kRender) {
        const int b = unit / p.R, r = unit - b * p.R;
        for (int k = 0; k < 2 * p.tv; ++k) {
          const int v = k / p.tv, sub = k - v * p.tv;
          run_tile<kMode, kPlan, kF32, kI8>(
              p, sm, ring, w, ((b * 2 + v) * p.R + r) * p.P + sub * kRows,
              min(kRows, p.P - sub * kRows), v, v * p.P + sub * kRows,
              scr_jl, scr_ce);
        }
        ray_tail<kMode, kF32>(p, sm, ring, w, unit, scr_jl, scr_ce);
      } else {
        const int m0 = unit * kRows;
        run_tile<kMode, kPlan, kF32, kI8>(p, sm, ring, w, m0,
                                          min(kRows, p.M - m0), 0, 0,
                                          nullptr, nullptr);
      }
    }
  }
}

// ---- host side --------------------------------------------------------

// The level fields of `a` from the C interface's pointers. Returns a
// cudaError_t code; F receives the levels' channel sum.
inline int fill_levels(CoreArgs& a, int n_levels, void* const* tables,
                       void* const* cells, const int* channels, int* F) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  *F = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    const bool used = l < n_levels;
    a.table[l] = used ? tables[l] : nullptr;
    a.cells[l] = used ? static_cast<const int32_t*>(cells[l]) : nullptr;
    a.channels[l] = used ? channels[l] : 0;
    if (used && (channels[l] <= 0 || channels[l] % 8 != 0))
      return (int)cudaErrorInvalidValue;
    a.level_col[l] = *F;
    *F += a.channels[l];
  }
  a.level_col[kMaxLevels] = *F;
  a.n_levels = n_levels;
  return 0;
}

// Checks the sizes the kernel relies on and derives its tile counts, stage
// and vector offsets. S: streams (1 for kMlp); K ignored by kMlp; B, R, P
// and repeat only read by kRender. Returns a cudaError_t code.
//
// Widths. F is comb's width: the levels' channel sum (each a multiple of
// 8, fill_levels), or K9's input width F_in, which comb rounds up to 8. O
// is the output width O_out; the f rows of K2, K3 and K4 are O wide where
// they tile (O % 8 == 0 and S * O % 16 == 0), else O rounded up to 16, the
// weights laid out for that width with zeros past O_out (ops/
// gather_epilogue.py core_out_width, pad_exchange_weights). H1 and the
// weight stages' widths are rounded up to whole tiles with zeros already,
// so any H1 is taken. Every extra column is zero, and so adds nothing.
inline int fill_sizes(CoreArgs& a, int mode, int S, int M, int F, int H1,
                      int O, int K, long long stage_bytes, int B, int R,
                      int P, int repeat) {
  const bool mlp = mode == kMlp, render = mode == kRender;
  if (M <= 0 || F <= 0 || H1 <= 0 || O <= 0 || (!mlp && F % 8) ||
      (mlp ? S != 1 : mode == kPair ? S != 2 : S < 2))
    return (int)cudaErrorInvalidValue;
  // an odd O_out takes the CORE_ODD_OUTPUT build (K2, K3, K9), and only
  // it (see kOddOutput)
  if (!render && (O & 1) != (kOddOutput ? 1 : 0))
    return (int)cudaErrorInvalidValue;
  a.F_in = F;
  a.O_out = O;
  F = (F + 7) / 8 * 8;
  if (!mlp && (O % 8 || (S * O) % 16)) O = (O + 15) / 16 * 16;
  if (!mlp && (K <= 0 || K % 16 || K > kMaxKT * kNK))
    return (int)cudaErrorInvalidValue;
  if (render && (S != 2 || B <= 0 || R <= 0 || P <= 0 ||
                 (long long)B * 2 * R * P != M))
    return (int)cudaErrorInvalidValue;
  // The aux layout (K9, which calls no fill_levels, has n_levels 0).
  a.level_slots = a.n_levels > 3 ? a.n_levels : 3;
  a.tanh_col = 4 * a.level_slots;
  a.aux_w = (a.tanh_col + 3 + 7) / 8 * 8;
  a.S = S;
  a.M = M;
  a.F = F;
  a.H1 = H1;
  a.O = O;
  a.K = mlp ? 0 : K;
  a.B = B;
  a.R = R;
  a.P = P;
  a.repeat = repeat;
  const auto cdiv = [](int x, int y) { return (x + y - 1) / y; };
  a.nch = cdiv(H1, kNC);
  a.nkbF = cdiv(F, 64);
  a.OT = cdiv(O, kNO);
  a.osplit = a.OT > kMaxOT;
  a.KT = cdiv(a.K, kNK);
  a.nkbf = mlp ? 0 : cdiv(S * O, 64);
  a.nkbK = a.KT;
  a.chunk_bytes = a.nkbF * kSmallStage + a.OT * kLargeStage;
  a.jl_split = a.OT - a.OT / 2;
  a.jl0 = (long long)a.nch * a.chunk_bytes;
  a.kh0 = a.jl0 + (long long)a.nkbf * a.OT * kLargeStage;
  a.kv0 = a.kh0 + (long long)a.nkbf * a.KT * kSmallStage;
  a.qe0 = a.kv0 + (long long)a.KT * a.nkbK * kSmallStage;
  a.qe20 = a.qe0 + (long long)a.KT * kSmallStage;
  a.qr0 = a.qe20 + (long long)a.KT * a.nkbK * kSmallStage;
  a.qr20 = a.qr0 + (long long)a.KT * kSmallStage;
  const long long total =
      mlp ? a.jl0
          : !render ? a.qe0
                    : repeat ? a.qr20 + (long long)a.KT * a.nkbK * kSmallStage
                             : a.qr0;
  if (stage_bytes != total) return (int)cudaErrorInvalidValue;
  a.ldv = a.nch * kNC;
  a.v_b1 = 3 * a.ldv;
  a.v_b2 = a.v_b1 + a.ldv;
  a.v_lvb = a.v_b2 + a.OT * kNO;
  a.v_kmb = a.v_lvb + a.OT * kNO;
  a.v_k2b = a.v_kmb + a.KT * kNK;
  a.v_q = a.v_k2b + a.KT * kNK;
  a.n_vecs = mlp ? a.v_lvb : render ? a.v_q + 5 * a.KT * kNK : a.v_q;
  a.tv = render ? cdiv(P, kRows) : 0;
  a.n_units = render ? B * R : cdiv(M, kRows);
  a.n_rsm = render ? ((2 * P + 3) & ~3) + 2 * a.OT * kNO + 2 * a.KT * kNK +
                         32
                   : 0;
  a.n_stages = 0;
  a.nkb_fbuf = 0;
  return 0;
}

// Launches the kernel on `stream`: one block per SM (or per unit, if
// fewer), as many stage slots as the shared memory holds (up to
// kMaxStages), split between the two rings, clusters of one block. The
// first plan whose tiles fit beside kMinStages slots (K9: two): 'smem',
// else 'resident' (not K9, whose tiles are comb alone), else 'global'. The
// scratch (scratch_bytes at a.scratch) must hold grid blocks of scr_stride
// bytes: K4's 2P * (O + K) * 2, plus with the 'resident' plan nkbf * 8 KB,
// with the 'global' one (nkbF + nkbf) * 8 KB. info receives the launch's
// (grid, stage slots, shared bytes, threads a block, cluster x, y, z,
// plan: 0 'smem', 1 'global', 2 'resident'). kF32: the f32 instantiation
// (f32 inputs and outputs, the same shared memory); kI8: int8 tables (K2,
// K3, K4).
template <int kMode, bool kF32, bool kI8 = false>
int launch_core(CoreArgs& a, int* info, void* stream,
                long long scratch_bytes) {
  int device = 0, optin = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  // K4's per-ray sums take (8, max(O, K) padded) f32 of the tiles' space.
  const size_t red = kMode == kRender ? (size_t)8 * 4 *
                         (a.OT * kNO > a.KT * kNK ? a.OT * kNO : a.KT * kNK)
                                      : 0;
  const int nkb_red = (int)((red + kKBlock - 1) / kKBlock);
  const size_t common = 1024 + (size_t)kRows * a.aux_w * sizeof(bf16) +
                        (size_t)kRows * a.level_slots * sizeof(int) +
                        a.n_vecs * sizeof(Vec<kMode>) +
                        a.n_rsm * sizeof(float) + 16 * kMaxStages;
  // k-blocks of tiles that fit beside the least slots a plan takes, and
  // hold K4's sums
  const size_t min_slots = kMode == kMlp ? 2 : kMinStages;
  const auto fits = [&](int nkb) {
    return nkb >= nkb_red && (size_t)optin >= common +
                                 (size_t)nkb * kKBlock +
                                 min_slots * kLargeStage;
  };
  // The 'smem' plan. The last stream's f goes into the comb tile where the
  // slot order is the same for every row of a tile and, above O = 288,
  // each warpgroup has one group of O tiles (both then finish reading comb
  // first).
  a.plan = kSmem;
  a.nkb_fbuf = a.nkbf;
  if ((kMode == kStreams || kMode == kRender) && a.OT <= 2 * kMaxOT) {
    a.nkb_fbuf = ((a.S - 1) * a.O + 63) / 64;
    if (a.nkbf - a.nkb_fbuf > a.nkbF) a.nkb_fbuf = a.nkbf;
  }
  a.nkb_tiles = a.nkbF + a.nkb_fbuf;
  if (!fits(a.nkb_tiles)) {
    // 'resident': comb (or K4's per-ray sums, if larger) in shared memory,
    // and nothing else; the f rows in the scratch
    a.plan = kResident;
    a.nkb_fbuf = a.nkbf;
    a.nkb_tiles = a.nkbF > nkb_red ? a.nkbF : nkb_red;
  }
  if (a.plan == kResident && (kMode == kMlp || !fits(a.nkb_tiles))) {
    // 'global': shared memory keeps one k-block (the partial-sum
    // exchange), or K4's per-ray sums
    a.plan = kGlobal;
    a.nkb_tiles = nkb_red > 1 ? nkb_red : 1;
  }
  const size_t fixed = common + (size_t)a.nkb_tiles * kKBlock;
  if ((size_t)optin < fixed + 2 * kLargeStage)
    return (int)cudaErrorInvalidValue;
  a.n_stages = (int)((optin - fixed) / kLargeStage) & ~1;
  if (a.n_stages > kMaxStages) a.n_stages = kMaxStages;
  const size_t smem = fixed + (size_t)a.n_stages * kLargeStage;
  const int grid = a.n_units < n_sm ? a.n_units : n_sm;
  a.scr_wide0 = kMode == kRender ? (long long)2 * a.P * (a.O + a.K) * 2 : 0;
  const int nkb_dev = a.plan == kGlobal     ? a.nkbF + a.nkbf
                      : a.plan == kResident ? a.nkbf
                                            : 0;
  a.scr_stride = a.scr_wide0 + (long long)nkb_dev * kKBlock;
  if (scratch_bytes < (long long)grid * a.scr_stride)
    return (int)cudaErrorInvalidValue;
  static_assert(!(kI8 && kMode == kMlp), "K9 reads no table");
  auto kernel = exchange_core_kernel<kMode, kSmem, kF32, kI8>;
  if (a.plan == kGlobal)
    kernel = exchange_core_kernel<kMode, kGlobal, kF32, kI8>;
  if constexpr (kMode != kMlp)  // K9 has no 'resident' instantiation
    if (a.plan == kResident)
      kernel = exchange_core_kernel<kMode, kResident, kF32, kI8>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  // Sharing each stage across a cluster by multicast measured slower.
  cudaLaunchAttribute cluster = {};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = cluster.val.clusterDim.y =
      cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const int launched = (int)cudaLaunchKernelEx(&cfg, kernel, a);
  if (info) {
    info[0] = (int)cfg.gridDim.x;
    info[1] = a.n_stages;
    info[2] = (int)smem;
    info[3] = (int)cfg.blockDim.x;
    info[4] = (int)cluster.val.clusterDim.x;
    info[5] = (int)cluster.val.clusterDim.y;
    info[6] = (int)cluster.val.clusterDim.z;
    info[7] = a.plan;
  }
  return launched ? launched : (int)cudaGetLastError();
}

}  // namespace exchange_core
