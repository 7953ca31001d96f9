// The exchange epilogue core for Hopper (sm_90a): one persistent kernel for
// the V=2 epilogue (gather_epilogue.cu, with the view swap) and the S-stream
// epilogue (gather_epilogue_multi.cu). For a tile of 64 samples it computes,
// per stream s,
//
//   comb = sum_k w_k * row[k*C:(k+1)*C] per pyramid level    (bf16, corner
//          order, as the TPU kernels' combine runs in the table type)
//   h    = relu(comb @ W1[:F] + sum_j tanh_j * W1[F+j] + b1) (f32 sum)
//   f_s  = bf16(h) @ W2 + b2                                 (f32 sum)
//
// and places bf16(f_s) in slot s of the sample's [f_0 | f_1 | ...] row; with
// kViewSwap (V=2) the slot is 0 for the stream of the sample's own view id
// (m // rp) % 2 and 1 for the other. Then
//
//   jl = [f_0 | ... | f_{S-1}] @ lv + lvb
//   kv = bf16(relu([f_0 | ... ] @ km + kmb)) @ k2 + k2b,
//
// every product accumulated in f32 across all S streams and rounded once.
//
// The schedule. A block is two consumer warpgroups (warps 0-7), which run
// every product as wgmma m64nNk16 with f32 sums, and one producer warp
// (warp 8). The weights a tile needs are read as stages: for each chunk of
// 64 hidden units, the chunk's W1 columns by 64-deep k-blocks (8 KB each)
// then its W2 rows by 96-column tiles (12 KB each); then lv, km and k2
// (layout_stages in ops/gather_epilogue.py lays them out once, already
// swizzled). Consumer warpgroup w takes every other chunk, half of jl's
// column tiles and, for w = 1, kh and kv; it has a ring of
// shared-memory slots of its own, which lane w of the producer warp fills
// in that order with cp.async.bulk, each copy completing on the slot's
// mbarrier. The grid is persistent, one block per SM walking over tiles,
// and the rings run on across tiles, so the next tile's first stages
// arrive while this tile's rows are gathered. (Sharing each stage across a
// cluster of 2 or 4 blocks by multicast halves or quarters the weights'
// L2 reads, but measured slower on the H100: the blocks of a cluster then
// wait for each other at every slot.)
//
// Per stream both warpgroups fetch the tile's cell rows (16-byte loads)
// and combine them into comb, a (64, F) tile in the swizzled wgmma layout.
// The fuse MLP runs over chunks of 64 hidden units, warpgroup w taking the
// chunks c with c % 2 == w ^ (s % 2) of stream s (so with an even S each
// takes half): h_c = relu(comb @ W1[:, c] + ...) stays in registers, is
// rounded to bf16 and is the register A operand of f += h_c @ W2[c, :], so
// no hidden layer is kept in shared memory. The two warpgroups' partial f
// (f32) are summed through shared memory; f + b2 goes to the tile's f rows
// in bf16, which jl and kh read as a shared-memory A operand; kh is rounded
// to bf16 in registers and is the A operand of kv. Two warpgroups on one
// tile keep the tensor cores busy while either waits for a stage or runs
// its epilogue arithmetic: a warpgroup waits for its products before it
// releases their stage, so a ring of three slots keeps two stages in
// flight. Without the view swap the last stream's f goes into the comb
// tile, which it no longer needs, so three streams fit in the shared memory
// of two.

#pragma once

#include "hopper.cuh"

namespace exchange_core {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int kMaxLevels = 3;
constexpr int kMaxStreams = 4;
constexpr int kRows = 64;              // samples per tile: wgmma's M
constexpr int kKBlock = kRows * 128;   // a (64, 64) bf16 A tile, 8 KB
constexpr int kNC = 64;                // hidden units per chunk
constexpr int kNO = 96;                // columns of an O tile
constexpr int kMaxOT = 3;              // O <= 288
constexpr int kNK = 64;                // columns of a K tile
constexpr int kMaxKT = 4;              // K <= 256
constexpr int kSmallStage = kNC * 128;  // 8 KB: W1, km, k2 stages
constexpr int kLargeStage = kNO * 128;  // 12 KB: W2, lv stages (the slot)
constexpr int kMaxStages = 8;          // slots of both rings
constexpr int kWG = 128;               // threads of a warpgroup
constexpr int kConsumers = 2 * kWG;    // warps 0-7
constexpr int kProducerWarp = 8;       // the first of warpgroup 2
constexpr int kThreads = kConsumers + kWG;  // + the producer warpgroup
constexpr int kGatherBar = 1;          // named barrier ids (0 is
constexpr int kPairBar = 2;            // __syncthreads)

struct CoreArgs {
  const bf16* table[kMaxLevels];     // packed cell tables (rows, 4 * C_l)
  const int32_t* cells[kMaxLevels];  // (S*M,) cell rows, stream-major
  int channels[kMaxLevels];
  int n_levels;
  const bf16* aux[kMaxStreams];  // (M, 16) per stream: 12 slot weights,
                                 // tanh(pt/5), pad
  const unsigned char* stages;   // the weight stages of one tile
  const float* vecs;             // [W1[F:F+3] | b1 | b2 | lvb | kmb | k2b]
  bf16* jl;                      // (M, O)
  bf16* kv;                      // (M, K)
  int S, M, F, H1, O, K, rp;
  // Derived by fill_core: tile counts of each product and where things sit.
  int nch, nkbF, OT, KT, nkbf, nkbK, nkb_fbuf, n_stages;
  int chunk_bytes;               // one hidden chunk's W1 and W2 stages
  int jl_split;                  // jl's O tiles [0, jl_split) go to WG 0
  int v_b1, v_b2, v_lvb, v_kmb, v_k2b, ldv;  // offsets into vecs
  int n_vecs;
};

// Two adjacent bf16 values of a vector in shared memory, as f32.
__device__ __forceinline__ float2 lds2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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

// Lane w of the producer warp: the stages of consumer warpgroup w for every
// tile of this block, in that warpgroup's order, into its ring.
__device__ void produce(const CoreArgs& p, int w, uint32_t slots,
                        uint32_t full, uint32_t empty, int n_tiles) {
  int idx = 0;
  uint32_t phase = 0;
  const int n = p.n_stages / 2;
  slots += w * n * kLargeStage;
  full += 8 * w * n;
  empty += 8 * w * n;
  const auto fetch = [&](size_t off, uint32_t bytes) {
    mbar_wait(empty + 8 * idx, phase ^ 1);
    mbar_expect_tx(full + 8 * idx, bytes);
    bulk_copy(slots + idx * kLargeStage, p.stages + off, bytes,
              full + 8 * idx);
    if (++idx == n) {
      idx = 0;
      phase ^= 1;
    }
  };
  const size_t jl0 = (size_t)p.nch * p.chunk_bytes;
  const size_t kh0 = jl0 + (size_t)p.nkbf * p.OT * kLargeStage;
  const size_t kv0 = kh0 + (size_t)p.nkbf * p.KT * kSmallStage;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    for (int s = 0; s < p.S; ++s)
      for (int c = w ^ (s & 1); c < p.nch; c += 2) {
        size_t off = (size_t)c * p.chunk_bytes;
        for (int kb = 0; kb < p.nkbF; ++kb, off += kSmallStage)
          fetch(off, kSmallStage);
        for (int nt = 0; nt < p.OT; ++nt, off += kLargeStage)
          fetch(off, kLargeStage);
      }
    for (int kb = 0; kb < p.nkbf; ++kb)
      for (int nt = 0; nt < p.OT; ++nt)
        if ((nt < p.jl_split) == (w == 0))
          fetch(jl0 + ((size_t)kb * p.OT + nt) * kLargeStage, kLargeStage);
    if (w == 1) {
      for (int kb = 0; kb < p.nkbf; ++kb)
        for (int nt = 0; nt < p.KT; ++nt)
          fetch(kh0 + ((size_t)kb * p.KT + nt) * kSmallStage, kSmallStage);
      for (int nt = 0; nt < p.KT; ++nt)
        for (int kb = 0; kb < p.nkbK; ++kb)
          fetch(kv0 + ((size_t)nt * p.nkbK + kb) * kSmallStage, kSmallStage);
    }
  }
}

// Gathers the cell rows of stream s for the tile's samples m0.. and
// combines each level's four slots into comb (64, F), swizzled k-blocks of
// 64 columns; copies the tile's aux rows to aux (64, 16). Rows past M get
// zeros. Run by the kConsumers threads, t = threadIdx.x.
__device__ void gather_tile(const CoreArgs& p, int s, int m0,
                            unsigned char* comb, bf16* aux, int* cell) {
  const int t = threadIdx.x;
  for (int i = t; i < kRows * 2; i += kConsumers) {
    const int r = i >> 1, half = i & 1, m = m0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m < p.M)
      val = __ldg(reinterpret_cast<const uint4*>(p.aux[s] + (size_t)m * 16) +
                  half);
    reinterpret_cast<uint4*>(aux + r * 16)[half] = val;
  }
  // The tile's cell rows of every level first, so that the row loads below
  // wait on no other load from device memory.
  for (int i = t; i < kRows * p.n_levels; i += kConsumers) {
    const int l = i / kRows, m = m0 + i % kRows;
    cell[i] = m < p.M ? __ldg(p.cells[l] + (size_t)s * p.M + m) : -1;
  }
  bar_sync(kGatherBar, kConsumers);
  // One pass over the 16-byte chunks of all the tile's comb rows, eight per
  // thread in flight; chunk q of a row is column 8q, of the level whose
  // columns hold it.
  const int ch8 = p.F / 8, off1 = p.channels[0],
            off2 = p.n_levels > 2 ? off1 + p.channels[1] : p.F;
#pragma unroll 8
  for (int i = t; i < kRows * ch8; i += kConsumers) {
    const int r = i / ch8, col = (i - r * ch8) * 8;
    const int l = (col >= off1) + (col >= off2);
    const int C = p.channels[l];
    const int c0 = col - (l == 0 ? 0 : l == 1 ? off1 : off2);
    const int row = cell[l * kRows + r];
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row >= 0) {
      const bf16* src = p.table[l] + (size_t)row * 4 * C + c0;
      uint4 x[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = ldg_row(src + k * C);
      __nv_bfloat162* acc = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bf16 w = aux[r * 16 + l * 4 + k];
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
    *reinterpret_cast<uint4*>(comb + (col >> 6) * kKBlock +
                              swizzle(r, col & 63)) = out;
  }
  fence_proxy_async();
  bar_sync(kGatherBar, kConsumers);
}

// Warpgroup w's part of stream s's fuse MLP on the tile in comb:
// acc (64 x OT*96 f32 fragments) = sum over its chunks c of
// bf16(h_c) @ W2[c, :], h_c = relu(comb @ W1[:F, c] + tanh terms + b1[c])
// in registers. b2 is not added.
__device__ void stream_mlp(const CoreArgs& p, int w, int s, Ring& ring,
                           uint32_t comb, const bf16* aux, const bf16* vsm,
                           float (&acc)[kMaxOT][kNO / 2]) {
  const int lane = threadIdx.x & 31;
  const int r0 = ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  const int tq = 2 * (lane & 3);
  float th[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      th[h][j] = __bfloat162float(aux[(r0 + 8 * h) * 16 + 12 + j]);
#pragma unroll
  for (int nt = 0; nt < kMaxOT; ++nt)
#pragma unroll
    for (int i = 0; i < kNO / 2; ++i) acc[nt][i] = 0.f;
  for (int c = w ^ (s & 1); c < p.nch; c += 2) {
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
      const uint64_t db = wgmma_desc(ring.acquire());
      const uint64_t da = wgmma_desc(comb + kb * kKBlock);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_ss_n64(a1, da + 2 * ks, db + 2 * ks);
      wgmma_commit();
      ring.release();
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
      if (nt < p.OT) {
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

template <bool kViewSwap>
__global__ void __launch_bounds__(kThreads, 1)
    exchange_core_kernel(const CoreArgs p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023) & ~1023u) - raw);
  unsigned char* slots = base;
  unsigned char* comb = slots + p.n_stages * kLargeStage;
  unsigned char* fbuf = comb + p.nkbF * kKBlock;
  bf16* aux = reinterpret_cast<bf16*>(fbuf + p.nkb_fbuf * kKBlock);
  int* cell = reinterpret_cast<int*>(aux + kRows * 16);
  bf16* vsm = reinterpret_cast<bf16*>(cell + kRows * kMaxLevels);
  uint64_t* bars = reinterpret_cast<uint64_t*>(vsm + p.n_vecs);
  const uint32_t full = smem_u32(bars), empty = full + 8 * p.n_stages;

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
  // through k-block 0 leaves zeros behind).
  for (int i = threadIdx.x * 16; i < (p.nkbF + p.nkb_fbuf) * kKBlock;
       i += kThreads * 16)
    *reinterpret_cast<uint4*>(comb + i) = make_uint4(0u, 0u, 0u, 0u);
  // The vectors in bf16 (their values are bf16-rounded), out of reach of
  // L1's misses: every chunk's first step reads W1[F:F+3] and b1.
  for (int i = threadIdx.x; i < p.n_vecs; i += kThreads)
    vsm[i] = __float2bfloat16(p.vecs[i]);
  fence_proxy_async();
  __syncthreads();

  const int n_tiles = (p.M + kRows - 1) / kRows;

  // Three warpgroups start at 168 registers a thread; the producer's (one
  // warp works, three wait) gives its share to the consumers, 232 each.
  if (warp >= kProducerWarp) {
    reg_dealloc<40>();
    if (warp == kProducerWarp && lane < 2)
      produce(p, lane, smem_u32(slots), full, empty, n_tiles);
  } else {
    reg_alloc<232>();
    const int w = warp >> 2, tw = threadIdx.x & (kWG - 1);
    const int nh = p.n_stages / 2;
    Ring ring{smem_u32(slots) + w * nh * kLargeStage, full + 8 * w * nh,
              empty + 8 * w * nh, nh, 0, 0u};
    const int r0 = (warp & 3) * 16 + (lane >> 2), tq = 2 * (lane & 3);
    const uint32_t comb_s = smem_u32(comb);
    float4* xbuf = reinterpret_cast<float4*>(comb);  // (4, 128) float4
    float acc[kMaxOT][kNO / 2];
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile * kRows;
      for (int s = 0; s < p.S; ++s) {
        bar_sync(kGatherBar, kConsumers);  // comb and aux are free
        gather_tile(p, s, m0, comb, aux, cell);
        stream_mlp(p, w, s, ring, comb_s, aux, vsm, acc);

        // f = WG 0's partial sums + WG 1's + b2: WG 1 hands its f32 sums to
        // WG 0 through the first 8 KB of comb, 16 columns a thread at a time
        // (thread tw of both warpgroups holds the same fragment positions).
        // WG 0 zeroes each value it takes, so that no f32 bits stay behind:
        // read as bf16 they can be Inf or NaN, and k-block 0's columns past
        // F (F < 64) or past S*O (the last stream's f rows ending there) are
        // read again by products whose weights are zero there.
        bar_sync(kPairBar, kConsumers);  // comb is no longer read
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
        if (w == 0) {
          // f_s + b2 in bf16 to the tile's f rows, slot by view or stream.
          const bf16* b2 = vsm + p.v_b2;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
            int slot = s;
            if (kViewSwap) slot = (((m0 + row) / p.rp) & 1) == s ? 0 : 1;
#pragma unroll
            for (int nt = 0; nt < kMaxOT; ++nt)
#pragma unroll
              for (int j = 0; j < kNO / 8; ++j) {
                const int col = nt * kNO + j * 8 + tq;
                if (nt < p.OT && col < p.O) {
                  const int fc = slot * p.O + col;
                  const float2 b = lds2(b2 + col);
                  *reinterpret_cast<uint32_t*>(f_block(p, fbuf, comb, fc >> 6) +
                                               swizzle(row, fc & 63)) =
                      pack_bf16(acc[nt][4 * j + 2 * h] + b.x,
                                acc[nt][4 * j + 2 * h + 1] + b.y);
                }
              }
          }
        }
      }
      fence_proxy_async();
      bar_sync(kPairBar, kConsumers);  // the f rows are complete

      // jl = [f_0 | ...] @ lv + lvb, WG 0 on O tiles [0, jl_split), WG 1 on
      // the rest
      const int nt0 = w == 0 ? 0 : p.jl_split;
      const int nt1 = w == 0 ? p.jl_split : p.OT;
#pragma unroll
      for (int nt = 0; nt < kMaxOT; ++nt)
#pragma unroll
        for (int i = 0; i < kNO / 2; ++i) acc[nt][i] = 0.f;
      for (int kb = 0; kb < p.nkbf; ++kb) {
        const uint64_t da = wgmma_desc(smem_u32(f_block(p, fbuf, comb, kb)));
#pragma unroll
        for (int nt = 0; nt < kMaxOT; ++nt) {
          if (nt >= nt0 && nt < nt1) {
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
      const bf16* lvb = vsm + p.v_lvb;
#pragma unroll
      for (int nt = 0; nt < kMaxOT; ++nt) {
        fence_regs(acc[nt]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + r0 + 8 * h;
#pragma unroll
          for (int j = 0; j < kNO / 8; ++j) {
            const int col = nt * kNO + j * 8 + tq;
            if (nt >= nt0 && nt < nt1 && col < p.O && m < p.M) {
              const float2 b = lds2(lvb + col);
              *reinterpret_cast<uint32_t*>(p.jl + (size_t)m * p.O + col) =
                  pack_bf16(acc[nt][4 * j + 2 * h] + b.x,
                            acc[nt][4 * j + 2 * h + 1] + b.y);
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
        for (int kb = 0; kb < p.nkbf; ++kb) {
          const uint64_t da =
              wgmma_desc(smem_u32(f_block(p, fbuf, comb, kb)));
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
        const bf16* kmb = vsm + p.v_kmb;
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

        // kv = kh @ k2 + k2b, one 64-column tile at a time
        const bf16* k2b = vsm + p.v_k2b;
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
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int m = m0 + r0 + 8 * h;
#pragma unroll
              for (int j = 0; j < kNK / 8; ++j) {
                const int col = nt * kNK + j * 8 + tq;
                if (col < p.K && m < p.M) {
                  const float2 b = lds2(k2b + col);
                  *reinterpret_cast<uint32_t*>(p.kv + (size_t)m * p.K + col) =
                      pack_bf16(av[4 * j + 2 * h] + b.x,
                                av[4 * j + 2 * h + 1] + b.y);
                }
              }
            }
          }
        }
      }
    }
  }
}

// Fills `a` from the C interface's pointers, checks the sizes the kernel
// relies on and derives its tile counts. Returns a cudaError_t code.
inline int fill_core(CoreArgs& a, int n_levels, void* const* tables,
                     void* const* cells, const int* channels, int S,
                     const void* const* aux, const void* stages,
                     long long stage_bytes, const void* vecs, void* jl,
                     void* kv, int M, int F, int H1, int O, int K, int rp) {
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
  if (F_sum != F || F % 16 || H1 <= 0 || H1 % 16 || O <= 0 || O % 8 ||
      (S * O) % 16 || O > kMaxOT * kNO || K <= 0 || K % 16 ||
      K > kMaxKT * kNK)
    return (int)cudaErrorInvalidValue;
  for (int s = 0; s < kMaxStreams; ++s)
    a.aux[s] = s < S ? static_cast<const bf16*>(aux[s]) : nullptr;
  a.n_levels = n_levels;
  a.stages = static_cast<const unsigned char*>(stages);
  a.vecs = static_cast<const float*>(vecs);
  a.jl = static_cast<bf16*>(jl);
  a.kv = static_cast<bf16*>(kv);
  a.S = S;
  a.M = M;
  a.F = F;
  a.H1 = H1;
  a.O = O;
  a.K = K;
  a.rp = rp;
  const auto cdiv = [](int x, int y) { return (x + y - 1) / y; };
  a.nch = cdiv(H1, kNC);
  a.nkbF = cdiv(F, 64);
  a.OT = cdiv(O, kNO);
  a.KT = cdiv(K, kNK);
  a.nkbf = cdiv(S * O, 64);
  a.nkbK = cdiv(K, 64);
  a.chunk_bytes = a.nkbF * kSmallStage + a.OT * kLargeStage;
  a.jl_split = a.OT - a.OT / 2;
  const long long tail = (long long)a.nkbf * a.OT * kLargeStage +
                         (long long)a.nkbf * a.KT * kSmallStage +
                         (long long)a.KT * a.nkbK * kSmallStage;
  if (stage_bytes != (long long)a.nch * a.chunk_bytes + tail)
    return (int)cudaErrorInvalidValue;
  a.ldv = a.nch * kNC;
  a.v_b1 = 3 * a.ldv;
  a.v_b2 = a.v_b1 + a.ldv;
  a.v_lvb = a.v_b2 + a.OT * kNO;
  a.v_kmb = a.v_lvb + a.OT * kNO;
  a.v_k2b = a.v_kmb + a.KT * kNK;
  a.n_vecs = a.v_k2b + a.KT * kNK;
  a.n_stages = 0;
  a.nkb_fbuf = 0;
  return 0;
}

// Launches the kernel on `stream`: one block per SM (or per tile, if
// fewer), as many stage slots as the shared memory holds (up to
// kMaxStages), split between the two rings, clusters of one block. info
// receives the launch's (grid, stage slots, shared bytes, threads a block,
// cluster x, y, z).
template <bool kViewSwap>
int launch_core(CoreArgs& a, int* info, void* stream) {
  // Without the swap the last stream's f goes into the comb tile.
  a.nkb_fbuf = kViewSwap ? a.nkbf : (((a.S - 1) * a.O + 63) / 64);
  if (a.nkbf - a.nkb_fbuf > a.nkbF) a.nkb_fbuf = a.nkbf;
  const size_t fixed = 1024 + (size_t)(a.nkbF + a.nkb_fbuf) * kKBlock +
                       kRows * 16 * sizeof(bf16) +
                       kRows * kMaxLevels * sizeof(int) +
                       a.n_vecs * sizeof(bf16) + 16 * kMaxStages;
  int device = 0, optin = 0, n_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if ((size_t)optin < fixed + 2 * kLargeStage)
    return (int)cudaErrorInvalidValue;
  a.n_stages = (int)((optin - fixed) / kLargeStage) & ~1;
  if (a.n_stages > kMaxStages) a.n_stages = kMaxStages;
  const size_t smem = fixed + (size_t)a.n_stages * kLargeStage;
  const auto kernel = exchange_core_kernel<kViewSwap>;
  const int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err) return err;
  const int n_tiles = (a.M + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles < n_sm ? n_tiles : n_sm);
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
  }
  return launched ? launched : (int)cudaGetLastError();
}

}  // namespace exchange_core
