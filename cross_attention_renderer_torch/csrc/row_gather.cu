// Row gathers by a dynamic index for Hopper (sm_90a): out[j] =
// table[clip(idx[j], 0, HW - 1)], and the block fill out[j, :] =
// idx[(j / bm) * bm].
//
// Replaces the 13 probe kernels of tools/ (micro_kgather.py
// vmem_loop_gather, hbm_dma_gather; micro_kgather2.py gather_prefetch;
// micro_kgather3.py tile_gather, dma_gather; micro_kgather_bisect.py
// smem_block_input, dyn_row_load_f32, dyn_row_load_bf16,
// dyn_row_static_store_scratch, dma_one_row; micro_kgather_bisect2.py
// smem_2d, prefetch_idx, vmem_idx_dma_smem). Each asked whether a Mosaic
// kernel can gather single rows by an index read at run time, and how fast.
// On Hopper any thread reads any address, so the question becomes what
// each way of moving a row costs against the card's byte bound (rows
// written, each distinct row read once, the indices).
//
// A gather moves bytes and computes nothing, so what bounds it is the
// bytes in flight: by Little's law about 3.35 TB/s x ~1 us of latency over
// 132 SMs, 25-32 KB an SM. The launch plan (grid, warps a block, rows a
// block takes at a time, rows in flight a warp) is chosen by the caller
// from the SM count (ops/experimental/row_gather.py launch_plan), never
// from the probes' block size: a grid of at least two blocks an SM where
// M allows, and a grid-stride loop over the row tiles beyond that.
//
// Three kernels, each instantiated per probe:
//
//   copy_gather_kernel  each warp takes a unit of kRows rows (several rows
//                       in flight a warp; fewer where M is short, so that
//                       more warps share it) and one step of their chunks:
//                       every lane issues its kRows x kUnroll <= kDepth
//                       16-byte loads (kUnroll chunks of each row) before
//                       any of its stores; a row's steps are units of
//                       their own, so a short gather spreads over many
//                       warps and a long one walks its units
//                       grid-stride. A tile's indices come from
//                       device memory, the next unit's read while the
//                       current unit's rows are in flight (kIdxGlobal),
//                       staged in shared memory by the threads
//                       (kIdxShared), or staged by one cp.async.bulk
//                       completing on an mbarrier (kIdxBulk); kStage
//                       passes each unit's chunks through a shared buffer
//                       of the warp;
//   bulk_gather_kernel  several issuing warps a block, each with its own
//                       run of rows and a ring of kWindow row slots: lane 0
//                       copies each row global -> shared with one
//                       cp.async.bulk on the slot's mbarrier and each
//                       arrived row shared -> global with one bulk copy,
//                       refilling a slot only once the store issued kLag
//                       rows earlier has read it, so loads and stores
//                       overlap; the indices come 32 at a time, one a lane,
//                       a batch ahead;
//   block_fill_kernel   the (M, width) int32 output, each row block of bm
//                       rows filled with its first index: a block takes a
//                       tile of rows at a time, reads the first index of
//                       each row block the tile spans once (into shared
//                       memory), and writes the tile's 16-byte chunks,
//                       consecutive threads on consecutive chunks (one a
//                       thread at the probes' shapes: 1-8 a thread were
//                       timed, tools/gather_study.py fill), its index math
//                       multiplies and shifts (no division). Its launch
//                       (tile, warps, grid) comes
//                       from the SM count as the gathers' does, never
//                       from bm. A fill writes 1 MiB at the probes' shapes
//                       (0.3 us at 3.35 TB/s), so what bounds it is the
//                       launch and one index read's latency; its
//                       yardstick is a copy_ from an expanded view.
//
// The element type does not enter: rows are copied as bytes (a multiple of
// 16 a row).
//
// Cache policy (measured by tools/gather_study.py, which builds patched
// copies of this source): the copy gather loads the table's rows with an L2
// evict_last policy and stores the output streaming (st.global.cs); the
// bulk gather's copies take L2 cache hints, evict_last for the loads and
// evict_first for the stores. The evict_last marks outlast the launch, so
// whatever reads the table next finds it in L2; row_gather_release_l2
// returns a range's lines to the normal priority.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"


namespace row_gather {

using namespace hopper;

enum Index : int { kIdxGlobal = 0, kIdxShared = 1, kIdxBulk = 2 };
constexpr int kDepth = 8;      // copy gather: 16-byte chunks a lane holds
constexpr int kMaxWarps = 8;   // warps a block, at most
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clip(int r, int hw) {
  return r < 0 ? 0 : (r >= hw ? hw - 1 : r);
}

// L2 policies for the table's rows (kept) and the bulk gather's output
// (evicted first).
__device__ __forceinline__ uint64_t keep_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t stream_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint4 load_chunk(const uint4* p, uint64_t policy) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, "
      "[%4], %5;\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void store_chunk(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Shared memory of the copy gather: [a tile's indices (padded to 16 bytes)
// | mbarrier (16 bytes) | kStage: a buffer a warp of its lanes' `depth`
// (rows x unroll) chunks].
inline size_t copy_smem(int tile, int warps, int depth) {
  return (((size_t)tile * 4 + 15) & ~(size_t)15) + 16 +
         (size_t)warps * depth * 32 * 16;
}

// kIdxGlobal: lane i < kRows holds the index of row i of unit u of a tile
// at m0 of n rows (0 past the tile's units and rows).
template <int kRows>
__device__ __forceinline__ int unit_index(const int* idx, int m0, int n,
                                          int units, int steps, int u,
                                          int lane) {
  const int row = u / steps * kRows + lane;
  return (u < units && lane < kRows && row < n) ? __ldg(idx + m0 + row) : 0;
}

// Block b takes the tiles b, b + grid, ... of `tile` rows; in a tile of n
// rows, unit u is rows kRows * (u / steps) + [0, kRows) and the row chunks
// of step u % steps, and warp w takes the units w, w + warps, ... A lane
// has kRows * kUnroll <= kDepth chunks in flight. The launch bounds name
// one block an SM: with the block size alone ptxas capped every
// instantiation at 64 registers and spilled (device-memory indices,
// unroll 1, 8 rows), which ran T3's 512-byte rows 25% slower.
template <int kIndex, int kUnroll, int kRows, bool kStage>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    copy_gather_kernel(const uint4* table, const int* idx, uint4* out,
                       int hw, int M, int chunks, int tile) {
  static_assert(kRows * kUnroll <= kDepth, "a lane holds kDepth chunks");
  extern __shared__ __align__(128) unsigned char smem[];
  int* sidx = reinterpret_cast<int*>(smem);
  const size_t idx_bytes = ((size_t)tile * 4 + 15) & ~(size_t)15;
  const uint32_t bar = smem_u32(smem + idx_bytes);
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  uint4* buf = reinterpret_cast<uint4*>(smem + idx_bytes + 16) +
               warp * kRows * kUnroll * 32;
  const int steps = (chunks + 32 * kUnroll - 1) / (32 * kUnroll);
  const int tiles = (M + tile - 1) / tile;
  const uint64_t policy = keep_policy();
  if (kIndex == kIdxBulk && threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  int phase = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, phase ^= 1) {
    const int m0 = t * tile, n = min(tile, M - m0);
    if (kIndex == kIdxShared) {
      for (int i = threadIdx.x; i < n; i += blockDim.x)
        sidx[i] = __ldg(idx + m0 + i);
      __syncthreads();
    } else if (kIndex == kIdxBulk) {
      // n * 4 is a multiple of 16: tile % 4 == 0 and M % 4 == 0
      if (threadIdx.x == 0) {
        fence_proxy_async();  // the last tile's reads before the copy
        mbar_expect_tx(bar, n * 4);
        bulk_copy(smem_u32(sidx), idx + m0, n * 4, bar);
      }
      __syncthreads();
      mbar_wait(bar, phase);
    }
    const int units = (n + kRows - 1) / kRows * steps;
    // kIdxGlobal: the next unit's indices are read while this unit's rows
    // are in flight
    int held = kIndex == kIdxGlobal
                   ? unit_index<kRows>(idx, m0, n, units, steps, warp, lane)
                   : 0;
    for (int u = warp; u < units; u += warps) {
      const int row0 = u / steps * kRows, s = u - u / steps * steps;
      const int c0 = s * 32 * kUnroll + lane;
      uint4 v[kRows][kUnroll];
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        const int r = clip(kIndex == kIdxGlobal ? __shfl_sync(kFull, held, g)
                                                : sidx[min(row0 + g, n - 1)],
                           hw);
        if (row0 + g < n) {
          const uint4* src = table + (size_t)r * chunks;
#pragma unroll
          for (int k = 0; k < kUnroll; ++k)
            if (c0 + 32 * k < chunks) v[g][k] = load_chunk(src + c0 + 32 * k,
                                                           policy);
        }
      }
      if (kIndex == kIdxGlobal)
        held = unit_index<kRows>(idx, m0, n, units, steps, u + warps, lane);
      if (kStage) {
#pragma unroll
        for (int g = 0; g < kRows; ++g)
#pragma unroll
          for (int k = 0; k < kUnroll; ++k)
            buf[(g * kUnroll + k) * 32 + lane] = v[g][k];
        __syncwarp();
#pragma unroll
        for (int g = 0; g < kRows; ++g)
#pragma unroll
          for (int k = 0; k < kUnroll; ++k)
            v[g][k] = buf[(g * kUnroll + k) * 32 + lane];
        __syncwarp();
      }
#pragma unroll
      for (int g = 0; g < kRows; ++g) {
        if (row0 + g < n) {
          uint4* dst = out + (size_t)(m0 + row0 + g) * chunks;
#pragma unroll
          for (int k = 0; k < kUnroll; ++k)
            if (c0 + 32 * k < chunks)
              store_chunk(dst + c0 + 32 * k, v[g][k]);
        }
      }
    }
    if (kIndex != kIdxGlobal) __syncthreads();  // sidx is refilled next
  }
}

// Copies `bytes` from global memory to shared memory, completing on `bar`,
// with an L2 cache hint.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes."
      "L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// Stores `bytes` from shared memory to global memory as one bulk copy with
// an L2 cache hint, in a bulk group of its own.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], "
      "%2, %3;\n" ::"l"(dst),
      "r"(src), "r"(bytes), "l"(policy)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until all but the newest kPending bulk groups of this thread have
// read their shared-memory source.
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending)
               : "memory");
}

// Shared memory of the bulk gather: [warps x kWindow mbarriers, padded to
// 128 bytes | warps x kWindow row slots].
__host__ __device__ inline size_t bulk_bars(int warps, int window) {
  return ((size_t)warps * window * 8 + 127) & ~(size_t)127;
}
inline size_t bulk_smem(int warps, int window, int row_bytes) {
  return bulk_bars(warps, window) + (size_t)warps * window * row_bytes;
}

// Warp w of block b takes rows [(b * warps + w) * rows, + rows) of M.
template <int kWindow>
__global__ void __launch_bounds__(kMaxWarps * 32)
    bulk_gather_kernel(const unsigned char* table, const int* idx,
                       unsigned char* out, int hw, int M, int row_bytes,
                       int rows) {
  // stores a warp may have in flight when it refills a slot: the slot of
  // the row stored kLag - 1 rows before the current one
  constexpr int kLag = kWindow >= 4 ? kWindow / 4 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5,
            lane = threadIdx.x & 31;
  const int first = (blockIdx.x * warps + warp) * rows;
  const int n = min(rows, M - first);
  if (n <= 0) return;
  const uint32_t bars = smem_u32(smem) + warp * kWindow * 8;
  const uint32_t slots = smem_u32(smem) + (uint32_t)bulk_bars(warps, kWindow) +
                         (uint32_t)(warp * kWindow * row_bytes);
  if (lane == 0) {
    for (int k = 0; k < kWindow; ++k) mbar_init(bars + 8 * k, 1);
    fence_mbar_init();
  }
  __syncwarp();
  const uint64_t in_policy = keep_policy(), out_policy = stream_policy();
  // lane l holds the index of row 32 * batch + l, of this batch and the next
  const auto read = [&](int k) { return k < n ? __ldg(idx + first + k) : 0; };
  int batch = 0, cur = read(lane), next = read(32 + lane);
  const auto issue = [&](int k) {  // k rises from call to call
    while (k >= 32 * (batch + 1)) {
      cur = next;
      ++batch;
      next = read(32 * (batch + 1) + lane);
    }
    const int r = clip(__shfl_sync(kFull, cur, k & 31), hw);
    if (lane == 0) {
      const int slot = k % kWindow;
      mbar_expect_tx(bars + 8 * slot, row_bytes);
      bulk_load(slots + slot * row_bytes, table + (size_t)r * row_bytes,
                row_bytes, bars + 8 * slot, in_policy);
    }
  };
  for (int k = 0; k < kWindow && k < n; ++k) issue(k);
  for (int j = 0; j < n; ++j) {
    if (lane == 0) {
      const int slot = j % kWindow;
      mbar_wait(bars + 8 * slot, (j / kWindow) & 1);
      fence_proxy_async();
      bulk_store(out + (size_t)(first + j) * row_bytes,
                 slots + slot * row_bytes, row_bytes, out_policy);
    }
    const int r = j - (kLag - 1);  // its slot takes row r + kWindow
    if (r >= 0 && r + kWindow < n) {
      if (lane == 0) bulk_wait_read<kLag - 1>();
      issue(r + kWindow);
    }
  }
  if (lane == 0) bulk_wait_read<0>();  // the slots are read before exit
}

__device__ __forceinline__ void fill_store(int4* p, int4 v) { __stcs(p, v); }

// n / d for 0 <= n < 2^31 as a multiply-high, an add and a shift, the
// divisor's magic number made once on the host (PyTorch's IntDivider): a
// runtime division is ~20 dependent instructions, which a fill of a few
// microseconds would wait on.
struct FastDiv {
  unsigned magic;
  int shift;
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi((unsigned)n, magic) + (unsigned)n) >> shift);
  }
};

inline FastDiv fast_div(int d) {
  int shift = 0;
  while ((1u << shift) < (unsigned)d) ++shift;
  const uint64_t one = 1;
  return {(unsigned)(((one << 32) * ((one << shift) - (unsigned)d)) / d + 1),
          shift};
}

// Block b fills the tiles b, b + grid, ... (of `tiles`) of `tile` rows of
// (M, chunks x 16 bytes): the first indices of the row blocks a tile spans
// (at most tile) into shared memory, one load each, then chunk i of the
// tile, by thread i % blockDim.x, from the head of its row's block.
__global__ void __launch_bounds__(kMaxWarps * 32)
    block_fill_kernel(const int* idx, int4* out, int M, int bm, int chunks,
                      int tile, int tiles, FastDiv by_bm, FastDiv by_chunks) {
  extern __shared__ int heads[];
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t * tile, n = min(tile, M - m0);
    const int b0 = by_bm(m0), nb = by_bm(m0 + n - 1) - b0 + 1;
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
      heads[i] = __ldg(idx + (size_t)(b0 + i) * bm);
    __syncthreads();
    int4* dst = out + (size_t)m0 * chunks;
    const int total = n * chunks;
#pragma unroll 4
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int v = heads[by_bm(m0 + by_chunks(i)) - b0];
      fill_store(dst + i, make_int4(v, v, v, v));
    }
    __syncthreads();  // the heads are refilled for the next tile
  }
}

// Returns the L2 lines of `lines` 128-byte lines from p to the normal
// eviction priority (lines not in L2 are left as they are).
__global__ void release_l2_kernel(const unsigned char* p, size_t lines) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < lines;
       i += (size_t)gridDim.x * blockDim.x)
    asm volatile("applypriority.global.L2::evict_normal [%0], 128;\n" ::"l"(
                     p + i * 128)
                 : "memory");
}

template <typename Kernel>
int launch(Kernel kernel, int grid, int threads, size_t smem, void* stream,
           const void* const* args) {
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
  }
  const int err = (int)cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid), dim3(threads),
      const_cast<void**>(args), smem, static_cast<cudaStream_t>(stream));
  return err ? err : (int)cudaGetLastError();
}

template <int kIndex, int kUnroll, int kRows>
int launch_rows(const void* const* args, int grid, int threads, size_t smem,
                void* stream) {
  if constexpr (kRows * kUnroll <= kDepth)
    return launch(copy_gather_kernel<kIndex, kUnroll, kRows, false>, grid,
                  threads, smem, stream, args);
  return (int)cudaErrorInvalidValue;
}

template <int kIndex, int kUnroll>
int launch_unroll(int rows, const void* const* args, int grid, int threads,
                  size_t smem, void* stream) {
  switch (rows) {
    case 1: return launch_rows<kIndex, kUnroll, 1>(args, grid, threads, smem,
                                                   stream);
    case 2: return launch_rows<kIndex, kUnroll, 2>(args, grid, threads, smem,
                                                   stream);
    case 4: return launch_rows<kIndex, kUnroll, 4>(args, grid, threads, smem,
                                                   stream);
    case 8: return launch_rows<kIndex, kUnroll, 8>(args, grid, threads, smem,
                                                   stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int kIndex>
int launch_copy(int unroll, int rows, const void* const* args, int grid,
                int threads, size_t smem, void* stream) {
  switch (unroll) {
    case 1: return launch_unroll<kIndex, 1>(rows, args, grid, threads, smem,
                                            stream);
    case 2: return launch_unroll<kIndex, 2>(rows, args, grid, threads, smem,
                                            stream);
    case 4: return launch_unroll<kIndex, 4>(rows, args, grid, threads, smem,
                                            stream);
    case 8: return launch_unroll<kIndex, 8>(rows, args, grid, threads, smem,
                                            stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int kRows>
int launch_stage(const void* const* args, int grid, int threads, size_t smem,
                 void* stream) {
  return launch(copy_gather_kernel<kIdxShared, 1, kRows, true>, grid, threads,
                smem, stream, args);
}

constexpr size_t kMaxSmem = 232448;

}  // namespace row_gather

// table: (hw, row_bytes) bytes, idx: (M,) int32, out: (M, row_bytes), all
// contiguous and 16-byte aligned; row_bytes % 16 == 0. index 0 (device
// memory), 1 (staged by the threads) or 2 (staged by a bulk copy: M % 4 ==
// 0 and tile % 4 == 0); unroll (1, 2, 4, 8): a row's chunks a lane has in
// flight; rows (1, 2, 4, 8; rows * unroll <= 8): rows in flight a warp;
// stage: each unit through shared memory (index 1, unroll 1 only); grid
// blocks of `warps` warps taking tiles of `tile` rows. Returns a
// cudaError_t code.
extern "C" int row_gather_copy(const void* table, const void* idx, void* out,
                               int hw, int M, int row_bytes, int index,
                               int unroll, int rows, int stage, int tile,
                               int warps, int grid, void* stream) {
  using namespace row_gather;
  if (hw <= 0 || M <= 0 || row_bytes <= 0 || row_bytes % 16 || tile <= 0 ||
      warps <= 0 || warps > kMaxWarps || grid <= 0 ||
      (index == kIdxBulk && (M % 4 || tile % 4)))
    return (int)cudaErrorInvalidValue;
  int chunks = row_bytes / 16;
  const void* args[] = {&table, &idx, &out, &hw, &M, &chunks, &tile};
  const size_t smem = copy_smem(tile, warps, stage ? rows * unroll : 0);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int threads = warps * 32;
  if (stage) {
    if (index != kIdxShared || unroll != 1) return (int)cudaErrorInvalidValue;
    switch (rows) {
      case 1: return launch_stage<1>(args, grid, threads, smem, stream);
      case 2: return launch_stage<2>(args, grid, threads, smem, stream);
      case 4: return launch_stage<4>(args, grid, threads, smem, stream);
      case 8: return launch_stage<8>(args, grid, threads, smem, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (index) {
    case kIdxGlobal:
      return launch_copy<kIdxGlobal>(unroll, rows, args, grid, threads, smem,
                                     stream);
    case kIdxShared:
      return launch_copy<kIdxShared>(unroll, rows, args, grid, threads, smem,
                                     stream);
    case kIdxBulk:
      return launch_copy<kIdxBulk>(unroll, rows, args, grid, threads, smem,
                                   stream);
  }
  return (int)cudaErrorInvalidValue;
}

// As row_gather_copy, through shared memory by bulk copies: grid blocks of
// `warps` issuing warps, each taking `rows` consecutive rows with window
// (1 or 16) rows in flight.
extern "C" int row_gather_bulk(const void* table, const void* idx, void* out,
                               int hw, int M, int row_bytes, int window,
                               int warps, int rows, int grid, void* stream) {
  using namespace row_gather;
  if (hw <= 0 || M <= 0 || row_bytes <= 0 || row_bytes % 16 || warps <= 0 ||
      warps > kMaxWarps || rows <= 0 || grid <= 0 ||
      (long long)grid * warps * rows < M)
    return (int)cudaErrorInvalidValue;
  const void* args[] = {&table, &idx, &out, &hw, &M, &row_bytes, &rows};
  const size_t smem = bulk_smem(warps, window, row_bytes);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  switch (window) {
    case 1:
      return launch(bulk_gather_kernel<1>, grid, warps * 32, smem, stream,
                    args);
    case 16:
      return launch(bulk_gather_kernel<16>, grid, warps * 32, smem, stream,
                    args);
  }
  return (int)cudaErrorInvalidValue;
}

// idx: (M,) int32; out: (M, width) int32, width % 4 == 0; each block of bm
// rows filled with the block's first index, by grid blocks of `warps`
// warps taking tiles of `tile` rows (ops/experimental/row_gather.py
// launch_plan 'fill'). Returns a cudaError_t code.
extern "C" int row_block_fill(const void* idx, void* out, int M, int bm,
                              int width, int tile, int warps, int grid,
                              void* stream) {
  using namespace row_gather;
  if (M <= 0 || bm <= 0 || width <= 0 || width % 4 || tile <= 0 ||
      warps <= 0 || warps > kMaxWarps || grid <= 0)
    return (int)cudaErrorInvalidValue;
  int chunks = width / 4, tiles = (M + tile - 1) / tile;
  const size_t smem = (size_t)tile * 4;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  FastDiv by_bm = fast_div(bm), by_chunks = fast_div(chunks);
  const void* args[] = {&idx,   &out,  &M,     &bm,       &chunks,
                        &tile,  &tiles, &by_bm, &by_chunks};
  return launch(block_fill_kernel, grid, warps * 32, smem, stream, args);
}

// Returns the L2 lines of [p, p + bytes) to the normal eviction priority,
// undoing the marks the gathers' evict_last loads leave on a table. Returns
// a cudaError_t code.
extern "C" int row_gather_release_l2(const void* p, size_t bytes,
                                     void* stream) {
  using namespace row_gather;
  const uintptr_t first = reinterpret_cast<uintptr_t>(p) & ~(uintptr_t)127;
  const size_t lines =
      (reinterpret_cast<uintptr_t>(p) + bytes - first + 127) / 128;
  if (lines == 0) return 0;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(first);
  size_t lines_arg = lines;
  const void* args[] = {&base, &lines_arg};
  const int grid = (int)(lines < 256 * 1024 ? (lines + 255) / 256 : 1024);
  return launch(release_l2_kernel, grid, 256, 0, stream, args);
}
