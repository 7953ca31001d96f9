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
// each way of moving a row costs against the card's byte bound (bytes
// bound it: rows written, rows read from device memory or from L2, the
// indices).
//
// Three kernels, each instantiated per probe:
//
//   copy_gather_kernel  one warp a row, 16-byte loads (not kept in L1) and
//                       streaming 16-byte stores, the lane loop unrolled
//                       1, 4 or 8; the block's indices read from device
//                       memory (kIdxGlobal), staged in shared memory by
//                       the threads (kIdxShared), or staged by one
//                       cp.async.bulk completing on an mbarrier
//                       (kIdxBulk); kStage passes each row through a
//                       one-row shared buffer per warp;
//   bulk_gather_kernel  one warp a block of bm rows: lane 0 copies each row
//                       global -> shared with one cp.async.bulk on the
//                       slot's mbarrier, kWindow rows in flight, and each
//                       arrived row shared -> global with one bulk copy;
//   block_fill_kernel   each block's bm rows of (M, width) int32 filled
//                       with its first index.
//
// The element type does not enter: rows are copied as bytes (a multiple of
// 16 a row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace row_gather {

using namespace hopper;

enum Index : int { kIdxGlobal = 0, kIdxShared = 1, kIdxBulk = 2 };
constexpr int kWarps = 8;  // copy gather: warps a block, one row each

__device__ __forceinline__ int clip(int r, int hw) {
  return r < 0 ? 0 : (r >= hw ? hw - 1 : r);
}

__device__ __forceinline__ uint4 ldg_nc(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// Shared memory of the copy gather: [indices (bm ints, padded to 16
// bytes) | mbarrier (16 bytes) | kStage: one row a warp].
inline size_t copy_smem(int bm, int row_bytes, bool stage) {
  return (((size_t)bm * 4 + 15) & ~(size_t)15) + 16 +
         (stage ? (size_t)kWarps * row_bytes : 0);
}

template <int kIndex, int kUnroll, bool kStage>
__global__ void __launch_bounds__(kWarps * 32)
    copy_gather_kernel(const uint4* table, const int* idx, uint4* out,
                       int hw, int M, int chunks, int bm) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* sidx = reinterpret_cast<int*>(smem);
  const size_t idx_bytes = ((size_t)bm * 4 + 15) & ~(size_t)15;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + idx_bytes);
  uint4* srow = reinterpret_cast<uint4*>(smem + idx_bytes + 16);
  const int m0 = blockIdx.x * bm, n = min(bm, M - m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (kIndex == kIdxShared) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) sidx[i] = idx[m0 + i];
    __syncthreads();
  } else if (kIndex == kIdxBulk) {
    // n * 4 is a multiple of 16: the wrapper takes M % 4 == 0, bm % 4 == 0
    const uint32_t b = smem_u32(bar);
    if (threadIdx.x == 0) {
      mbar_init(b, 1);
      fence_mbar_init();
      mbar_expect_tx(b, n * 4);
      bulk_copy(smem_u32(sidx), idx + m0, n * 4, b);
    }
    __syncthreads();
    mbar_wait(b, 0);
  }
  for (int j = warp; j < n; j += kWarps) {
    const int r = clip(kIndex == kIdxGlobal ? __ldg(idx + m0 + j) : sidx[j],
                       hw);
    const uint4* src = table + (size_t)r * chunks;
    uint4* dst = out + (size_t)(m0 + j) * chunks;
    if (kStage) {
      uint4* buf = srow + warp * chunks;
      for (int c = lane; c < chunks; c += 32) buf[c] = ldg_nc(src + c);
      __syncwarp();
      for (int c = lane; c < chunks; c += 32) __stcs(dst + c, buf[c]);
      __syncwarp();
    } else {
      for (int c = lane; c < chunks; c += 32 * kUnroll) {
        uint4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (c + 32 * u < chunks) v[u] = ldg_nc(src + c + 32 * u);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (c + 32 * u < chunks) __stcs(dst + c + 32 * u, v[u]);
      }
    }
  }
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until the bulk stores issued by this thread have read their source
// (kRead) or are complete.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared memory of the bulk gather: [kWindow mbarriers, padded to 128
// bytes | kWindow row slots].
inline size_t bulk_smem(int window, int row_bytes) {
  return 128 + (size_t)window * row_bytes;
}

template <int kWindow>
__global__ void __launch_bounds__(32)
    bulk_gather_kernel(const unsigned char* table, const int* idx,
                       unsigned char* out, int hw, int M, int row_bytes,
                       int bm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem), slots = bars + 128;
  const int m0 = blockIdx.x * bm, n = min(bm, M - m0);
  if (threadIdx.x != 0) return;  // one thread issues every copy
  for (int k = 0; k < kWindow; ++k) mbar_init(bars + 8 * k, 1);
  fence_mbar_init();
  const auto issue = [&](int k) {
    const int slot = k % kWindow;
    const int r = clip(__ldg(idx + m0 + k), hw);
    mbar_expect_tx(bars + 8 * slot, row_bytes);
    bulk_copy(slots + slot * row_bytes, table + (size_t)r * row_bytes,
              row_bytes, bars + 8 * slot);
  };
  for (int k = 0; k < kWindow && k < n; ++k) issue(k);
  for (int j = 0; j < n; ++j) {
    const int slot = j % kWindow;
    mbar_wait(bars + 8 * slot, (j / kWindow) & 1);
    fence_proxy_async();
    bulk_store(out + (size_t)(m0 + j) * row_bytes, slots + slot * row_bytes,
               row_bytes);
    if (j + kWindow < n) {
      bulk_wait<true>();  // the slot is read before it is refilled
      issue(j + kWindow);
    }
  }
  bulk_wait<false>();
}

__global__ void block_fill_kernel(const int* idx, int4* out, int M, int bm,
                                  int width4) {
  const int m0 = blockIdx.x * bm, n = min(bm, M - m0);
  const int v = __ldg(idx + m0);
  const int4 q = make_int4(v, v, v, v);
  int4* dst = out + (size_t)m0 * width4;
  for (int i = threadIdx.x; i < n * width4; i += blockDim.x) __stcs(dst + i, q);
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

template <int kIndex, int kUnroll, bool kStage>
int launch_copy(const void* const* args, int grid, size_t smem,
                void* stream) {
  return launch(copy_gather_kernel<kIndex, kUnroll, kStage>, grid,
                kWarps * 32, smem, stream, args);
}

template <int kIndex>
int launch_copy_unroll(int unroll, const void* const* args, int grid,
                       size_t smem, void* stream) {
  switch (unroll) {
    case 1: return launch_copy<kIndex, 1, false>(args, grid, smem, stream);
    case 4: return launch_copy<kIndex, 4, false>(args, grid, smem, stream);
    case 8: return launch_copy<kIndex, 8, false>(args, grid, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace row_gather

// table: (hw, row_bytes) bytes, idx: (M,) int32, out: (M, row_bytes), all
// contiguous and 16-byte aligned; row_bytes % 16 == 0; bm rows a block;
// index 0 (device memory), 1 (staged by the threads) or 2 (staged by a
// bulk copy: M % 4 == 0 and bm % 4 == 0); unroll 1, 4 or 8; stage: each
// row through shared memory (index 1, unroll 1 only). Returns a
// cudaError_t code.
extern "C" int row_gather_copy(const void* table, const void* idx, void* out,
                               int hw, int M, int row_bytes, int bm,
                               int index, int unroll, int stage,
                               void* stream) {
  using namespace row_gather;
  if (hw <= 0 || M <= 0 || bm <= 0 || row_bytes <= 0 || row_bytes % 16 ||
      (index == kIdxBulk && (M % 4 || bm % 4)))
    return (int)cudaErrorInvalidValue;
  int chunks = row_bytes / 16;
  const void* args[] = {&table, &idx, &out, &hw, &M, &chunks, &bm};
  const int grid = (M + bm - 1) / bm;
  const size_t smem = copy_smem(bm, row_bytes, stage != 0);
  if (stage)
    return index == kIdxShared && unroll == 1
               ? launch_copy<kIdxShared, 1, true>(args, grid, smem, stream)
               : (int)cudaErrorInvalidValue;
  switch (index) {
    case kIdxGlobal:
      return launch_copy_unroll<kIdxGlobal>(unroll, args, grid, smem, stream);
    case kIdxShared:
      return launch_copy_unroll<kIdxShared>(unroll, args, grid, smem, stream);
    case kIdxBulk:
      return launch_copy_unroll<kIdxBulk>(unroll, args, grid, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// As row_gather_copy, with one warp a block of bm rows and window (1 or 16)
// rows in flight, each moved by bulk copies through shared memory.
extern "C" int row_gather_bulk(const void* table, const void* idx, void* out,
                               int hw, int M, int row_bytes, int bm,
                               int window, void* stream) {
  using namespace row_gather;
  if (hw <= 0 || M <= 0 || bm <= 0 || row_bytes <= 0 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const void* args[] = {&table, &idx, &out, &hw, &M, &row_bytes, &bm};
  const int grid = (M + bm - 1) / bm;
  const size_t smem = bulk_smem(window, row_bytes);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  switch (window) {
    case 1: return launch(bulk_gather_kernel<1>, grid, 32, smem, stream, args);
    case 16:
      return launch(bulk_gather_kernel<16>, grid, 32, smem, stream, args);
  }
  return (int)cudaErrorInvalidValue;
}

// idx: (M,) int32; out: (M, width) int32, width % 4 == 0; each block of bm
// rows filled with the block's first index.
extern "C" int row_block_fill(const void* idx, void* out, int M, int bm,
                              int width, void* stream) {
  using namespace row_gather;
  if (M <= 0 || bm <= 0 || width <= 0 || width % 4)
    return (int)cudaErrorInvalidValue;
  int width4 = width / 4;
  const void* args[] = {&idx, &out, &M, &bm, &width4};
  return launch(block_fill_kernel, (M + bm - 1) / bm, 256, 0, stream, args);
}
