// Staged shared-memory tiles for the resident kernels (resident_count2,
// resident_count_tree, resident_count_multi).
//
// A tile is the word chunk c (chunk_words words, a power of two >= 64) of
// U listed rows of one slice s of an int32 matrix, slice-major [S, R, W]
// or row-major [R, S, W]: row k of the tile is the chunk c of row ids[k]
// in slice s, 4 * chunk_words contiguous bytes at rm + s * slice_stride +
// ids[k] * row_stride + c * chunk_words (strides in words: W and R * W
// slice-major, S * W and W row-major).  The wrapper lists each row a
// batch names once (ids = the batch's distinct rows), so a tile holds
// every operand the batch reads in that chunk and nothing else.
//
// Copies are asynchronous: cp.async.cg 16-byte copies spread over every
// thread of the block, one commit group per tile, cp.async.wait_group to
// wait.  (TMA bulk copies, one per row segment, were slower on the H100:
// a tile is hundreds of 256-512-byte segments, and their issue rate set
// the pace; PERF_GATES.md records the times.)  With two stages tile t + 1 is in
// flight while tile t is folded; where two tiles do not fit, one stage
// (load, fold, load, ...) inside the same kernel.  Blocks are persistent:
// block g of G walks the contiguous, balanced run of tiles [g*T/G,
// (g+1)*T/G) of the T = S x W/chunk_words (slice, chunk) tiles,
// slice-major.
//
// Shared memory layout (dynamic, 128-byte aligned):
//   [stages x U x chunk_words ints: tiles]
//   [the kernel's own per-query ints, 16-byte aligned][U ints: row ids]
// stage_smem_bytes() gives the size; ops/kernels.py's staged_smem_bytes
// is the same formula.

#pragma once

#include <stdint.h>

#include "common.cuh"

// resident_count2's lanes read VW words of a row per step: an int4 for
// chunks of >= 128 words, an int2 for 64-word chunks; a warp step covers
// 32 vectors.
template <int VW>
struct Vec;
template <>
struct Vec<4> { using T = int4; };
template <>
struct Vec<2> { using T = int2; };

template <int OP>
__device__ __forceinline__ int popc_op_v(int4 a, int4 b) { return popc_op4<OP>(a, b); }
template <int OP>
__device__ __forceinline__ int popc_op_v(int2 a, int2 b) {
  return __popc(apply_op<OP>(a.x, b.x)) + __popc(apply_op<OP>(a.y, b.y));
}

inline size_t stage_smem_bytes(int u, int chunk_words, int stages, int own_ints) {
  return (size_t)stages * u * chunk_words * 4 + (size_t)u * 4 + (size_t)own_ints * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

struct Stager {
  const int* rm;         // global int32 matrix, [S, R, W] or [R, S, W]
  const int* ids;        // shared int32[U]: matrix row of tile row k
  unsigned char* tiles;  // shared, stages x U x chunk_words ints
  long long row_stride, slice_stride;  // words from one row / slice to the next
  int u, chunk_words, n_chunks, stages;

  __device__ int* tile(int buf) const {
    return reinterpret_cast<int*>(tiles + (size_t)buf * u * chunk_words * 4);
  }

  // Shared bytes the tiles take (the kernel's own ints follow them).
  __device__ size_t tile_bytes() const { return (size_t)stages * u * chunk_words * 4; }

  // Start copying tile t (t < 0: none) into buffer buf.  Every thread of
  // the block calls it and commits one group, empty when t < 0, so the
  // wait_group counts stay uniform.
  __device__ void issue(long long t, int buf) const {
    if (t >= 0) {
      const int s = (int)(t / n_chunks);
      const int c = (int)(t - (long long)s * n_chunks);
      const int* base = rm + (long long)s * slice_stride + (long long)c * chunk_words;
      const int per_row = chunk_words >> 2;  // 16-byte pieces per row
      int shift = 0;
      while ((1 << shift) < per_row) ++shift;
      const int total = u << shift;
      const uint32_t d0 = smem_u32(tile(buf));
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        const int k = i >> shift;
        const int v = i & (per_row - 1);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d0 + (uint32_t)i * 16),
                     "l"(base + (long long)ids[k] * row_stride + v * 4)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Wait until the oldest group in flight (the tile about to be folded)
  // has landed; the stages - 1 groups committed after it (later tiles,
  // or empty ones) may stay in flight.
  __device__ void wait() const {
    if (stages == 2)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // every thread's copies visible to every thread
  }
};

// Walk this block's tiles through the stager, calling fold(tile) on each
// resident tile (every thread of the block calls it).  Block g of G owns
// the contiguous run of tiles [g*T/G, (g+1)*T/G); stages - 1 tiles stay
// in flight while one is folded.
template <typename Fold>
__device__ __forceinline__ void stage_walk(const Stager& st, long long n_tiles, Fold&& fold) {
  const long long t0 = (long long)blockIdx.x * n_tiles / gridDim.x;
  const long long t1 = (long long)(blockIdx.x + 1) * n_tiles / gridDim.x;
  for (int p = 0; p < st.stages - 1; ++p) st.issue(t0 + p < t1 ? t0 + p : -1, p);
  for (long long t = t0; t < t1; ++t) {
    const int i = (int)(t - t0);
    const int buf = i % st.stages;
    // The buffer refilled here held tile t - 1, released by the block
    // sync that ended it.
    const long long next = t + st.stages - 1;
    st.issue(next < t1 ? next : -1, (i + st.stages - 1) % st.stages);
    st.wait();
    fold(st.tile(buf));
    __syncthreads();  // the tile is consumed before its buffer refills
  }
}

// Block grid for a staged launch: as many persistent blocks as fit on the
// card at once (occupancy at this shared-memory size, shared among the
// grid_y query groups, rounded down: no second wave), at most one per
// tile, times grid_y.
template <typename K>
inline cudaError_t stage_grid(K kernel, int threads, size_t smem, long long n_tiles, int groups,
                              dim3* grid) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, occ = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, threads, smem)) !=
      cudaSuccess)
    return e;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  long long gx = (long long)occ * sms / groups;
  if (gx > n_tiles) gx = n_tiles;
  if (gx < 1) gx = 1;
  if (groups > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3((unsigned)gx, (unsigned)groups);
  return cudaSuccess;
}
