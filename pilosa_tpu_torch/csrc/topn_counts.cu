// topn_counts: out[r] = sum_s popcount(rm[s, r] & src[s]) for EVERY row r of
// a slice-major matrix rm[S, R, W] against one source row per slice,
// src[S, W].
//
// Replaces the Pallas kernel fused_topn_counts
// (pilosa_tpu/ops/pallas_kernels.py _topn_counts_kernel): TopN's scoring of
// a whole row set against its source bitmap; the differential sweep
// (ops/diffcheck.py) is its path in this package.
//
// Bound on this card: bytes — every row of the matrix is read once (plus
// src once), about three integer ops per word.  The TPU kernel kept a
// per-row-chunk (8, 128) accumulator tile resident in VMEM across the
// (slice, word-chunk) grid steps it walked in order; here blocks run in no
// order, so each sum ends in integer atomics (exact in any order).  Design:
// block (row tile t, word chunk c, slice s) owns kRows rows x 4096 words.
// Each thread loads its 16 words of src[s]'s chunk once into registers —
// every row of the tile is read at the same word positions, so the source
// chunk is staged once per block and reused across the tile's rows — then
// streams the tile's rows with 16-byte loads: AND, popc, a warp sum, and a
// shared-memory atomicAdd per (warp, row); one global atomicAdd per row
// at the end into the zeroed int32 out[r].  blockIdx.y is the slice, so
// the blocks in flight together share src[s] in L2.
//
// Counts are int32 per row: callers keep S <= 2047.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;    // int4 vectors per thread per chunk
constexpr int kRows = 16;  // rows per block
constexpr int kChunkVec = kThreads * kVec;

__global__ void __launch_bounds__(kThreads) topn_counts_kernel(
    const int4* __restrict__ rm, const int4* __restrict__ src, int* __restrict__ out,
    int n_rows, int wv, int n_chunks) {
  __shared__ int sums[kRows];
  const int c = blockIdx.x % n_chunks;
  const int r0 = (blockIdx.x / n_chunks) * kRows;
  const int nr = min(kRows, n_rows - r0);
  const long long s = blockIdx.y;
  const int v0 = c * kChunkVec + threadIdx.x;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x < kRows) sums[threadIdx.x] = 0;
  int4 sv[kVec];
  const int4* srow = src + s * wv;
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int i = v0 + v * kThreads;
    sv[v] = i < wv ? srow[i] : make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  const int4* tile = rm + (s * n_rows + r0) * wv;
#pragma unroll 2
  for (int j = 0; j < nr; ++j) {
    const int4* row = tile + (long long)j * wv;
    int part = 0;
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int i = v0 + v * kThreads;
      if (i < wv) part += popc_op4<OP_AND>(row[i], sv[v]);
    }
    part = warp_sum(part);
    if (lane == 0 && part) atomicAdd(sums + j, part);
  }
  __syncthreads();
  if (threadIdx.x < nr && sums[threadIdx.x]) atomicAdd(out + r0 + threadIdx.x, sums[threadIdx.x]);
}

}  // namespace

// rm: int32[s, r, w]; src: int32[s, w] (w % 4 == 0, 16-byte aligned);
// out: int32[r], zeroed.  s <= 65535.
extern "C" int pk_topn_counts(const void* rm, const void* src, void* out, int s, int r, int w,
                              void* stream) {
  if (s <= 0 || r <= 0 || w <= 0) return (int)cudaSuccess;
  const int wv = w / 4;
  const int n_chunks = (wv + kChunkVec - 1) / kChunkVec;
  const long long gx = (long long)((r + kRows - 1) / kRows) * n_chunks;
  if (gx > 0x7fffffffLL || s > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, s);
  topn_counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rm), static_cast<const int4*>(src), static_cast<int*>(out), r,
      wv, n_chunks);
  return (int)cudaGetLastError();
}
