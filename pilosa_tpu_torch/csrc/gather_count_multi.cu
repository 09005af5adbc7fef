// gather_count_multi: out[q] = sum_s popcount(fold_j rm[s, idx[q, j]]) for a
// left fold of K gathered rows per query (fold and / or / andnot, where
// andnot folds acc & ~row for every operand after the first).
//
// Replaces the Pallas kernel fused_gather_count_multi (and its OR wrapper
// fused_gather_count_or) in pilosa_tpu/ops/pallas_kernels.py
// (_gather_multi_kernel): Counts of N-operand Intersect / Union /
// Difference, and the time-quantum Range cover (an OR over the cover's
// (view, row) rows of the multi-view matrix).
//
// Bound on this card: bytes — K rows of W words per (query, slice), about
// three integer ops per word.  Design: block (q, c, s) owns query q's
// word chunk c of slice s: 256 threads x V int4 vectors = 4096 words.
// Each thread keeps its V accumulators in registers while the block walks
// the query's K operand ids, which it stages in shared memory a tile of
// 1024 ids at a time (any K runs; the TPU kernel scalar-prefetched ids into
// SMEM, which capped the batch).  Per operand a thread issues V independent
// 16-byte loads, so each block keeps 16 KiB of loads in flight.  At the end
// popc, a block sum, and one integer atomicAdd into out[q] (zeroed by the
// wrapper): exact in any order.  The TPU grid walked (query, slice,
// operand) in order with a VMEM accumulator; here the operand loop is the
// block's own loop and (query, chunk, slice) are parallel blocks.
//
// Padded and unpadded id lists give the same count: the kernel folds every
// id it is given, and the executor pads with ids whose repeat the fold
// ignores (and / or: any operand; andnot: any operand after the first).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // int4 vectors per thread per chunk
constexpr int kIdTile = 1024;    // ids staged in shared memory at a time
constexpr int kChunkVec = kThreads * kVec;

template <int OP>
__global__ void __launch_bounds__(kThreads) gather_count_multi_kernel(
    const int4* __restrict__ rm, const int* __restrict__ idx, int* __restrict__ out,
    int n_rows, int wv, int k, int n_chunks) {
  __shared__ int ids[kIdTile];
  const int q = blockIdx.x / n_chunks;
  const int c = blockIdx.x - q * n_chunks;
  const long long slice_base = (long long)blockIdx.y * n_rows;
  const int v0 = c * kChunkVec + threadIdx.x;
  const int* qids = idx + (long long)q * k;

  int4 acc[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) acc[v] = make_int4(0, 0, 0, 0);

  for (int t0 = 0; t0 < k; t0 += kIdTile) {
    const int tn = min(kIdTile, k - t0);
    __syncthreads();  // the previous tile's ids are consumed
    for (int i = threadIdx.x; i < tn; i += kThreads) ids[i] = qids[t0 + i];
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      const int4* row = rm + (slice_base + ids[j]) * wv;
      int4 x[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int i = v0 + v * kThreads;
        x[v] = i < wv ? row[i] : make_int4(0, 0, 0, 0);
      }
      if (t0 + j == 0) {
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[v] = x[v];
      } else {
#pragma unroll
        for (int v = 0; v < kVec; ++v) acc[v] = op4<OP>(acc[v], x[v]);
      }
    }
  }
  int part = 0;
#pragma unroll
  for (int v = 0; v < kVec; ++v) part += popc4(acc[v]);
  part = block_sum(part);
  if (threadIdx.x == 0 && part) atomicAdd(out + q, part);
}

}  // namespace

// rm: int32[s, r, w] (w % 4 == 0, 16-byte aligned); idx: int32[b, k]
// (ids < r, k >= 1); out: int32[b], zeroed.  op: OP_AND, OP_OR or
// OP_ANDNOT (common.cuh).  s <= 65535.
extern "C" int pk_gather_count_multi(const void* rm, const void* idx, void* out, int s, int r,
                                     int w, int b, int k, int op, void* stream) {
  if (s <= 0 || b <= 0 || w <= 0) return (int)cudaSuccess;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  const int wv = w / 4;
  const int n_chunks = (wv + kChunkVec - 1) / kChunkVec;
  const long long gx = (long long)b * n_chunks;
  if (gx > 0x7fffffffLL || s > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, s);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* m = static_cast<const int4*>(rm);
  const int* ix = static_cast<const int*>(idx);
  int* o = static_cast<int*>(out);
  switch (op) {
    case OP_AND:
      gather_count_multi_kernel<OP_AND><<<grid, block, 0, st>>>(m, ix, o, r, wv, k, n_chunks);
      break;
    case OP_OR:
      gather_count_multi_kernel<OP_OR><<<grid, block, 0, st>>>(m, ix, o, r, wv, k, n_chunks);
      break;
    case OP_ANDNOT:
      gather_count_multi_kernel<OP_ANDNOT><<<grid, block, 0, st>>>(m, ix, o, r, wv, k, n_chunks);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
