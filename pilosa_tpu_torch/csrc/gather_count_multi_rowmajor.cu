// gather_count_multi_rowmajor: out[q] = sum_s popcount(fold_j rm[idx[q, j], s])
// for a left fold of K rows per query over a ROW-MAJOR matrix rm[R, S, W]
// (row p's S slices are S*W contiguous words at p*S*W); fold and / or /
// andnot, where andnot folds acc & ~row for every operand after the first.
//
// Replaces the Pallas kernel fused_gather_count_multi_rowmajor
// (pilosa_tpu/ops/pallas_kernels.py _gather_multi_rowmajor_kernel): the
// N-ary groups of the executor's "rmgather" lane (pool paging and slice
// streaming — one Count over more operands than the pool holds streams its
// slices through row-major transients).
//
// Bound on this card: bytes — K rows of W words per (query, slice).  The
// TPU kernel buffered K whole rows (all slices) per pipeline slot in VMEM,
// which bounded K * S * W; here no row is buffered whole.  Design (as
// gather_count_multi.cu, with the row stride of the row-major layout):
// block (q, c, s) owns query q's word chunk c of slice s, 256 threads x 4
// int4 vectors = 4096 words, accumulators in registers while the block
// walks the query's K ids, staged in shared memory a tile of 1024 ids at a
// time (any B and K in one launch).  At the end popc, a block sum and one
// integer atomicAdd into the zeroed out[q].  blockIdx.y is the slice, so
// the blocks in flight together read one slice, and rows named by several
// queries are served from the 50 MB L2.
//
// Padded and unpadded id lists give the same count: the kernel folds every
// id it is given, and the executor pads with ids whose repeat the fold
// ignores.  Counts are int32 per query: callers keep S <= 2047.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // int4 vectors per thread per chunk
constexpr int kIdTile = 1024;    // ids staged in shared memory at a time
constexpr int kChunkVec = kThreads * kVec;

template <int OP>
__global__ void __launch_bounds__(kThreads) gather_count_multi_rowmajor_kernel(
    const int4* __restrict__ rm, const int* __restrict__ idx, int* __restrict__ out,
    int n_slices, int wv, int k, int n_chunks) {
  __shared__ int ids[kIdTile];
  const int q = blockIdx.x / n_chunks;
  const int c = blockIdx.x - q * n_chunks;
  const long long s = blockIdx.y;
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
      const int4* row = rm + ((long long)ids[j] * n_slices + s) * wv;
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

// rm: int32[r, s, w] (w % 4 == 0, 16-byte aligned); idx: int32[b, k]
// (ids < r, k >= 1); out: int32[b], zeroed.  op: OP_AND, OP_OR or
// OP_ANDNOT (common.cuh).  s <= 65535.
extern "C" int pk_gather_count_multi_rowmajor(const void* rm, const void* idx, void* out, int r,
                                              int s, int w, int b, int k, int op, void* stream) {
  if (s <= 0 || b <= 0 || w <= 0 || r <= 0) return (int)cudaSuccess;
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
      gather_count_multi_rowmajor_kernel<OP_AND><<<grid, block, 0, st>>>(m, ix, o, s, wv, k,
                                                                         n_chunks);
      break;
    case OP_OR:
      gather_count_multi_rowmajor_kernel<OP_OR><<<grid, block, 0, st>>>(m, ix, o, s, wv, k,
                                                                        n_chunks);
      break;
    case OP_ANDNOT:
      gather_count_multi_rowmajor_kernel<OP_ANDNOT><<<grid, block, 0, st>>>(m, ix, o, s, wv, k,
                                                                            n_chunks);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
