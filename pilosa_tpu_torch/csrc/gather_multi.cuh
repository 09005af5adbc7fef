// The gather multi fold shared by gather_count_multi.cu (slice-major
// [S, R, W]) and gather_count_multi_rowmajor.cu (row-major [R, S, W]):
// out[q] = sum_s popcount(fold_j row(idx[q, j], s)) for a left fold of K
// rows per query (and / or / andnot, where andnot folds acc & ~row for
// every operand after the first); the two layouts differ only in the
// strides the entry points pass.
//
// Bound on this card: bytes — each distinct row's slices read once.
// Design: block (c, q, s) owns query q's word chunk c of slice s, 256
// threads x NV int4 vectors (NV = 4: 4,096 words), accumulators in
// registers while the block walks the query's K ids, staged in shared
// memory a tile of 1024 ids at a time (any B and K in one launch; the TPU
// kernels scalar-prefetched ids into SMEM, which capped the batch).  At
// the end popc, a block sum and one integer atomicAdd into the zeroed
// out[q]: exact in any order.  (Loading two operands at a time was tried
// and dropped: no faster at the paths' shapes, and slower on a wide
// Union's 25-slice chunk; PERF.md.)
//
// Block order: chunk-major (blockIdx.x = c * B + q, blockIdx.y = s), so
// the blocks in flight together read one (slice, chunk) of every query:
// their working set is the batch's distinct rows x 16 KiB (16 MiB at
// 1,024 rows), which the 50 MB L2 holds, and a row named by several
// queries is read from device memory about once.  (A query-major order
// put a query's whole slice in flight at once: a slice of 1,024 rows is
// 128 MiB, and L2 evicted a row before the queries that named it again
// came round.)
// Grid width: a small batch over few slices (one wide Union streamed a
// few slices at a time) can give fewer blocks than SMs at 4,096-word
// chunks; the launch then narrows the chunk (NV = 2, 1) so that every SM
// keeps loads in flight (the wide Union's last chunk of 7 slices: 56
// blocks of 4,096 words, 224 of 1,024; PERF.md).
//
// Padded and unpadded id lists give the same count: the kernel folds every
// id it is given, and the executor pads with ids whose repeat the fold
// ignores (and / or: any operand; andnot: any operand after the first).

#pragma once

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;          // int4 vectors per thread per chunk, at most
constexpr int kIdTile = 1024;    // ids staged in shared memory at a time

template <int OP, int NV>
__global__ void __launch_bounds__(kThreads) gather_multi_kernel(
    const int4* __restrict__ rm, const int* __restrict__ idx, int* __restrict__ out,
    long long row_stride, long long slice_stride, int wv, int k, int n_queries) {
  __shared__ int ids[kIdTile];
  const int c = blockIdx.x / n_queries;
  const int q = blockIdx.x - c * n_queries;
  const int4* slice = rm + (long long)blockIdx.y * slice_stride;
  const int v0 = c * kThreads * NV + threadIdx.x;
  const int* qids = idx + (long long)q * k;

  // Row id's chunk c in this slice, NV int4 a thread (zeros past the row).
  auto load = [&](int id, int4* x) {
    const int4* row = slice + (long long)id * row_stride;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int i = v0 + v * kThreads;
      x[v] = i < wv ? row[i] : make_int4(0, 0, 0, 0);
    }
  };
  int4 acc[NV];
  for (int t0 = 0; t0 < k; t0 += kIdTile) {
    const int tn = min(kIdTile, k - t0);
    __syncthreads();  // the previous tile's ids are consumed
    for (int i = threadIdx.x; i < tn; i += kThreads) ids[i] = qids[t0 + i];
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      int4 x[NV];
      load(ids[j], x);
      if (t0 + j == 0) {  // the query's first operand starts the fold
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[v] = x[v];
      } else {
#pragma unroll
        for (int v = 0; v < NV; ++v) acc[v] = op4<OP>(acc[v], x[v]);
      }
    }
  }
  int part = 0;
#pragma unroll
  for (int v = 0; v < NV; ++v) part += popc4(acc[v]);
  part = block_sum(part);
  if (threadIdx.x == 0 && part) atomicAdd(out + q, part);
}

// Launch over s slices of wv int4 a row; strides in int4 units.
inline int launch_gather_multi(const void* rm, const void* idx, void* out, long long row_stride,
                               long long slice_stride, int s, int wv, int b, int k, int op,
                               void* stream) {
  if (s <= 0 || b <= 0 || wv <= 0) return (int)cudaSuccess;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  if (s > 65535) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  int nv = kVec;
  auto blocks = [&](int n) { return (long long)b * ((wv + kThreads * n - 1) / (kThreads * n)) * s; };
  while (nv > 1 && blocks(nv) < sms) nv >>= 1;
  const long long gx = blocks(nv) / s;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* m = static_cast<const int4*>(rm);
  const int* ix = static_cast<const int*>(idx);
  int* o = static_cast<int*>(out);
#define PK_GATHER_MULTI(O, N) \
  gather_multi_kernel<O, N><<<grid, kThreads, 0, st>>>(m, ix, o, row_stride, slice_stride, wv, k, b)
#define PK_GATHER_MULTI_NV(O) \
  if (nv == 4) PK_GATHER_MULTI(O, 4); \
  else if (nv == 2) PK_GATHER_MULTI(O, 2); \
  else PK_GATHER_MULTI(O, 1)
  switch (op) {
    case OP_AND: { PK_GATHER_MULTI_NV(OP_AND); } break;
    case OP_OR: { PK_GATHER_MULTI_NV(OP_OR); } break;
    case OP_ANDNOT: { PK_GATHER_MULTI_NV(OP_ANDNOT); } break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PK_GATHER_MULTI_NV
#undef PK_GATHER_MULTI
  return (int)cudaGetLastError();
}

}  // namespace
