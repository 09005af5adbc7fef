// gather_count_multi_mixed: out[q] = sum_s popcount(fold_{op[q]} rm[s, ids[off[q] .. off[q+1])])
// for a batch whose queries each carry their own op (and / or / andnot,
// where andnot folds acc & ~row for every operand after the first) and
// their own K (CSR offsets into one id list), over a slice-major
// [S, R, W] or a row-major [R, S, W] matrix.
//
// Replaces no TPU kernel by itself: it folds into one launch the
// per-group launches of fused_gather_count_multi
// (pilosa_tpu/ops/pallas_kernels.py:554; the row-major form :490), which
// take one op and one K a launch, so a request of N-ary Counts made one
// launch and one fetch per (op, K) group, and a row named by two groups
// was read by two launches.  gather_count_multi.cu stays for the lanes
// that launch one group (the Range cover, the streaming regime).
//
// Bound on this card: bytes — each distinct row of the batch read once a
// slice.  Design (gather_multi.cuh's, over the whole batch):
// - Block (c, q, s) owns query q's word chunk c of slice s, chunk-major
//   over the batch (blockIdx.x = c * B + q, blockIdx.y = s): the blocks in
//   flight together read one (slice, chunk) of every query, whatever its
//   op and K, so a row that several queries name, in any group, is read
//   from device memory about once and L2 serves the repeats.
// - The op is read once a block; it is uniform over the block, so the
//   branch on it never diverges, and each op's fold is its own unrolled
//   loop (as gather_count_tree.cu branches on its opcodes).
// - The chunk narrows with the grid (NV = 4, 2, 1 int4 vectors a thread)
//   as launch_gather_multi does, so a small batch over few slices keeps
//   every SM loading.
// - A batch of up to kParamInts ints (B + 1 offsets, the ops packed 4
//   bits each into ceil(B / 8) words, then the ids) travels in the
//   launch's own parameters (a __grid_constant__ struct, as
//   gather_count_tree.cu carries its trees), and the entry zeroes out on
//   the stream itself: nothing is pinned, copied or allocated but out.  A
//   larger batch reads the same layout from one device array, where each
//   block's offsets are one more dependent load before its ids: 5.7-7.7%
//   slower at B = 64, K = 16 and B = 128, K = 23 than in the parameters.
//   So the struct is 16 KiB, as resident_count_multi.cu's (CUDA 12.1 takes
//   32,764 bytes of parameters), not the 4 KiB of the tree kernel's:
//   those batches fit it, and a launch's host time grew by at most 3 us
//   (PERF.md).

#include <string.h>

#include "gather_multi.cuh"

namespace {

constexpr int kParamInts = 4096;  // 16 KiB: under CUDA 12.1's 32,764 bytes of parameters

struct MixedList {
  int ints[kParamInts];
};

// One query's fold over its k ids (qids) at this thread's NV vectors of
// the block's chunk of one slice; the thread's popcount of the result.
// ids: the block's shared tile of staged ids.
template <int OP, int NV>
__device__ __forceinline__ int fold_popc(const int4* __restrict__ slice, const int* qids, int k,
                                         int* ids, int v0, int wv, long long row_stride) {
  int4 acc[NV];
  for (int t0 = 0; t0 < k; t0 += kIdTile) {
    const int tn = min(kIdTile, k - t0);
    __syncthreads();  // the previous tile's ids are consumed
    for (int i = threadIdx.x; i < tn; i += kThreads) ids[i] = qids[t0 + i];
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      const int4* row = slice + (long long)ids[j] * row_stride;
      int4 x[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        const int i = v0 + v * kThreads;
        x[v] = i < wv ? row[i] : make_int4(0, 0, 0, 0);
      }
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
  return part;
}

// One block's work.  ints: off[B + 1], ceil(B / 8) op words, ids.
template <int NV>
__device__ __forceinline__ void mixed_chunk(const int4* __restrict__ rm, const int* ints,
                                            int* __restrict__ out, long long row_stride,
                                            long long slice_stride, int wv, int b) {
  __shared__ int ids[kIdTile];
  const int c = blockIdx.x / b;
  const int q = blockIdx.x - c * b;
  const int k0 = ints[q];
  const int k = ints[q + 1] - k0;
  const unsigned op = ((unsigned)ints[b + 1 + (q >> 3)] >> (4 * (q & 7))) & 15u;
  const int* qids = ints + (b + 1) + ((b + 7) >> 3) + k0;
  const int4* slice = rm + (long long)blockIdx.y * slice_stride;
  const int v0 = c * kThreads * NV + threadIdx.x;
  int part;
  switch (op) {
    case OP_AND: part = fold_popc<OP_AND, NV>(slice, qids, k, ids, v0, wv, row_stride); break;
    case OP_OR: part = fold_popc<OP_OR, NV>(slice, qids, k, ids, v0, wv, row_stride); break;
    default: part = fold_popc<OP_ANDNOT, NV>(slice, qids, k, ids, v0, wv, row_stride); break;
  }
  part = block_sum(part);
  if (threadIdx.x == 0 && part) atomicAdd(out + q, part);
}

template <int NV>
__global__ void __launch_bounds__(kThreads) gather_multi_mixed_params(
    const int4* __restrict__ rm, const __grid_constant__ MixedList ml, int* __restrict__ out,
    long long row_stride, long long slice_stride, int wv, int b) {
  mixed_chunk<NV>(rm, ml.ints, out, row_stride, slice_stride, wv, b);
}

template <int NV>
__global__ void __launch_bounds__(kThreads) gather_multi_mixed_array(
    const int4* __restrict__ rm, const int* __restrict__ ints, int* __restrict__ out,
    long long row_stride, long long slice_stride, int wv, int b) {
  mixed_chunk<NV>(rm, ints, out, row_stride, slice_stride, wv, b);
}

template <int NV>
int launch(const int4* rm, const void* ints, int n_ints, int* out, long long row_stride,
           long long slice_stride, int s, int wv, int b, cudaStream_t st) {
  const long long gx = (long long)b * ((wv + kThreads * NV - 1) / (kThreads * NV));
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, s);
  if (n_ints <= kParamInts) {
    MixedList ml;
    memcpy(ml.ints, ints, (size_t)n_ints * sizeof(int));
    gather_multi_mixed_params<NV><<<grid, kThreads, 0, st>>>(rm, ml, out, row_stride,
                                                             slice_stride, wv, b);
  } else {
    gather_multi_mixed_array<NV><<<grid, kThreads, 0, st>>>(
        rm, static_cast<const int*>(ints), out, row_stride, slice_stride, wv, b);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rm: int32[s, r, w] (row_major 0) or int32[r, s, w] (row_major 1), w % 4
// == 0, 16-byte aligned; ints: int32[n_ints] = off[b + 1] (off[0] = 0,
// each query's K >= 1, ids < r), then ceil(b / 8) words of 4-bit op codes
// (query q's in bits 4 (q % 8) of word q / 8: OP_AND, OP_OR or OP_ANDNOT,
// common.cuh), then the ids, in HOST memory when n_ints <= kParamInts
// (copied into the launch), else on the device; out: int32[b], zeroed
// here on the stream.  s <= 65535.
extern "C" int pk_gather_count_multi_mixed(const void* rm, const void* ints, void* out, int s,
                                           int r, int w, int b, int n_ints, int row_major,
                                           void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  cudaError_t e = cudaMemsetAsync(o, 0, (size_t)b * 4, st);
  if (e != cudaSuccess || s <= 0 || w <= 0) return (int)e;
  if (s > 65535) return (int)cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int wv = w / 4;
  const long long row_stride = row_major ? (long long)s * wv : wv;
  const long long slice_stride = row_major ? wv : (long long)r * wv;
  int nv = kVec;
  auto blocks = [&](int n) { return (long long)b * ((wv + kThreads * n - 1) / (kThreads * n)) * s; };
  while (nv > 1 && blocks(nv) < sms) nv >>= 1;
  const int4* m = static_cast<const int4*>(rm);
  if (nv == 4) return launch<4>(m, ints, n_ints, o, row_stride, slice_stride, s, wv, b, st);
  if (nv == 2) return launch<2>(m, ints, n_ints, o, row_stride, slice_stride, s, wv, b, st);
  return launch<1>(m, ints, n_ints, o, row_stride, slice_stride, s, wv, b, st);
}
