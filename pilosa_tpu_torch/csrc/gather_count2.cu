// gather_count2: out[q] = sum_s popcount(op(rm[s, p0], rm[s, p1])), gathering
// the two operand rows per (pair, slice).
//
// Replaces the Pallas kernel fused_gather_count2
// (pilosa_tpu/ops/pallas_kernels.py _gather_count_kernel), the pair
// lane when the row working set is tall next to the batch (R >= 2B) or
// the Gram is off.
//
// Bound on this card: bytes — two rows of W words per (pair, slice).
// Design: a block sums one segment of one (pair, slice) row pair; the
// wrapper splits rows into segments (kernels.gather2_segments) until a
// small batch makes about two waves of blocks, so the last wave's tail
// is short (the first design ran one block per (pair, slice): 1,024
// blocks at B = 16, one wave and a tail).  Each thread keeps 8 16-byte
// loads in flight (4 vectors of each row) with 4 independent
// accumulators.  Blocks are ordered pair-fastest, then segment, then
// slice, so the pairs that name one row read each of its segments at
// about the same time and L2 serves the repeats.  Each block ends with
// one atomicAdd into the int32 out[q], which the entry point zeroes on
// the stream first.
//
// The path's batches are small (16 pairs or fewer), where the wrapper's
// host work outweighed the kernel: a batch of up to kParamPairs pairs
// travels in the launch's own parameters (a __grid_constant__ struct the
// blocks read from the constant bank), so the entry point allocates,
// pins and copies nothing for the ids.  A larger batch reads its ids
// from a device array.  (The TPU kernel needed its ids
// scalar-prefetched into SMEM, which capped its batch; here any batch
// size works.)

#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;          // vectors of each row a thread loads per step
constexpr int kParamPairs = 500;  // 4,000 bytes: under the 4 KiB parameter limit

struct PairList {
  int ids[2 * kParamPairs];
};

template <int OP>
__device__ __forceinline__ void pair_segment(const int4* __restrict__ rm, int p0, int p1,
                                             int* __restrict__ out, int q, long long s,
                                             int n_rows, int wv, int seg, int seg_vecs) {
  const int4* a = rm + (s * n_rows + p0) * wv;
  const int4* c = rm + (s * n_rows + p1) * wv;
  const int lo = seg * seg_vecs;
  const int hi = min(lo + seg_vecs, wv);
  int acc[kVecs] = {};
  for (int i = lo + threadIdx.x; i < hi; i += kVecs * kThreads) {
    int4 x[kVecs], y[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int j = i + u * kThreads;
      if (j < hi) {
        x[u] = __ldg(a + j);
        y[u] = __ldg(c + j);
      } else {
        x[u] = y[u] = make_int4(0, 0, 0, 0);  // every op of two zero words is 0
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) acc[u] += popc_op4<OP>(x[u], y[u]);
  }
  int v = 0;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) v += acc[u];
  v = block_sum(v);
  if (threadIdx.x == 0 && v) atomicAdd(out + q, v);
}

// Block -> (pair q, segment, slice), pair fastest.
__device__ __forceinline__ void block_coords(int b, int n_seg, int* q, int* seg, long long* s) {
  const long long blk = blockIdx.x;
  *q = (int)(blk % b);
  const long long rest = blk / b;
  *seg = (int)(rest % n_seg);
  *s = rest / n_seg;
}

template <int OP>
__global__ void __launch_bounds__(kThreads) gather_count2_params(
    const int4* __restrict__ rm, const __grid_constant__ PairList pl, int* __restrict__ out,
    int b, int n_rows, int wv, int n_seg, int seg_vecs) {
  int q, seg;
  long long s;
  block_coords(b, n_seg, &q, &seg, &s);
  pair_segment<OP>(rm, pl.ids[2 * q], pl.ids[2 * q + 1], out, q, s, n_rows, wv, seg, seg_vecs);
}

template <int OP>
__global__ void __launch_bounds__(kThreads) gather_count2_array(
    const int4* __restrict__ rm, const int* __restrict__ pairs, int* __restrict__ out, int b,
    int n_rows, int wv, int n_seg, int seg_vecs) {
  int q, seg;
  long long s;
  block_coords(b, n_seg, &q, &seg, &s);
  pair_segment<OP>(rm, pairs[2 * q], pairs[2 * q + 1], out, q, s, n_rows, wv, seg, seg_vecs);
}

}  // namespace

// rm: int32[s, r, w]; pairs: int32[b, 2] (ids < r) in HOST memory when b
// <= kParamPairs (copied into the launch), else on the device; out:
// int32[b], zeroed here on the stream; each row in n_seg segments of
// seg_vecs 16-byte vectors (kernels.gather2_segments).
extern "C" int pk_gather_count2(const void* rm, const void* pairs, void* out, int s, int r,
                                int w, int b, int op, int n_seg, int seg_vecs, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out, 0, (size_t)b * 4, st);
  if (e != cudaSuccess || s <= 0) return (int)e;
  const long long blocks = (long long)b * n_seg * s;
  if (n_seg <= 0 || seg_vecs <= 0 || (long long)n_seg * seg_vecs < w / 4 ||
      blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int4* m = static_cast<const int4*>(rm);
  int* o = static_cast<int*>(out);
  if (b <= kParamPairs) {
    PairList pl;
    memcpy(pl.ids, pairs, (size_t)b * 2 * sizeof(int));
    PK_DISPATCH_OP(op, gather_count2_params<OPC><<<(unsigned)blocks, kThreads, 0, st>>>(
                           m, pl, o, b, r, w / 4, n_seg, seg_vecs));
  } else {
    PK_DISPATCH_OP(op, gather_count2_array<OPC><<<(unsigned)blocks, kThreads, 0, st>>>(
                           m, static_cast<const int*>(pairs), o, b, r, w / 4, n_seg, seg_vecs));
  }
  return (int)cudaGetLastError();
}
