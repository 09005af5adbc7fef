// gather_src_counts: out[s, k] = popcount(rm[s, pos[k]] & src[s]) for every
// (slice, candidate).
//
// Replaces the Pallas kernel fused_gather_src_counts
// (pilosa_tpu/ops/pallas_kernels.py _gather_src_counts_kernel), TopN's
// all-slice candidate scorer (the merged-id refetch across every slice).
//
// Bound on this card: bytes — one candidate row per (slice, candidate);
// each slice's src row is re-read by K blocks, from L2 after the first.
// Design: one block per (candidate, slice); the block reads its row id
// from global memory, streams the row and the slice's src with 16-byte
// loads, and writes out[s, k] directly — no cross-block reduction.

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256) gather_src_counts_kernel(
    const int4* __restrict__ rm, const int* __restrict__ pos, const int4* __restrict__ src,
    int* __restrict__ out, int n_rows, int wv, int k_total) {
  const int k = blockIdx.x;
  const long long s = blockIdx.y;
  const int4* a = rm + (s * n_rows + pos[k]) * wv;
  const int4* b = src + s * wv;
  int acc = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < wv; i += blockDim.x) acc += popc_op4<OP_AND>(a[i], b[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[s * k_total + k] = acc;
}

}  // namespace

// rm: int32[s, r, w]; pos: int32[k] (ids < r); src: int32[s, w];
// out: int32[s, k].
extern "C" int pk_gather_src_counts(const void* rm, const void* pos, const void* src, void* out,
                                    int s, int r, int w, int k, void* stream) {
  if (s <= 0 || k <= 0) return (int)cudaSuccess;
  const dim3 grid(k, s);
  const dim3 block(256);
  gather_src_counts_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(rm), static_cast<const int*>(pos), static_cast<const int4*>(src),
      static_cast<int*>(out), r, w / 4, k);
  return (int)cudaGetLastError();
}
