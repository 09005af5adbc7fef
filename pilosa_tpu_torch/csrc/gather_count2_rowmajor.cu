// gather_count2_rowmajor: out[q] = sum_s popcount(op(rm[p0, s], rm[p1, s])) over
// a ROW-MAJOR matrix rm[R, S, W]: row p's S slices are S*W contiguous words at
// p*S*W.
//
// Replaces the Pallas kernel fused_gather_count2_rowmajor
// (pilosa_tpu/ops/pallas_kernels.py _gather_rowmajor_kernel): the pair
// groups of the executor's "rmgather" lane (pool paging and slice
// streaming of working sets that are tall next to their batch).
//
// Bound on this card: bytes — two rows of W words per (pair, slice), about
// three integer ops per word.  The TPU kernel moved each operand row (all
// slices) in one DMA descriptor into a depth-deep VMEM pipeline, because
// the v5e DMA engine handles descriptors serially; this card has no such
// limit, so the design is the slice-major gather kernel's with the row
// stride changed: one block per (pair, slice), the block's two row ids read
// from global memory (any batch), 16-byte loads, a block sum and one integer
// atomicAdd into the zeroed int32 out[q] (exact in any order).  blockIdx.x
// walks the pairs and blockIdx.y the slices, so the blocks in flight
// together read one slice and a row named by several pairs is served from
// the 50 MB L2.
//
// Counts are int32 per query: callers keep S <= 2047 (a full-density
// count is S * 2^20 bits).

#include "common.cuh"

namespace {

template <int OP>
__global__ void __launch_bounds__(256) gather_count2_rowmajor_kernel(
    const int4* __restrict__ rm, const int* __restrict__ pairs, int* __restrict__ out,
    int n_slices, int wv) {
  const int q = blockIdx.x;
  const long long s = blockIdx.y;
  const int4* a = rm + ((long long)pairs[2 * q] * n_slices + s) * wv;
  const int4* b = rm + ((long long)pairs[2 * q + 1] * n_slices + s) * wv;
  int acc = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < wv; i += blockDim.x) acc += popc_op4<OP>(a[i], b[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0 && acc) atomicAdd(out + q, acc);
}

}  // namespace

// rm: int32[r, s, w] (w % 4 == 0, 16-byte aligned); pairs: int32[b, 2]
// (ids < r); out: int32[b], zeroed.  s <= 65535.
extern "C" int pk_gather_count2_rowmajor(const void* rm, const void* pairs, void* out, int r,
                                         int s, int w, int b, int op, void* stream) {
  if (s <= 0 || b <= 0 || r <= 0) return (int)cudaSuccess;
  if (s > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid(b, s);
  const dim3 block(256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PK_DISPATCH_OP(op, gather_count2_rowmajor_kernel<OPC><<<grid, block, 0, st>>>(
                         static_cast<const int4*>(rm), static_cast<const int*>(pairs),
                         static_cast<int*>(out), s, w / 4));
  return (int)cudaGetLastError();
}
