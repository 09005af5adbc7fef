// gather_count2: out[q] = sum_s popcount(op(rm[s, p0], rm[s, p1])), gathering
// the two operand rows per (pair, slice).
//
// Replaces the Pallas kernel fused_gather_count2
// (pilosa_tpu/ops/pallas_kernels.py _gather_count_kernel), the pair
// lane when the row working set is tall next to the batch (R >= 2B) or
// the Gram is off.
//
// Bound on this card: bytes — two rows of W words per (pair, slice).
// Design: one block per (pair, slice); the block reads its two row ids
// from global memory (the TPU kernel needed them scalar-prefetched into
// SMEM, which capped its batch; here any batch size works), streams the
// two rows with 16-byte loads, and ends with one atomicAdd into the
// int32 out[q] (zeroed by the wrapper).  The TPU grid summed the slice
// axis in a resident output tile; here slices are parallel blocks.

#include "common.cuh"

namespace {

template <int OP>
__global__ void __launch_bounds__(256) gather_count2_kernel(
    const int4* __restrict__ rm, const int* __restrict__ pairs, int* __restrict__ out,
    int n_rows, int wv) {
  const int q = blockIdx.x;
  const long long s = blockIdx.y;
  const int4* a = rm + (s * n_rows + pairs[2 * q]) * wv;
  const int4* b = rm + (s * n_rows + pairs[2 * q + 1]) * wv;
  int acc = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < wv; i += blockDim.x) acc += popc_op4<OP>(a[i], b[i]);
  acc = block_sum(acc);
  if (threadIdx.x == 0 && acc) atomicAdd(out + q, acc);
}

}  // namespace

// rm: int32[s, r, w]; pairs: int32[b, 2] (ids < r); out: int32[b], zeroed.
extern "C" int pk_gather_count2(const void* rm, const void* pairs, void* out, int s, int r,
                                int w, int b, int op, void* stream) {
  if (s <= 0 || b <= 0) return (int)cudaSuccess;
  const dim3 grid(b, s);
  const dim3 block(256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PK_DISPATCH_OP(op, gather_count2_kernel<OPC><<<grid, block, 0, st>>>(
                         static_cast<const int4*>(rm), static_cast<const int*>(pairs),
                         static_cast<int*>(out), r, w / 4));
  return (int)cudaGetLastError();
}
