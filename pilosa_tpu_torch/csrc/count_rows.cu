// count_rows: out[m] = sum_w popcount(op(a[m, w], b[m, w])) for every row.
//
// Replaces the Pallas kernels fused_count1 (pilosa_tpu/ops/pallas_kernels.py
// _count1_kernel) and fused_count2 (_count2_kernel): the executor's
// sequential Count (engine.count over a [slices, W] stack) and TopN's
// single-slice candidate scoring (|row & src| against one shared src).
//
// Bound on this card: bytes.  One pass reads each row once (plus b,
// which is a single L2-resident row when shared) and does four popc per
// 16 bytes, far below the integer rate.  Design: one block per row,
// 16-byte vector loads with neighbouring threads on neighbouring
// addresses, a warp-shuffle + shared-memory block sum, one int32 store.
// b is per-row (b_stride = W) or shared (b_stride = 0).

#include "common.cuh"

namespace {

template <int OP>
__global__ void __launch_bounds__(256) count_rows_kernel(
    const int4* __restrict__ a, const int4* __restrict__ b, long long b_stride_v,
    int* __restrict__ out, int wv) {
  const long long row = blockIdx.x;
  const int4* ar = a + row * wv;
  const int4* br = (OP == OP_NONE) ? a : b + row * b_stride_v;
  int acc = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < wv; i += blockDim.x) {
    if (OP == OP_NONE) {
      acc += popc4(ar[i]);
    } else {
      acc += popc_op4<OP>(ar[i], br[i]);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) out[row] = acc;
}

}  // namespace

// a: int32[m, w]; b: int32[m, w] (b_stride_words = w), int32[w]
// (b_stride_words = 0), or null for OP_NONE; out: int32[m].
extern "C" int pk_count_rows(const void* a, const void* b, long long b_stride_words,
                             void* out, int m, int w, int op, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const int wv = w / 4;
  const dim3 grid(m);
  const dim3 block(256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PK_DISPATCH_OP(op, count_rows_kernel<OPC><<<grid, block, 0, st>>>(
                         static_cast<const int4*>(a), static_cast<const int4*>(b),
                         b_stride_words / 4, static_cast<int*>(out), wv));
  return (int)cudaGetLastError();
}
