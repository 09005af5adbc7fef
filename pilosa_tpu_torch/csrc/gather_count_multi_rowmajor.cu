// gather_count_multi_rowmajor: out[q] = sum_s popcount(fold_j rm[idx[q, j], s])
// for a left fold of K rows per query over a ROW-MAJOR matrix rm[R, S, W]
// (row p's S slices are S*W contiguous words at p*S*W); fold and / or /
// andnot, where andnot folds acc & ~row for every operand after the first.
//
// Replaces the Pallas kernel fused_gather_count_multi_rowmajor
// (pilosa_tpu/ops/pallas_kernels.py _gather_multi_rowmajor_kernel): the
// N-ary groups of the executor's "rmgather" lane (pool paging and slice
// streaming — one Count over more operands than the pool holds streams its
// slices through row-major transients).  The TPU kernel buffered K whole
// rows (all slices) per pipeline slot in VMEM, which bounded K * S * W;
// here no row is buffered whole.  Bound and design: gather_multi.cuh
// (shared with the slice-major fold).  Counts are int32 per query:
// callers keep S <= 2047.

#include "gather_multi.cuh"

// rm: int32[r, s, w] (w % 4 == 0, 16-byte aligned); idx: int32[b, k]
// (ids < r, k >= 1); out: int32[b], zeroed.  op: OP_AND, OP_OR or
// OP_ANDNOT (common.cuh).  s <= 65535.
extern "C" int pk_gather_count_multi_rowmajor(const void* rm, const void* idx, void* out, int r,
                                              int s, int w, int b, int k, int op, void* stream) {
  if (r <= 0) return (int)cudaSuccess;
  const int wv = w / 4;
  return launch_gather_multi(rm, idx, out, (long long)s * wv, wv, s, wv, b, k, op, stream);
}
