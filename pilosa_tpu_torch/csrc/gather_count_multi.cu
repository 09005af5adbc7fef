// gather_count_multi: out[q] = sum_s popcount(fold_j rm[s, idx[q, j]]) for a
// left fold of K gathered rows per query over a slice-major matrix
// rm[S, R, W] (fold and / or / andnot, where andnot folds acc & ~row for
// every operand after the first).
//
// Replaces the Pallas kernel fused_gather_count_multi (and its OR wrapper
// fused_gather_count_or) in pilosa_tpu/ops/pallas_kernels.py
// (_gather_multi_kernel): Counts of N-operand Intersect / Union /
// Difference, and the time-quantum Range cover (an OR over the cover's
// (view, row) rows of the multi-view matrix).  The TPU grid walked
// (query, slice, operand) in order with a VMEM accumulator; here the
// operand loop is the block's own loop and (chunk, query, slice) are
// parallel blocks.  Bound and design: gather_multi.cuh (shared with the
// row-major fold).  Batches that name their rows many times take the
// staged variant, resident_count_multi.cu (dispatch.multi_strategy).

#include "gather_multi.cuh"

// rm: int32[s, r, w] (w % 4 == 0, 16-byte aligned); idx: int32[b, k]
// (ids < r, k >= 1); out: int32[b], zeroed.  op: OP_AND, OP_OR or
// OP_ANDNOT (common.cuh).  s <= 65535.
extern "C" int pk_gather_count_multi(const void* rm, const void* idx, void* out, int s, int r,
                                     int w, int b, int k, int op, void* stream) {
  const int wv = w / 4;
  return launch_gather_multi(rm, idx, out, wv, (long long)r * wv, s, wv, b, k, op, stream);
}
