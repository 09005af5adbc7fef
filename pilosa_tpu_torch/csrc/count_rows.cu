// count_rows: out[m] = sum_w popcount(op(a[m, w], b[m, w])) for every row.
//
// Replaces the Pallas kernels fused_count1 (pilosa_tpu/ops/pallas_kernels.py
// _count1_kernel) and fused_count2 (_count2_kernel): the executor's
// sequential Count (engine.count over a [slices, W] stack) and TopN's
// single-slice candidate scoring (|row & src| against one shared src).
//
// Bound on this card: bytes.  One pass reads each row once (plus b,
// which is a single L2-resident row when shared) and does four popc per
// 16 bytes, far below the integer rate.
// Design: the paths' stacks are short ([64, W] for a Count over 64
// slices, [256, W] for TopN's candidates), and one block a row left most
// SMs idle ([64, W]: 64 blocks on 132 SMs) and each block walking 128 KiB
// alone.  So a block owns one (row, segment) unit: the wrapper splits
// every row into n_seg segments of seg_vecs 16-byte vectors
// (kernels.count_rows_segments) until the units cover two waves of the
// SMs, a segment never shorter than one block step.  A step is 256
// threads x 8 vectors: each thread issues 8 independent 16-byte loads of
// a (and 8 of b), neighbouring threads on neighbouring addresses, before
// it counts them into 8 accumulators.  A block sum ends each unit: a row
// of one segment stores out[m]; a split row's segments add into out[m] by
// integer atomicAdd (exact in any order), which the C entry zeroes on the
// stream first.  b is per row (b_stride = W) or shared (b_stride = 0).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 8;  // 16-byte vectors of each operand a thread loads per step

template <int OP>
__global__ void __launch_bounds__(kThreads) count_rows_kernel(
    const int4* __restrict__ a, const int4* __restrict__ b, long long b_stride_v,
    int* __restrict__ out, int wv, int n_seg, int seg_vecs) {
  const long long row = blockIdx.x / n_seg;
  const int seg = blockIdx.x - (int)(row * n_seg);
  const int4* ar = a + row * wv;
  const int4* br = (OP == OP_NONE) ? a : b + row * b_stride_v;
  const int lo = seg * seg_vecs;
  const int hi = min(lo + seg_vecs, wv);
  int acc[kVecs] = {};
  for (int i = lo + threadIdx.x; i < hi; i += kVecs * kThreads) {
    int4 x[kVecs], y[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int j = i + u * kThreads;
      const bool in = j < hi;
      x[u] = in ? __ldg(ar + j) : make_int4(0, 0, 0, 0);  // every op of two zero words is 0
      if (OP != OP_NONE) y[u] = in ? __ldg(br + j) : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) acc[u] += OP == OP_NONE ? popc4(x[u]) : popc_op4<OP>(x[u], y[u]);
  }
  int v = 0;
#pragma unroll
  for (int u = 0; u < kVecs; ++u) v += acc[u];
  v = block_sum(v);
  if (threadIdx.x == 0) {
    if (n_seg == 1) {
      out[row] = v;
    } else if (v) {
      atomicAdd(out + row, v);
    }
  }
}

}  // namespace

// a: int32[m, w]; b: int32[m, w] (b_stride_words = w), int32[w]
// (b_stride_words = 0), or null for OP_NONE; out: int32[m], zeroed here
// on the stream when a row takes more than one segment; each row in n_seg
// segments of seg_vecs 16-byte vectors (kernels.count_rows_segments).
extern "C" int pk_count_rows(const void* a, const void* b, long long b_stride_words, void* out,
                             int m, int w, int op, int n_seg, int seg_vecs, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const long long blocks = (long long)m * n_seg;
  if (n_seg <= 0 || seg_vecs <= 0 || (long long)n_seg * seg_vecs < w / 4 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_seg > 1) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)m * 4, st);
    if (e != cudaSuccess) return (int)e;
  }
  PK_DISPATCH_OP(op, count_rows_kernel<OPC><<<(unsigned)blocks, kThreads, 0, st>>>(
                         static_cast<const int4*>(a), static_cast<const int4*>(b),
                         b_stride_words / 4, static_cast<int*>(out), w / 4, n_seg, seg_vecs));
  return (int)cudaGetLastError();
}
