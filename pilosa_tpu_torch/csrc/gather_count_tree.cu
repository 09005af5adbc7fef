// gather_count_tree: out[q] = sum_s popcount(tree_q(rm[s, leaves[q, 0..K)]))
// for a PERFECT binary expression tree per query: K = 2^D leaf rows
// (in order) and K - 1 node opcodes, level-major bottom-up.  Opcodes
// 0-3 are and / or / xor / andnot (a & ~b); any other value passes the
// left child unchanged (TREE_PASS = 4 pads any shape to a perfect tree).
//
// Replaces the Pallas kernel fused_gather_count_tree
// (pilosa_tpu/ops/pallas_kernels.py _gather_tree_kernel): Counts of
// nested Intersect / Union / Xor / Difference trees and of multi-operand
// Xor, one launch per depth bucket.
//
// Bound on this card: bytes — K rows of W words per (query, slice).
// Design: K is a template parameter (2, 4, 8, 16: depths 1-4).  Block
// (q, c, s) owns query q's word chunk c of slice s (256 threads x 4 int4
// vectors = 4096 words) and stages the query's K leaf ids and K - 1
// opcodes in shared memory once.  Per int4 vector a thread issues its K
// leaf loads together (K independent 16-byte loads in flight), folds the
// tree level by level in registers (the opcode is the same for every
// thread of the block, so the branch on it never diverges), and popcounts
// the root.  Then a block sum and one integer atomicAdd into out[q]
// (zeroed by the wrapper).  The TPU kernel DMA'd one leaf row per grid
// step into a VMEM buffer and folded at the last leaf; here the leaves are
// registers and (query, chunk, slice) are parallel blocks.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;
constexpr int kChunkVec = kThreads * kVec;

__device__ __forceinline__ int4 tree_op4(int o, int4 a, int4 b) {
  switch (o) {
    case 0: return op4<OP_AND>(a, b);
    case 1: return op4<OP_OR>(a, b);
    case 2: return op4<OP_XOR>(a, b);
    case 3: return op4<OP_ANDNOT>(a, b);
    default: return a;  // TREE_PASS and any other value: the left child
  }
}

// Fold N values in place to vals[0], one level per instantiation; ops
// points at this level's N / 2 opcodes, the next level's follow them.
template <int N>
struct Fold {
  static __device__ __forceinline__ void run(int4* vals, const int* ops) {
#pragma unroll
    for (int t = 0; t < N / 2; ++t) vals[t] = tree_op4(ops[t], vals[2 * t], vals[2 * t + 1]);
    Fold<N / 2>::run(vals, ops + N / 2);
  }
};

template <>
struct Fold<1> {
  static __device__ __forceinline__ void run(int4*, const int*) {}
};

template <int K>
__global__ void __launch_bounds__(kThreads) gather_count_tree_kernel(
    const int4* __restrict__ rm, const int* __restrict__ leaves, const int* __restrict__ opc,
    int* __restrict__ out, int n_rows, int wv, int n_chunks) {
  __shared__ int lv[K];
  __shared__ int oc[K];
  const int q = blockIdx.x / n_chunks;
  const int c = blockIdx.x - q * n_chunks;
  if (threadIdx.x < K) lv[threadIdx.x] = leaves[(long long)q * K + threadIdx.x];
  if (threadIdx.x < K - 1) oc[threadIdx.x] = opc[(long long)q * (K - 1) + threadIdx.x];
  __syncthreads();

  // Row offsets and opcodes are read from shared memory where they are
  // used (one broadcast load each), which keeps the K = 16 fold's
  // registers for its 16 leaf vectors.
  const long long slice_base = (long long)blockIdx.y * n_rows;
  int part = 0;
  const int v0 = c * kChunkVec + threadIdx.x;
#pragma unroll 1
  for (int v = 0; v < kVec; ++v) {
    const int i = v0 + v * kThreads;
    if (i < wv) {
      int4 vals[K];
#pragma unroll
      for (int j = 0; j < K; ++j) vals[j] = rm[(slice_base + lv[j]) * wv + i];
      Fold<K>::run(vals, oc);
      part += popc4(vals[0]);
    }
  }
  part = block_sum(part);
  if (threadIdx.x == 0 && part) atomicAdd(out + q, part);
}

template <int K>
int launch(const void* rm, const void* leaves, const void* opc, void* out, int s, int r, int wv,
           int b, cudaStream_t st) {
  const int n_chunks = (wv + kChunkVec - 1) / kChunkVec;
  const long long gx = (long long)b * n_chunks;
  if (gx > 0x7fffffffLL || s > 65535) return (int)cudaErrorInvalidConfiguration;
  gather_count_tree_kernel<K><<<dim3((unsigned)gx, s), dim3(kThreads), 0, st>>>(
      static_cast<const int4*>(rm), static_cast<const int*>(leaves),
      static_cast<const int*>(opc), static_cast<int*>(out), r, wv, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// rm: int32[s, r, w] (w % 4 == 0, 16-byte aligned); leaves: int32[b, k]
// (ids < r); opc: int32[b, k - 1]; out: int32[b], zeroed.  k is 2, 4, 8
// or 16; s <= 65535.
extern "C" int pk_gather_count_tree(const void* rm, const void* leaves, const void* opc,
                                    void* out, int s, int r, int w, int b, int k,
                                    void* stream) {
  if (s <= 0 || b <= 0 || w <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int wv = w / 4;
  switch (k) {
    case 2: return launch<2>(rm, leaves, opc, out, s, r, wv, b, st);
    case 4: return launch<4>(rm, leaves, opc, out, s, r, wv, b, st);
    case 8: return launch<8>(rm, leaves, opc, out, s, r, wv, b, st);
    case 16: return launch<16>(rm, leaves, opc, out, s, r, wv, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
