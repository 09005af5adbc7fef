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
// Bound on this card: bytes — the distinct rows that the LIVE leaves
// name, each slice read once.  A leaf is dead when some node on its path
// to the root passes its left child and the leaf lies under the right
// one: its value never reaches the root.  The executor pads every tree to
// a perfect one with PASS nodes over a fill leaf (the 3-operand Xor has 3
// live leaves of 4, the depth-3 and depth-4 shapes of the paths 6 of 8
// and 8 of 16): of the 512 leaf loads of a batch of 64 nested Counts in
// those four shapes, 336 are live.  The fill is the tree's leftmost leaf,
// so its loads hit L1; dead leaves that name other rows (any PASS the
// encoding did not put there) cost L2 and device-memory bytes.
//
// Design:
// - Only live leaves are loaded.  Warp 0 of each block derives its tree's
//   live-leaf mask once from the K - 1 opcodes (lane j walks leaf j's
//   path: the root is live, a PASS node's right child is dead, and so is
//   everything under a dead node) and leaves it in shared memory with the
//   leaf rows.  A dead leaf's loads are branched around (the mask is the
//   same for every thread of the block, so no branch diverges) and its
//   registers hold zeros, which only a PASS node ever sees.  The mirror
//   of the rule is kernels.tree_live_leaves.
// - Block (c, q, s) owns word chunk c (4,096 words: 256 threads x 4 int4
//   vectors) of query q in slice s, chunk-major (blockIdx.x = c * B + q,
//   as csrc/gather_multi.cuh orders its folds): the blocks in flight
//   together read one chunk of every query of a slice, so a row named by
//   several trees is read from device memory about once and L2 serves
//   the repeats.
// - Each thread keeps up to 16 leaf vectors in flight: NV = 16 / K
//   vectors of each leaf at once (at most 4), so K = 2-4 trees still
//   issue 8-16 independent 16-byte loads before they fold.  The tree
//   folds level by level in registers (the opcode is uniform over the
//   block, so the branch on it never diverges), the root is popcounted,
//   and each block ends with one integer atomicAdd into out[q], which the
//   C entry zeroes on the stream first.
// - The paths' batches are small (2-128 trees), where the wrapper's host
//   work outweighed the kernel: a batch of up to kParamInts ints (B x K
//   leaf ids, then two opcode words a tree, 4 bits an opcode) travels in
//   the launch's own parameters (a __grid_constant__ struct), so the
//   entry point allocates, pins and copies nothing.  A larger batch reads
//   the same layout from one device array.  (The TPU kernel DMA'd one
//   leaf row per grid step into VMEM and scalar-prefetched the ids.)

#include <string.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunkVecs = 4;                   // int4 vectors of a leaf a thread covers per chunk
constexpr int kChunk = kThreads * kChunkVecs;   // 1,024 vectors: 4,096 words
constexpr int kLoadsInFlight = 16;              // leaf vectors a thread loads before it folds
constexpr int kParamInts = 1000;                // 4,000 bytes: under the 4 KiB parameter limit

struct TreeList {
  int ints[kParamInts];
};

// Opcode i of a tree whose opcodes are packed 4 bits each, i % 8 in word
// i / 8; every value but 0-3 was packed as TREE_PASS.
__device__ __forceinline__ unsigned op_at(int i, unsigned w0, unsigned w1) {
  return (i < 8 ? w0 >> (4 * i) : w1 >> (4 * (i - 8))) & 15u;
}

__device__ __forceinline__ int4 tree_op4(unsigned o, int4 a, int4 b) {
  switch (o) {
    case 0: return op4<OP_AND>(a, b);
    case 1: return op4<OP_OR>(a, b);
    case 2: return op4<OP_XOR>(a, b);
    case 3: return op4<OP_ANDNOT>(a, b);
    default: return a;  // TREE_PASS: the left child
  }
}

// Whether leaf j of a K-leaf tree reaches the root: at each level l its
// ancestor is node j >> (l + 1) of that level, reached from the right
// when bit l of j is set, and a PASS node drops its right child.
template <int K>
__device__ __forceinline__ bool leaf_live(int j, unsigned w0, unsigned w1) {
  int off = 0;
#pragma unroll
  for (int n = K / 2, l = 0; n >= 1; n >>= 1, ++l) {
    if (((j >> l) & 1) && op_at(off + (j >> (l + 1)), w0, w1) > 3u) return false;
    off += n;
  }
  return true;
}

// Fold N leaves' NV vectors in place to v[0], one level per
// instantiation; this level's N / 2 opcodes start at index off.
template <int N, int NV>
struct Fold {
  static __device__ __forceinline__ void run(int4 (*v)[NV], int off, unsigned w0, unsigned w1) {
#pragma unroll
    for (int t = 0; t < N / 2; ++t) {
      const unsigned o = op_at(off + t, w0, w1);
#pragma unroll
      for (int u = 0; u < NV; ++u) v[t][u] = tree_op4(o, v[2 * t][u], v[2 * t + 1][u]);
    }
    Fold<N / 2, NV>::run(v, off + N / 2, w0, w1);
  }
};

template <int NV>
struct Fold<1, NV> {
  static __device__ __forceinline__ void run(int4 (*)[NV], int, unsigned, unsigned) {}
};

// One block's work.  ints: B x K leaf ids, then B x 2 opcode words.
template <int K>
__device__ __forceinline__ void tree_chunk(const int4* __restrict__ rm, const int* ints,
                                           int* __restrict__ out, int b, int n_rows, int wv) {
  constexpr int NV = kLoadsInFlight / K < kChunkVecs ? kLoadsInFlight / K : kChunkVecs;
  __shared__ long long row_off[K];
  __shared__ unsigned tree[3];  // live-leaf mask, opcode words 0 and 1
  const int q = blockIdx.x % b;
  const int c = blockIdx.x / b;
  if (threadIdx.x < 32) {
    const int* words = ints + (long long)b * K + 2 * q;
    const unsigned w0 = (unsigned)words[0], w1 = (unsigned)words[1];
    const int j = threadIdx.x;
    const unsigned live = __ballot_sync(0xffffffffu, j < K && leaf_live<K>(j, w0, w1));
    if (j < K) row_off[j] = (long long)ints[(long long)q * K + j] * wv;
    if (j == 0) {
      tree[0] = live;
      tree[1] = w0;
      tree[2] = w1;
    }
  }
  __syncthreads();
  const unsigned live = tree[0], w0 = tree[1], w1 = tree[2];
  const int4* slice = rm + (long long)blockIdx.y * n_rows * wv;
  const int v0 = c * kChunk + threadIdx.x;
  int part = 0;
#pragma unroll 1
  for (int it = 0; it < kChunkVecs / NV; ++it) {
    int4 v[K][NV];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int4* row = slice + row_off[j];
#pragma unroll
      for (int u = 0; u < NV; ++u) {
        const int i = v0 + (it * NV + u) * kThreads;
        // A branch on the leaf, not a predicate on each load: sixteen
        // per-load predicates overflow the predicate registers, and their
        // spills made K = 16 up to a fifth slower.
        if ((live >> j) & 1u) {
          v[j][u] = i < wv ? __ldg(row + i) : make_int4(0, 0, 0, 0);
        } else {
          v[j][u] = make_int4(0, 0, 0, 0);
        }
      }
    }
    Fold<K, NV>::run(v, 0, w0, w1);
#pragma unroll
    for (int u = 0; u < NV; ++u) part += popc4(v[0][u]);
  }
  part = block_sum(part);
  if (threadIdx.x == 0 && part) atomicAdd(out + q, part);
}

template <int K>
__global__ void __launch_bounds__(kThreads) gather_count_tree_params(
    const int4* __restrict__ rm, const __grid_constant__ TreeList tl, int* __restrict__ out, int b,
    int n_rows, int wv) {
  tree_chunk<K>(rm, tl.ints, out, b, n_rows, wv);
}

template <int K>
__global__ void __launch_bounds__(kThreads) gather_count_tree_array(
    const int4* __restrict__ rm, const int* __restrict__ ints, int* __restrict__ out, int b,
    int n_rows, int wv) {
  tree_chunk<K>(rm, ints, out, b, n_rows, wv);
}

template <int K>
int launch(const void* rm, const void* ints, int* out, int s, int r, int wv, int b,
           cudaStream_t st) {
  const long long gx = (long long)b * ((wv + kChunk - 1) / kChunk);
  if (gx > 0x7fffffffLL || s > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)gx, s);
  const int4* m = static_cast<const int4*>(rm);
  if ((long long)b * (K + 2) <= kParamInts) {
    TreeList tl;
    memcpy(tl.ints, ints, (size_t)b * (K + 2) * sizeof(int));
    gather_count_tree_params<K><<<grid, kThreads, 0, st>>>(m, tl, out, b, r, wv);
  } else {
    gather_count_tree_array<K><<<grid, kThreads, 0, st>>>(m, static_cast<const int*>(ints), out,
                                                            b, r, wv);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// rm: int32[s, r, w] (w % 4 == 0, 16-byte aligned); ints: int32[b * k]
// leaf ids (< r), then int32[b * 2] opcode words (kernels.tree_opcode_words),
// in HOST memory when b * (k + 2) <= kParamInts (copied into the launch),
// else on the device; out: int32[b], zeroed here on the stream.  k is 2,
// 4, 8 or 16; s <= 65535.
extern "C" int pk_gather_count_tree(const void* rm, const void* ints, void* out, int s, int r,
                                    int w, int b, int k, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  cudaError_t e = cudaMemsetAsync(o, 0, (size_t)b * 4, st);
  if (e != cudaSuccess || s <= 0 || w <= 0) return (int)e;
  const int wv = w / 4;
  switch (k) {
    case 2: return launch<2>(rm, ints, o, s, r, wv, b, st);
    case 4: return launch<4>(rm, ints, o, s, r, wv, b, st);
    case 8: return launch<8>(rm, ints, o, s, r, wv, b, st);
    case 16: return launch<16>(rm, ints, o, s, r, wv, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
