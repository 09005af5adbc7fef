// resident_count_tree: out[q] = sum_s popcount(tree_q(rm[s, leaves[q, 0..K)]))
// for a PERFECT binary expression tree per query (K = 2^D leaf rows in
// order, K - 1 node opcodes level-major bottom-up; opcodes 0-3 are and /
// or / xor / andnot, any other value passes the left child), every
// distinct leaf row of the batch staged in shared memory once per word
// chunk.
//
// The staged variant of the tree fold: it computes what the Pallas kernel
// fused_gather_count_tree (pilosa_tpu/ops/pallas_kernels.py
// _gather_tree_kernel) computes, for batches that name the same rows many
// times (dispatch.gather_count_tree chooses it; gather_count_tree.cu
// serves the rest).
//
// Bound on this card: bytes — each of the U distinct leaf rows is read
// once from device memory (S x U x W x 4 bytes).  The gather kernel reads
// B x K rows per slice, which L2 serves when rows repeat: at B = 64,
// K = 16 it moves twice HBM's rate and is paced by L2.
// Design: the wrapper lists the U distinct leaves (ids) and remaps the
// leaves into [0, U).  Persistent blocks of 16 warps walk balanced runs of
// (slice, chunk) tiles through stage.cuh (two stages: tile t + 1 streams
// in by cp.async while tile t is folded).  Warp w owns queries w, w + 16,
// ... of its group of 64 (kQueriesPerWarp).  A lane reads int4 vectors:
// a whole warp covers one row's chunk of 128+ words, a half-warp a 64-word
// chunk, so a warp folds one or two trees per step.  Per step a lane
// loads the K leaf vectors of its tree from shared memory, folds them
// level by level in registers, popcounts the root and adds it to that
// query's partial sum, held in a register across ALL of the block's
// tiles.  Each node is its opcode's algebraic normal form (three logic
// ops a word, no branch: lanes folding different trees never diverge),
// so the compiler interleaves the loads and levels of a tree.  Leaf
// offsets and node masks sit in shared memory, read once.  At the end:
// one sum over the tree's lanes per query per block and one integer
// atomicAdd into out (zeroed by the wrapper).

#include "common.cuh"
#include "stage.cuh"

namespace {

// A node as its algebraic normal form over GF(2): every opcode maps
// (0, 0) to 0, so node(a, b) = (a & C1) ^ (b & C2) ^ (a & b & C3) with
// all-ones or zero masks (C1, C2, C3): and (0, 0, 1), or (1, 1, 1), xor
// (1, 1, 0), andnot a & ~b (1, 0, 1), and the left child (1, 0, 0) for
// TREE_PASS or any other value.  Three logic ops a word and no branch;
// the masks come from shared memory as one int4 per node.
__device__ __forceinline__ int4 node_masks(int o) {
  const int c = o == 0 ? 4 : o == 1 ? 7 : o == 2 ? 3 : o == 3 ? 5 : 1;  // C3 C2 C1
  return make_int4(-(c & 1), -((c >> 1) & 1), -(c >> 2), 0);
}

__device__ __forceinline__ int node(int a, int b, int4 m) {
  return (a & m.x) ^ (b & m.y) ^ (a & b & m.z);
}

__device__ __forceinline__ int4 node4(int4 a, int4 b, int4 m) {
  return make_int4(node(a.x, b.x, m), node(a.y, b.y, m), node(a.z, b.z, m), node(a.w, b.w, m));
}

// Fold N values in place to vals[0], one level per instantiation; masks
// points at this level's N / 2 nodes, the next level's follow them.
template <int N>
struct Fold {
  static __device__ __forceinline__ void run(int4* vals, const int4* masks) {
#pragma unroll
    for (int t = 0; t < N / 2; ++t) vals[t] = node4(vals[2 * t], vals[2 * t + 1], masks[t]);
    Fold<N / 2>::run(vals, masks + N / 2);
  }
};

template <>
struct Fold<1> {
  static __device__ __forceinline__ void run(int4*, const int4*) {}
};

// 16 warps a block: a warp folds one or two trees at a time (a chain of
// dependent shared-memory loads and levels), so the SM needs many warps
// in flight to hide that latency; 512 threads leave 128 registers each
// (one block an SM: the tiles fill its shared memory).
constexpr int kStageWarps = 16;
constexpr int kStageThreads = kStageWarps * 32;

// Queries per warp: a group is 16 x 4 = 64 trees; a larger batch takes
// further groups along gridDim.y, each walking the same tiles (the tree
// fold's work per tile outweighs staging it again; dispatch's
// tree_strategy asks each group to reuse the staged rows).
constexpr int kQueriesPerWarp = 4;
constexpr int kGroup = kStageWarps * kQueriesPerWarp;

template <int K, int LPR>
__global__ void __launch_bounds__(kStageThreads, 1) resident_count_tree_kernel(
    const int* __restrict__ rm, const int* __restrict__ ids, const int* __restrict__ leaves,
    const int* __restrict__ opc, int* __restrict__ out, int n_rows, int w, int u,
    int chunk_words, int n_chunks, long long n_tiles, int n_queries, int stages) {
  // LPR lanes read one row's int4 vectors, so a warp folds QS = 32 / LPR
  // trees at a time (LPR = 16 for 64-word chunks: 16 int4 a row).
  constexpr int QS = 32 / LPR;
  extern __shared__ __align__(128) unsigned char smem[];
  Stager st;
  st.rm = rm;
  st.tiles = smem;
  st.row_stride = w;
  st.slice_stride = (long long)n_rows * w;
  st.u = u;
  st.chunk_words = chunk_words;
  st.n_chunks = n_chunks;
  st.stages = stages;
  int4* smask = reinterpret_cast<int4*>(smem + st.tile_bytes());  // [kGroup, K - 1]
  int* slv = reinterpret_cast<int*>(smask + kGroup * (K - 1));  // [kGroup, K]: byte offsets
  int* sids = slv + kGroup * K;
  st.ids = sids;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane / LPR;   // which of the QS trees this lane folds
  const int lc = lane % LPR;    // its int4 column within the row
  const int cv = chunk_words / 4;  // int4 vectors per row chunk, a multiple of LPR
  const long long q0 = (long long)blockIdx.y * kGroup;
  const int n_here = (int)min((long long)kGroup, n_queries - q0);
  for (int i = threadIdx.x; i < u; i += blockDim.x) sids[i] = ids[i];
  // Slot i = j * 16 + warp holds query j of warp (i & 15); slots at or
  // past n_here are never folded.
  for (int i = threadIdx.x; i < kGroup * K; i += blockDim.x)
    slv[i] = i / K < n_here ? leaves[q0 * K + i] * chunk_words * 4 : 0;
  for (int i = threadIdx.x; i < kGroup * (K - 1); i += blockDim.x)
    smask[i] = node_masks(i / (K - 1) < n_here ? opc[q0 * (K - 1) + i] : 0);
  __syncthreads();

  // This lane's trees: slot (j * QS + sub) * 16 + warp for j < kTrees.
  constexpr int kTrees = kQueriesPerWarp / QS;
  int acc[kTrees];
#pragma unroll
  for (int j = 0; j < kTrees; ++j) acc[j] = 0;

  stage_walk(st, n_tiles, [&](const int* tile_words) {
    for (int v = lc; v < cv; v += LPR) {
      const char* col = reinterpret_cast<const char*>(tile_words) + v * sizeof(int4);
#pragma unroll
      for (int j = 0; j < kTrees; ++j) {
        const int slot = (j * QS + sub) * kStageWarps + warp;
        if (slot >= n_here) continue;  // uniform per tree: its lanes agree
        int off[K];
        if constexpr (K >= 4) {
          const int4* lv4 = reinterpret_cast<const int4*>(slv + slot * K);
#pragma unroll
          for (int i = 0; i < K / 4; ++i) {
            const int4 o = lv4[i];
            off[4 * i] = o.x;
            off[4 * i + 1] = o.y;
            off[4 * i + 2] = o.z;
            off[4 * i + 3] = o.w;
          }
        } else {
          off[0] = slv[slot * K];
          off[1] = slv[slot * K + 1];
        }
        int4 vals[K];
#pragma unroll
        for (int i = 0; i < K; ++i) vals[i] = *reinterpret_cast<const int4*>(col + off[i]);
        Fold<K>::run(vals, smask + slot * (K - 1));
        acc[j] += popc4(vals[0]);
        // One tree's leaves live at a time: without this fence the
        // compiler hoists every query's loads and runs out of registers.
        asm volatile("" ::: "memory");
      }
    }
  });

#pragma unroll
  for (int j = 0; j < kTrees; ++j) {
    int sum = acc[j];
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int slot = (j * QS + sub) * kStageWarps + warp;
    if (lc == 0 && slot < n_here && sum) atomicAdd(out + q0 + slot, sum);
  }
}

template <int K, int LPR>
int launch(const void* rm, const void* ids, const void* leaves, const void* opc, void* out, int s,
           int r, int w, int u, int b, int chunk_words, int stages, cudaStream_t st) {
  auto kernel = resident_count_tree_kernel<K, LPR>;
  const int groups = (b + kGroup - 1) / kGroup;
  const int n_chunks = w / chunk_words;
  const long long n_tiles = (long long)s * n_chunks;
  const size_t smem = stage_smem_bytes(u, chunk_words, stages, kGroup * (K + 4 * (K - 1)));
  dim3 grid;
  cudaError_t e = stage_grid(kernel, kStageThreads, smem, n_tiles, groups, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kStageThreads, smem, st>>>(
      static_cast<const int*>(rm), static_cast<const int*>(ids), static_cast<const int*>(leaves),
      static_cast<const int*>(opc), static_cast<int*>(out), r, w, u, chunk_words, n_chunks,
      n_tiles, b, stages);
  return (int)cudaGetLastError();
}

template <int K>
int by_lanes(int lpr, const void* rm, const void* ids, const void* leaves, const void* opc,
             void* out, int s, int r, int w, int u, int b, int chunk_words, int stages,
             cudaStream_t st) {
  return lpr == 32
             ? launch<K, 32>(rm, ids, leaves, opc, out, s, r, w, u, b, chunk_words, stages, st)
             : launch<K, 16>(rm, ids, leaves, opc, out, s, r, w, u, b, chunk_words, stages, st);
}

}  // namespace

// rm: int32[s, r, w] (16-byte aligned rows); ids: int32[u], the distinct
// leaf rows (< r); leaves: int32[b, k], indices into ids; opc: int32[b,
// k - 1]; out: int32[b], zeroed.  k is 2, 4, 8 or 16; chunk_words a power
// of two >= 64 dividing w; stages 1 or 2.  Shared memory:
// stage_smem_bytes(u, chunk_words, stages, 64 * (k + 4 (k - 1))).
extern "C" int pk_resident_count_tree(const void* rm, const void* ids, const void* leaves,
                                      const void* opc, void* out, int s, int r, int w, int u,
                                      int b, int k, int chunk_words, int stages, void* stream) {
  if (s <= 0 || b <= 0) return (int)cudaSuccess;
  const int lpr = chunk_words >= 128 ? 32 : 16;  // lanes a row: 32 int4, or 16 for 64 words
  if (u <= 0 || chunk_words < 64 || (chunk_words & (chunk_words - 1)) || w % chunk_words ||
      (stages != 1 && stages != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return by_lanes<2>(lpr, rm, ids, leaves, opc, out, s, r, w, u, b, chunk_words, stages, st);
    case 4: return by_lanes<4>(lpr, rm, ids, leaves, opc, out, s, r, w, u, b, chunk_words, stages, st);
    case 8: return by_lanes<8>(lpr, rm, ids, leaves, opc, out, s, r, w, u, b, chunk_words, stages, st);
    case 16: return by_lanes<16>(lpr, rm, ids, leaves, opc, out, s, r, w, u, b, chunk_words, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
