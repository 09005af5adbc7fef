// resident_count_multi: out[q] = sum_s popcount(fold_j rm[s, ids[lists[q, j]]])
// for a left fold of K rows per query (and / or / andnot, where andnot
// folds acc & ~row for every operand after the first; any K >= 1), over a
// slice-major [S, R, W] or a row-major [R, S, W] matrix, every distinct
// row of the batch staged in shared memory once per word chunk.
//
// The staged variant of the multi fold: it computes what the Pallas
// kernels fused_gather_count_multi (with fused_gather_count_or) and
// fused_gather_count_multi_rowmajor (pilosa_tpu/ops/pallas_kernels.py
// _gather_multi_kernel, _gather_multi_rowmajor_kernel) compute, for
// batches that name the same rows many times — Range covers, whose pads
// repeat their first id, and wide N-ary folds (dispatch.multi_strategy
// chooses it; gather_count_multi.cu and gather_count_multi_rowmajor.cu
// serve the rest).
//
// Bound on this card: bytes — each of the U distinct rows is read once
// from device memory (S x U x W x 4 bytes).  The gather kernels read
// B x K rows per slice, which L2 serves when rows repeat: at the Range
// shape (B = 128, K = 23, about 550 rows) they move 8-9 TB/s through L2
// and L2 sets their pace.
// Design: the wrapper lists the U distinct rows (ids) and remaps the
// operands into [0, U); it also drops each query's repeated operands (a
// Range cover's pads repeat its first id: half of range-1's references),
// pads each list to a multiple of four with an operand the fold ignores a
// second time, and orders the queries by their list's length, so that
// the queries a warp folds together end together.  Persistent blocks of
// 16 warps walk balanced runs of (slice, chunk) tiles through stage.cuh;
// one template serves both layouts (the stager takes the row and slice
// strides).  A group is 128 queries: warp w owns queries w, w + 16, ...
// (kQueriesPerWarp); a row's chunk is read as int4 vectors by min(32,
// chunk_words / 4) lanes, so a warp folds one or two queries per step.  Per step a lane reads four operand
// offsets at a time (one int4 from shared memory), for as many groups of
// four as its query's list has, loads the operands' vectors from the
// tile, folds them in registers, and adds the popcount to that query's
// partial sum, held in a register across ALL of the block's tiles.  A larger batch takes further groups along
// gridDim.y, each walking the same tiles.  At the end: one sum over the
// row's lanes per query per block and one integer atomicAdd into out
// (zeroed by the wrapper); integer atomics are exact in any order.

#include "common.cuh"
#include "stage.cuh"

namespace {

// 16 warps a block, two blocks an SM where the tiles leave room: up to
// 64 registers a thread.
constexpr int kStageWarps = 16;
constexpr int kStageThreads = kStageWarps * 32;
constexpr int kQueriesPerWarp = 8;
constexpr int kGroup = kStageWarps * kQueriesPerWarp;

__device__ __forceinline__ int4 lds4(const char* p) { return *reinterpret_cast<const int4*>(p); }

template <int OP>
__global__ void __launch_bounds__(kStageThreads, 2) resident_count_multi_kernel(
    const int* __restrict__ rm, const int* __restrict__ ids, const int* __restrict__ lists,
    const int* __restrict__ n_groups, const int* __restrict__ order, int* __restrict__ out,
    long long row_stride, long long slice_stride, int u, int k4, int chunk_words, int n_chunks,
    long long n_tiles, int n_queries, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  Stager st;
  st.rm = rm;
  st.tiles = smem;
  st.row_stride = row_stride;
  st.slice_stride = slice_stride;
  st.u = u;
  st.chunk_words = chunk_words;
  st.n_chunks = n_chunks;
  st.stages = stages;
  const long long q0 = (long long)blockIdx.y * kGroup;
  const int n_here = (int)min((long long)kGroup, n_queries - q0);
  // [n_here, k4]: byte offsets of each query's operand rows in a tile;
  // [n_here]: its groups of four operands; [n_here]: its index in out.
  int* soff = reinterpret_cast<int*>(smem + st.tile_bytes());
  int* sng = soff + n_here * k4;
  int* sq = sng + n_here;
  int* sids = sq + n_here;
  st.ids = sids;
  for (int i = threadIdx.x; i < u; i += blockDim.x) sids[i] = ids[i];
  for (int i = threadIdx.x; i < n_here * k4; i += blockDim.x)
    soff[i] = lists[q0 * k4 + i] * chunk_words * 4;
  for (int i = threadIdx.x; i < n_here; i += blockDim.x) {
    sng[i] = n_groups[q0 + i];
    sq[i] = order[q0 + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cv = chunk_words >> 2;        // int4 vectors a row chunk
  const int lpr = cv < 32 ? cv : 32;      // lanes a row: 16 or 32
  const int qs = 32 / lpr;                // queries a warp folds per step
  const int sub = lane / lpr;             // which of them this lane folds
  const int lc = lane - sub * lpr;        // its int4 column within the row
  const int nj = kQueriesPerWarp / qs;    // queries this lane folds in all
  // This lane's queries: slot (j * qs + sub) * 16 + warp for j < nj.
  int acc[kQueriesPerWarp];
#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) acc[j] = 0;

  stage_walk(st, n_tiles, [&](const int* tile_words) {
    const char* tile = reinterpret_cast<const char*>(tile_words);
#pragma unroll
    for (int j = 0; j < kQueriesPerWarp; ++j) {
      const int slot = (j * qs + sub) * kStageWarps + warp;
      if (j >= nj || slot >= n_here) continue;  // uniform over the row's lanes
      const int4* off = reinterpret_cast<const int4*>(soff + slot * k4);
      const int ng = sng[slot];
      for (int v = lc; v < cv; v += lpr) {
        const char* col = tile + v * sizeof(int4);
        int4 o = off[0];
        int4 a = lds4(col + o.x);
        a = op4<OP>(a, lds4(col + o.y));
        a = op4<OP>(a, lds4(col + o.z));
        a = op4<OP>(a, lds4(col + o.w));
        for (int g = 1; g < ng; ++g) {
          o = off[g];
          const int4 x0 = lds4(col + o.x);
          const int4 x1 = lds4(col + o.y);
          const int4 x2 = lds4(col + o.z);
          const int4 x3 = lds4(col + o.w);
          a = op4<OP>(op4<OP>(op4<OP>(op4<OP>(a, x0), x1), x2), x3);
        }
        acc[j] += popc4(a);
      }
    }
  });

#pragma unroll
  for (int j = 0; j < kQueriesPerWarp; ++j) {
    if (j >= nj) break;  // warp-uniform
    int sum = acc[j];
    for (int o = lpr >> 1; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const int slot = (j * qs + sub) * kStageWarps + warp;
    if (lc == 0 && slot < n_here && sum) atomicAdd(out + sq[slot], sum);
  }
}

template <int OP>
int launch(const void* rm, const void* ids, const void* lists, const void* n_groups,
           const void* order, void* out, int s, int r, int w, int u, int b, int k4,
           int chunk_words, int stages, int row_major, cudaStream_t st) {
  auto kernel = resident_count_multi_kernel<OP>;
  const int groups = (b + kGroup - 1) / kGroup;
  const int n_chunks = w / chunk_words;
  const long long n_tiles = (long long)s * n_chunks;
  const size_t smem = stage_smem_bytes(u, chunk_words, stages, min(b, kGroup) * (k4 + 2));
  dim3 grid;
  cudaError_t e = stage_grid(kernel, kStageThreads, smem, n_tiles, groups, &grid);
  if (e != cudaSuccess) return (int)e;
  const long long row_stride = row_major ? (long long)s * w : (long long)w;
  const long long slice_stride = row_major ? (long long)w : (long long)r * w;
  kernel<<<grid, kStageThreads, smem, st>>>(
      static_cast<const int*>(rm), static_cast<const int*>(ids), static_cast<const int*>(lists),
      static_cast<const int*>(n_groups), static_cast<const int*>(order), static_cast<int*>(out),
      row_stride, slice_stride, u, k4, chunk_words, n_chunks, n_tiles, b, stages);
  return (int)cudaGetLastError();
}

}  // namespace

// rm: int32[s, r, w], or int32[r, s, w] when row_major (16-byte aligned
// rows); ids: int32[u], the distinct rows the batch names (< r); lists:
// int32[b, k4], each query's operands as indices into ids, k4 a multiple
// of four, padded past the query's own operands with one the fold ignores
// a second time (a single operand is folded as and); n_groups: int32[b],
// the groups of four operands each list holds (1 .. k4 / 4); order:
// int32[b], the out index of each list; out: int32[b], zeroed.  op:
// OP_AND, OP_OR or OP_ANDNOT (common.cuh); chunk_words a power of two >=
// 64 dividing w; stages 1 or 2.  Shared memory: stage_smem_bytes(u,
// chunk_words, stages, min(b, 128) x (k4 + 2)).
extern "C" int pk_resident_count_multi(const void* rm, const void* ids, const void* lists,
                                       const void* n_groups, const void* order, void* out, int s,
                                       int r, int w, int u, int b, int k4, int chunk_words,
                                       int stages, int row_major, int op, void* stream) {
  if (s <= 0 || b <= 0) return (int)cudaSuccess;
  if (u <= 0 || k4 <= 0 || k4 % 4 || chunk_words < 64 || (chunk_words & (chunk_words - 1)) ||
      w % chunk_words || (stages != 1 && stages != 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
#define PK_LAUNCH(O) \
  return launch<O>(rm, ids, lists, n_groups, order, out, s, r, w, u, b, k4, chunk_words, stages, row_major, st)
    case OP_AND: PK_LAUNCH(OP_AND);
    case OP_OR: PK_LAUNCH(OP_OR);
    case OP_ANDNOT: PK_LAUNCH(OP_ANDNOT);
#undef PK_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}
