// resident_count2: out[q] = sum_s popcount(op(rm[s, p0], rm[s, p1])) for a
// batch of row pairs, every distinct row the batch names staged in shared
// memory once per word chunk.
//
// Replaces the Pallas kernel fused_resident_count2
// (pilosa_tpu/ops/pallas_kernels.py _resident_count_kernel), the pair
// lane's direct dispatch when the row working set is small next to the
// batch (R < 2B): streaming each named row once beats gathering two rows
// per pair.
//
// Bound on this card: bytes — each of the U distinct named rows is read
// once from device memory (S x U x W x 4 bytes).
// Design: the wrapper lists the U distinct rows (ids) and remaps the
// pairs into [0, U).  Persistent blocks of 8 warps walk balanced runs of
// (slice, chunk) tiles through stage.cuh: two stages of U x chunk_words
// words, so tile t + 1 streams in (cp.async) while the warps fold tile t.
// A block serves up to kSpan pairs, in groups of 256: in each group warp w
// owns pairs w, w + 8, ... (32 a warp); each lane reads VW words of both
// rows per step (an int4, or an int2 for 64-word chunks) and keeps one
// partial sum per owned pair in registers.  Pair offsets sit in shared
// memory, read once.  One group (B <= 256) keeps its sums in registers
// across ALL of the block's tiles; more groups fold each staged tile in
// turn, so every tile is staged once whatever B is, and add each group's
// sums into shared memory after each tile (a transposed warp reduction:
// 31 shuffles for the warp's 32 pairs).  At the end: one integer
// atomicAdd per pair per block into out (zeroed by the wrapper); integer
// atomics are exact in any order.  Beyond kSpan pairs, further spans
// along gridDim.y.  The TPU kernel carried its sums in VMEM across an
// in-order grid; here the sums are registers and shared memory, and the
// cross-block reduction is the atomic.

#include "common.cuh"
#include "stage.cuh"

namespace {

constexpr int kStageWarps = 8;
constexpr int kStageThreads = kStageWarps * 32;
constexpr int kPairsPerWarp = 32;
constexpr int kGroup = kStageWarps * kPairsPerWarp;
// Pairs a block serves: 16 groups, 32 KiB of offsets and sums.
constexpr int kSpan = 4096;

// Sum each of a lane's 32 values over the warp: afterwards v[0] of lane l
// holds the warp's sum of value l.  Per level, lanes with bit O set keep
// the upper half of their values and trade the lower half with the lane
// across that bit: 16 + 8 + 4 + 2 + 1 shuffles in all.
template <int O>
struct TransposeSum {
  static __device__ __forceinline__ void run(int* v, int lane) {
    const bool upper = lane & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const int send = upper ? v[i] : v[i + O];
      const int keep = upper ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    TransposeSum<O / 2>::run(v, lane);
  }
};

template <>
struct TransposeSum<0> {
  static __device__ __forceinline__ void run(int*, int) {}
};

template <int OP, int VW>
__global__ void __launch_bounds__(kStageThreads) resident_count2_kernel(
    const int* __restrict__ rm, const int* __restrict__ ids, const int* __restrict__ pairs,
    int* __restrict__ out, int n_rows, int w, int u, int chunk_words, int n_chunks,
    long long n_tiles, int n_pairs, int span, int stages) {
  using V = typename Vec<VW>::T;
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
  // [span]: p0 | p1 << 16, the pair's two tile offsets in vectors; then
  // [span] sums of the groups folded tile by tile.
  unsigned* spair = reinterpret_cast<unsigned*>(smem + st.tile_bytes());
  int* ssum = reinterpret_cast<int*>(spair + span);
  int* sids = ssum + span;
  st.ids = sids;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cvw = chunk_words / VW;  // vectors per row chunk, a multiple of 32
  const int q0 = blockIdx.y * kSpan;
  const int n_here = min(kSpan, n_pairs - q0);
  const int groups = (n_here + kGroup - 1) / kGroup;
  for (int i = threadIdx.x; i < u; i += blockDim.x) sids[i] = ids[i];
  // Slot g * 256 + j * 8 + warp: pair j of warp `warp` in group g.
  for (int i = threadIdx.x; i < groups * kGroup; i += blockDim.x) {
    const int q = q0 + i;
    spair[i] = i < n_here
                   ? (unsigned)(pairs[2 * q] * cvw) | ((unsigned)(pairs[2 * q + 1] * cvw) << 16)
                   : 0u;
    ssum[i] = 0;
  }
  __syncthreads();

  int acc[kPairsPerWarp];
#pragma unroll
  for (int j = 0; j < kPairsPerWarp; ++j) acc[j] = 0;

  stage_walk(st, n_tiles, [&](const int* tile_words) {
    const V* tile = reinterpret_cast<const V*>(tile_words);
    for (int g = 0; g < groups; ++g) {
      const unsigned* gp = spair + g * kGroup;
      const int n_g = n_here - g * kGroup;  // pairs of group g (> 256: all)
      for (int v = lane; v < cvw; v += 32) {
#pragma unroll
        for (int j = 0; j < kPairsPerWarp; ++j) {
          if (j * kStageWarps + warp < n_g) {  // warp-uniform: no divergence
            const unsigned x = gp[j * kStageWarps + warp];
            acc[j] += popc_op_v<OP>(tile[(x & 0xffff) + v], tile[(x >> 16) + v]);
          }
        }
      }
      if (groups > 1) {  // the next group reuses the registers
        TransposeSum<16>::run(acc, lane);
        const int slot = lane * kStageWarps + warp;  // lane l holds pair l's sum
        if (slot < n_g) ssum[g * kGroup + slot] += acc[0];
#pragma unroll
        for (int j = 0; j < kPairsPerWarp; ++j) acc[j] = 0;
      }
    }
  });

  if (groups == 1) {
    TransposeSum<16>::run(acc, lane);
    const int slot = lane * kStageWarps + warp;
    if (slot < n_here && acc[0]) atomicAdd(out + q0 + slot, acc[0]);
  } else {
    __syncthreads();
    for (int i = threadIdx.x; i < n_here; i += blockDim.x)
      if (ssum[i]) atomicAdd(out + q0 + i, ssum[i]);
  }
}

// Shared ints a span of b pairs takes: offsets and sums for its groups.
inline int span_ints(int b) {
  const int groups = (min(b, kSpan) + kGroup - 1) / kGroup;
  return groups * kGroup;
}

template <int OP, int VW>
int launch(const void* rm, const void* ids, const void* pairs, void* out, int s, int r, int w,
           int u, int b, int chunk_words, int stages, cudaStream_t st) {
  auto kernel = resident_count2_kernel<OP, VW>;
  const int spans = (b + kSpan - 1) / kSpan;
  const int span = span_ints(b);
  const int n_chunks = w / chunk_words;
  const long long n_tiles = (long long)s * n_chunks;
  const size_t smem = stage_smem_bytes(u, chunk_words, stages, 2 * span);
  dim3 grid;
  cudaError_t e = stage_grid(kernel, kStageThreads, smem, n_tiles, spans, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kStageThreads, smem, st>>>(
      static_cast<const int*>(rm), static_cast<const int*>(ids), static_cast<const int*>(pairs),
      static_cast<int*>(out), r, w, u, chunk_words, n_chunks, n_tiles, b, span, stages);
  return (int)cudaGetLastError();
}

template <int OP>
int by_vw(int vw, const void* rm, const void* ids, const void* pairs, void* out, int s, int r,
          int w, int u, int b, int chunk_words, int stages, cudaStream_t st) {
  return vw == 4 ? launch<OP, 4>(rm, ids, pairs, out, s, r, w, u, b, chunk_words, stages, st)
                 : launch<OP, 2>(rm, ids, pairs, out, s, r, w, u, b, chunk_words, stages, st);
}

}  // namespace

// rm: int32[s, r, w] (16-byte aligned rows); ids: int32[u], the distinct
// rows the pairs name (< r); pairs: int32[b, 2], indices into ids; out:
// int32[b], zeroed.  chunk_words: a power of two >= 64 dividing w;
// stages: 1 or 2.  Shared memory: stage_smem_bytes(u, chunk_words,
// stages, 2 x span_ints(b)).
extern "C" int pk_resident_count2(const void* rm, const void* ids, const void* pairs, void* out,
                                  int s, int r, int w, int u, int b, int chunk_words, int stages,
                                  int op, void* stream) {
  if (s <= 0 || b <= 0) return (int)cudaSuccess;
  const int vw = chunk_words >= 128 ? 4 : 2;
  if (u <= 0 || chunk_words < 64 || (chunk_words & (chunk_words - 1)) || w % chunk_words ||
      (stages != 1 && stages != 2) || (long long)u * (chunk_words / vw) > 0xffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case OP_AND: return by_vw<OP_AND>(vw, rm, ids, pairs, out, s, r, w, u, b, chunk_words, stages, st);
    case OP_OR: return by_vw<OP_OR>(vw, rm, ids, pairs, out, s, r, w, u, b, chunk_words, stages, st);
    case OP_XOR: return by_vw<OP_XOR>(vw, rm, ids, pairs, out, s, r, w, u, b, chunk_words, stages, st);
    case OP_ANDNOT: return by_vw<OP_ANDNOT>(vw, rm, ids, pairs, out, s, r, w, u, b, chunk_words, stages, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
