// resident_count_multi: out[q] = sum_s popcount(fold_j rm[s, idx[q, j]])
// for a left fold of K rows per query (and / or / andnot, where andnot
// folds acc & ~row for every operand after the first; any K >= 1), over a
// slice-major [S, R, W] or a row-major [R, S, W] matrix, every distinct
// row of the batch staged in shared memory once per word chunk and read
// from there once per group of four queries that names it.
//
// The staged variant of the multi fold: it computes what the Pallas
// kernels fused_gather_count_multi (with fused_gather_count_or) and
// fused_gather_count_multi_rowmajor (pilosa_tpu/ops/pallas_kernels.py
// _gather_multi_kernel, _gather_multi_rowmajor_kernel) compute, for
// batches that name the same rows many times — Range covers of a few
// bitmap rows over overlapping spans, and wide N-ary folds
// (dispatch.multi_strategy chooses it; gather_count_multi.cu and
// gather_count_multi_rowmajor.cu serve the rest).
//
// Bound on this card: bytes — each of the U distinct rows is read once
// from device memory (S x U x W x 4 bytes).  A fold that read every
// operand of every query from shared memory would read B x K rows a tile:
// at the range-wide batch (B = 128, 2,240 operands, 240 rows) that is 20
// GB of shared-memory reads a launch, more time at the SMs' 128 bytes a
// clock than the device-memory bound itself.
// Design:
// - The queries share their operands, so the host (ops/kernels.py
//   multi_plan) cuts the batch into groups of kQ = 4 queries that share
//   rows, and splits each group's rows into classes: the rows that
//   exactly the same queries of the group name (a 4-bit mask, so at most
//   15 classes).  Per tile and vector, a class's rows are folded once
//   into a register temporary, one shared-memory read a row, and the
//   temporary is applied to each query of the mask: or / and with the
//   mask bit widened to a word (no branch).  The four accumulators are
//   registers with compile-time names; andnot folds each query's operands
//   after its first with or and reads the first row once at the end
//   (first & ~rest).  Each row is read once per group that names it: 676
//   reads a tile at range-wide against 2,432 for a fold per query.
// - A group is folded by the lanes that cover one row chunk as int4
//   vectors: 16 lanes (a half-warp) for 64-word chunks, 8 for 32-word
//   ones, so a warp folds two or four groups.  Each lane keeps its
//   queries' popcounts in registers across ALL of the block's tiles; at
//   the end one sum over the group's lanes and one integer atomicAdd a
//   query into out (zeroed by the wrapper); integer atomics are exact in
//   any order.
// - The tiles flow through csrc/ring.cuh: producer warps (four: one
//   alone set the pace, PERF_GATES.md) copy them with cp.async into a
//   ring of up to three stages, full / empty mbarriers hand each stage
//   over, and no barrier spans the block.
// - The plan (row ids, each group's record: its queries' out indices,
//   the andnot first rows, its classes' masks, counts and rows) crosses
//   in the launch's parameters (a __grid_constant__ struct of kPlanInts
//   ints) when it fits, else from one device array; each block copies
//   its own groups' records into shared memory.  A block serves
//   kGroupsPerBlock groups (128 queries); a larger batch takes further
//   blocks along gridDim.y, each walking the same tiles.

#include <string.h>

#include "common.cuh"
#include "ring.cuh"

namespace {

constexpr int kQ = 4;                  // queries a group
constexpr int kGroupsPerBlock = 32;    // groups a block: 128 queries
constexpr int kMaxConsumerWarps = 16;  // two groups a warp at 64-word chunks
constexpr int kMaxProducerWarps = 4;   // 8 capped registers at 80: andnot spilled
constexpr int kMaxThreads = 32 * (kMaxConsumerWarps + kMaxProducerWarps);
constexpr int kPlanInts = 4096;        // 16 KiB of parameters (CUDA 12.1+ allows 32 KB)

struct Plan {
  int ints[kPlanInts];
};

__device__ __forceinline__ int4 lds4(const unsigned char* p) {
  return *reinterpret_cast<const int4*>(p);
}

// A class's fold: and for and, or for or and for andnot's rest.
template <int OP>
__device__ __forceinline__ int4 fold4(int4 a, int4 b) {
  return op4<OP == OP_AND ? OP_AND : OP_OR>(a, b);
}

// Apply a class's temporary t to an accumulator where bit (all ones or
// zero) says that the class holds the accumulator's query.
template <int OP>
__device__ __forceinline__ void apply4(int4& a, int4 t, int bit) {
  if (OP == OP_AND) {
    a.x &= t.x | ~bit;
    a.y &= t.y | ~bit;
    a.z &= t.z | ~bit;
    a.w &= t.w | ~bit;
  } else {
    a.x |= t.x & bit;
    a.y |= t.y & bit;
    a.z |= t.z & bit;
    a.w |= t.w & bit;
  }
}

template <int OP>
__global__ void __launch_bounds__(kMaxThreads, 1) resident_count_multi_kernel(
    const int* __restrict__ rm, const __grid_constant__ Plan plan, const int* __restrict__ plan_dev,
    int* __restrict__ out, long long row_stride, long long slice_stride, int u, int n_groups,
    int chunk_words, int n_chunks, long long n_tiles, int stages, int producer_warps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int* src = plan_dev ? plan_dev : plan.ints;
  Ring ring;
  ring.rm = rm;
  ring.tiles = smem;
  ring.row_stride = row_stride;
  ring.slice_stride = slice_stride;
  ring.u = u;
  ring.chunk_words = chunk_words;
  ring.n_chunks = n_chunks;
  ring.stages = stages;
  unsigned char* after = smem + (size_t)stages * ring.tile_bytes();
  ring.bars = smem_u32(after);
  // [this block's records (int4-aligned)][its groups' offsets][U row ids]
  int* srec = reinterpret_cast<int*>(after + kRingBarBytes);
  const int g0 = blockIdx.y * kGroupsPerBlock;
  const int ng = min(kGroupsPerBlock, n_groups - g0);
  const int rec_lo = src[u + g0];
  const int n_rec = src[u + g0 + ng] - rec_lo;
  int* sgs = srec + n_rec;
  int* sids = sgs + ng + 1;
  ring.ids = sids;
  for (int i = threadIdx.x; i < n_rec; i += blockDim.x) srec[i] = src[rec_lo + i];
  for (int i = threadIdx.x; i <= ng; i += blockDim.x) sgs[i] = src[u + g0 + i] - rec_lo;
  for (int i = threadIdx.x; i < u; i += blockDim.x) sids[i] = src[i];
  const int consumer_warps = (int)(blockDim.x >> 5) - producer_warps;
  if (threadIdx.x == 0) ring.init(consumer_warps, producer_warps);
  __syncthreads();

  const long long t0 = (long long)blockIdx.x * n_tiles / gridDim.x;
  const long long t1 = (long long)(blockIdx.x + 1) * n_tiles / gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (warp >= consumer_warps) {
    ring.produce(t0, t1, (int)threadIdx.x - 32 * consumer_warps, 32 * producer_warps);
    return;
  }

  const int cv = chunk_words >> 2;       // int4 vectors a row chunk
  const int lpg = cv < 16 ? cv : 16;     // lanes a group: 8 or 16
  const int sub = lane / lpg;            // which of the warp's groups
  const int lc = lane - sub * lpg;       // this lane's first vector
  const int grp = warp * (32 / lpg) + sub;
  const bool active = grp < ng;          // uniform over the group's lanes
  const int4* rec = reinterpret_cast<const int4*>(srec + (active ? sgs[grp] : 0));
  const int4* rec_end = reinterpret_cast<const int4*>(srec + (active ? sgs[grp + 1] : 0));
  int row_shift = 0;                     // bytes of a tile row: 4 * chunk_words
  while ((1 << row_shift) < 4 * chunk_words) ++row_shift;
  const int ident = OP == OP_AND ? -1 : 0;
  int s0 = 0, s1 = 0, s2 = 0, s3 = 0;

  ring.consume(t0, t1, lane, [&](const unsigned char* tile) {
    if (!active) return;
    for (int v = lc; v < cv; v += lpg) {
      const unsigned char* col = tile + v * 16;
      int4 a0 = make_int4(ident, ident, ident, ident), a1 = a0, a2 = a0, a3 = a0;
      // Each class: an int4 (mask | n << 4, three rows), then n >> 2 int4s
      // of further rows; the next class's header is read a class ahead.
      const int4* p = rec + 2;
      int4 next = p < rec_end ? *p : make_int4(0, 0, 0, 0);
      while (p < rec_end) {
        const int4 h = next;
        const int n = h.x >> 4;
        const int4* more = p + 1;
        p = more + (n >> 2);
        if (p < rec_end) next = *p;
        int4 t = lds4(col + (h.y << row_shift));
        if (n > 1) t = fold4<OP>(t, lds4(col + (h.z << row_shift)));
        if (n > 2) t = fold4<OP>(t, lds4(col + (h.w << row_shift)));
        for (int j = 3; j < n; j += 4) {
          const int4 o = *more++;
          t = fold4<OP>(t, lds4(col + (o.x << row_shift)));
          if (j + 1 < n) t = fold4<OP>(t, lds4(col + (o.y << row_shift)));
          if (j + 2 < n) t = fold4<OP>(t, lds4(col + (o.z << row_shift)));
          if (j + 3 < n) t = fold4<OP>(t, lds4(col + (o.w << row_shift)));
        }
        apply4<OP>(a0, t, -(h.x & 1));
        apply4<OP>(a1, t, -((h.x >> 1) & 1));
        apply4<OP>(a2, t, -((h.x >> 2) & 1));
        apply4<OP>(a3, t, -((h.x >> 3) & 1));
      }
      if (OP == OP_ANDNOT) {
        const int4 f = rec[1];
        a0 = op4<OP_ANDNOT>(lds4(col + (f.x << row_shift)), a0);
        a1 = op4<OP_ANDNOT>(lds4(col + (f.y << row_shift)), a1);
        a2 = op4<OP_ANDNOT>(lds4(col + (f.z << row_shift)), a2);
        a3 = op4<OP_ANDNOT>(lds4(col + (f.w << row_shift)), a3);
      }
      s0 += popc4(a0);
      s1 += popc4(a1);
      s2 += popc4(a2);
      s3 += popc4(a3);
    }
  });

  for (int o = lpg >> 1; o > 0; o >>= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    s3 += __shfl_xor_sync(0xffffffffu, s3, o);
  }
  if (active && lc == 0) {
    const int4 q = rec[0];
    if (q.x >= 0 && s0) atomicAdd(out + q.x, s0);
    if (q.y >= 0 && s1) atomicAdd(out + q.y, s1);
    if (q.z >= 0 && s2) atomicAdd(out + q.z, s2);
    if (q.w >= 0 && s3) atomicAdd(out + q.w, s3);
  }
}

template <int OP>
int launch(const void* rm, const int* plan_host, const void* plan_dev, int n_plan, void* out,
           int s, int r, int w, int u, int groups, int block_ints, int chunk_words, int stages,
           int producer_warps, int row_major, cudaStream_t st) {
  auto kernel = resident_count_multi_kernel<OP>;
  const int lpg = chunk_words >= 64 ? 16 : chunk_words / 4;
  const int warps = (min(groups, kGroupsPerBlock) + 32 / lpg - 1) / (32 / lpg);
  const int threads = 32 * (warps + producer_warps);
  const int grid_y = (groups + kGroupsPerBlock - 1) / kGroupsPerBlock;
  const int n_chunks = w / chunk_words;
  const long long n_tiles = (long long)s * n_chunks;
  const size_t smem = (size_t)stages * u * chunk_words * 4 + kRingBarBytes +
                      (size_t)(block_ints + u) * 4;
  dim3 grid;
  cudaError_t e = stage_grid(kernel, threads, smem, n_tiles, grid_y, &grid);
  if (e != cudaSuccess) return (int)e;
  const long long row_stride = row_major ? (long long)s * w : (long long)w;
  const long long slice_stride = row_major ? (long long)w : (long long)r * w;
  Plan p;
  if (plan_host) memcpy(p.ints, plan_host, (size_t)n_plan * 4);
  kernel<<<grid, threads, smem, st>>>(
      static_cast<const int*>(rm), p, plan_host ? nullptr : static_cast<const int*>(plan_dev),
      static_cast<int*>(out), row_stride, slice_stride, u, groups, chunk_words, n_chunks, n_tiles,
      stages, producer_warps);
  return (int)cudaGetLastError();
}

}  // namespace

// rm: int32[s, r, w], or int32[r, s, w] when row_major (16-byte aligned
// rows); the plan (ops/kernels.py MultiPlan: n_plan int32s, the u row ids
// (< r), the groups' record offsets, the records) in HOST memory when
// n_plan <= kPlanInts (plan_host, copied into the launch), else on the
// card (plan_dev); block_ints: the most records and offsets a block
// copies; out: int32[b], zeroed.  op: OP_AND, OP_OR or OP_ANDNOT
// (common.cuh); chunk_words a power of two >= 32 dividing w; stages 1 to
// kRingMaxStages; producer_warps 1 to kMaxProducerWarps.  Shared memory:
// stages x u x chunk_words x 4 + kRingBarBytes + (block_ints + u) x 4
// bytes.
extern "C" int pk_resident_count_multi(const void* rm, const void* plan_host, const void* plan_dev,
                                       int n_plan, void* out, int s, int r, int w, int u,
                                       int groups, int b, int block_ints, int chunk_words,
                                       int stages, int producer_warps, int row_major, int op,
                                       void* stream) {
  if (s <= 0 || b <= 0) return (int)cudaSuccess;
  if (u <= 0 || groups <= 0 || groups * kQ < b || block_ints <= 0 || n_plan <= u + groups ||
      chunk_words < 32 || (chunk_words & (chunk_words - 1)) || w % chunk_words || stages < 1 ||
      stages > kRingMaxStages || producer_warps < 1 || producer_warps > kMaxProducerWarps ||
      (plan_host ? n_plan > kPlanInts : !plan_dev))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* host = static_cast<const int*>(plan_host);
  switch (op) {
#define PK_LAUNCH(O)                                                                          \
  return launch<O>(rm, host, plan_dev, n_plan, out, s, r, w, u, groups, block_ints, chunk_words, \
                   stages, producer_warps, row_major, st)
    case OP_AND: PK_LAUNCH(OP_AND);
    case OP_OR: PK_LAUNCH(OP_OR);
    case OP_ANDNOT: PK_LAUNCH(OP_ANDNOT);
#undef PK_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}
