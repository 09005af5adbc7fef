// pair_gram: G[i, j] = sum_s popcount(rm[s, i] & rm[s, j]) for every row
// pair i, j < R of an int32 matrix rm[S, R, W], exact in int32.
//
// Replaces the reference's all-pairs Gram (pilosa_tpu/ops/bitwise.py:282
// pair_gram), which is not a Pallas kernel: one int8 x int8 -> int32
// product on the MXU over the bits unpacked to 0/1 bytes.  The executor
// builds it once per warm pool and answers every pair op from it.
//
// Bound on this card: bytes at the executor's shape (S = 64, R = 256: 2 GiB
// read once, 0.64 ms), bit products for tall R (S = 16, R = 1,024), at the
// faster of the two b1 instructions' rates that mma_probe.cu measures.
//
// Design: tensor cores through wgmma m64nNk256 b1 with AND-popc
// (wgmma_b1.cuh), which takes 256 packed bits of a row as they lie in
// memory and reads both operands from shared memory, so no thread loads a
// fragment.  Two consumer warpgroups run the products of a job: a block
// stages, for each k-tile (one 32-word chunk of one slice: 128 bytes a row,
// four k-steps), an A tile and a B tile of 128 rows and accumulates one
// job's outputs in registers.  A job is one upper 128 x 128 tile pair
// (ti, tj), ti <= tj: warpgroup g takes rows 64g..64g+63 of A against
// B's columns (m64n128, 64 int32 accumulators a thread); on a diagonal
// tile warpgroup 1 takes only columns 64..127 (m64n64), its lower-left
// quarter being the mirror of warpgroup 0's upper right; where a ragged
// last tile holds at most 64 live columns a warpgroup takes m64n64, and
// one whose rows all lie past R skips its products, so R <= 64 costs one
// m64n64 an operand tile.  Where 128 < R <= 256 the one job is the whole
// 256-row square: the stage's two tiles are rows 0..255, and warpgroup 0
// takes rows 0..63 x columns 0..255 (m64n256) and rows 192..255 x
// 192..255 (m64n64), warpgroup 1 rows 64..127 x 64..255 (m64n192) and
// rows 128..191 x 128..255 (m64n128): 160 accumulators a thread each,
// every row staged once a k-tile (the executor's 256-row bucket).
//
// Work units are (job, k-tile), job-major (unit u = p * n_k + k); blocks
// are persistent (one an SM), so even a single job fills every SM: its
// blocks split the contraction.  With one job (R <= 256) block b of B
// takes units b, b + B, b + 2B, ..., so at any time the blocks read
// neighbouring chunks of the same rows; with more, block b walks the
// contiguous, balanced run [b*U/B, (b+1)*U/B).  Where a block's run leaves
// a job it adds its partial sums into the zeroed int32 output with
// atomics, at (i, j) and, where i and j lie in different 64-row bands, at
// the mirror (j, i).
//
// Staging: one producer warp fills a kStages-deep ring of stages (an A and
// a B operand tile, 128 rows x 128 bytes each, under the 128-byte swizzle,
// no padding); "full" and "empty" mbarriers hand each stage to the
// consumers and back.  The producer's warpgroup gives up its registers
// (setmaxnreg) so that the consumers' 160 accumulators fit without
// spilling.  A diagonal tile stages one operand and hands both
// descriptors the same stage.  The producer is the Tensor Memory
// Accelerator: one thread, a 3-D tensor map over the strided [S, R, W]
// view, rows past R and words past W filled with zeros; the map is
// encoded on the host through the driver entry point, so the build links
// nothing new.  (cp.async 16-byte copies from the warp's 32 lanes into the
// hand-swizzled layout took twice as long at S = 64, R = 256 on the H100:
// PERF_GATES.md.)  Any R and any W % 4 == 0 work, and slice and row
// strides are arguments: the executor hands a [:, :bucket, :] view of a
// pool with spare rows, and it is not copied.

#include <cuda.h>
#include <stdint.h>

#include "wgmma_b1.cuh"

namespace {

constexpr int kTile = 128;            // output rows and columns of a block tile
constexpr int kChunk = 32;            // words of a k-tile: 4 steps of 256 bits
constexpr int kStages = 4;
constexpr int kConsumers = 256;       // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer's warpgroup
// Registers a thread after setmaxnreg: the consumers' 160 accumulators
// need more than the 168 an even split of the SM's 65,536 gives 384
// threads; the producer's warpgroup hands them its share.
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kBlocksPerSm = 1;
constexpr int kTileBytes = kTile * kChunk * 4;     // one operand tile: 16 KiB
constexpr int kStageBytes = 2 * kTileBytes;        // A and B
constexpr size_t kSmemBytes = (size_t)kStages * kStageBytes + 2 * kStages * 8 + 1024;

// The tiles (ti, tj) of job p with n_t tiles a side: the upper tile pairs,
// row-major over i <= j, or with two tiles the one 256-row job (0, 1).
__device__ __forceinline__ void tile_pair(long long p, int n_t, int* ti, int* tj) {
  if (n_t == 2) {
    *ti = 0;
    *tj = 1;
    return;
  }
  int i = 0;
  while (p >= n_t - i) {
    p -= n_t - i;
    ++i;
  }
  *ti = i;
  *tj = i + (int)p;
}

struct Gram {
  const int* rm;
  long long slice_stride, row_stride;  // words
  int r, w, n_chunks, n_t;
  long long n_k;                       // k-tiles a job: S x n_chunks
};

// A block's units in order: unit i is u0 + i * step.
struct Run {
  long long u0, step, n;

  __device__ explicit Run(const Gram& g) {
    const long long n_units = (g.n_t <= 2 ? 1 : (long long)g.n_t * (g.n_t + 1) / 2) * g.n_k;
    if (n_units == g.n_k) {  // one job: interleaved
      u0 = blockIdx.x;
      step = gridDim.x;
      n = (n_units - u0 + step - 1) / step;
    } else {
      u0 = (long long)blockIdx.x * n_units / gridDim.x;
      step = 1;
      n = (long long)(blockIdx.x + 1) * n_units / gridDim.x - u0;
    }
  }

  // Tile pair p and k-tile k of unit i.
  __device__ void at(const Gram& g, long long i, long long* p, long long* k) const {
    const long long u = u0 + i * step;
    *p = u / g.n_k;
    *k = u - *p * g.n_k;
  }

  // Whether unit i of tile pair p is the block's last of that pair.
  __device__ bool leaves(const Gram& g, long long i, long long p) const {
    return i + 1 == n || (u0 + (i + 1) * step) / g.n_k != p;
  }
};

// A warpgroup's four k-steps of m64nNk256 over a staged k-tile: A's 64
// rows from shared address a, B's N rows from b.
template <int N>
__device__ __forceinline__ void products(int* acc, uint32_t a, uint32_t b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
#pragma unroll
  for (int ks = 0; ks < kChunk / 8; ++ks) wgmma_b1<N>(acc, da + 2 * ks, db + 2 * ks);
}

// Adds a warpgroup's m64nN sums (rows row0.., columns col0..) into out at
// (i, j) and, where i and j lie in different 64-row bands, at (j, i);
// zeroes them.
template <int N>
__device__ __forceinline__ void add_band(int* acc, int row0, int col0, int r,
                                         int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int ri0 = row0 + ((threadIdx.x & 127) >> 5) * 16 + (lane >> 2);
  const int cj0 = col0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = ri0 + (e >> 1) * 8;
      const int cj = cj0 + j * 8 + (e & 1);
      const int v = acc[4 * j + e];
      acc[4 * j + e] = 0;
      if (v != 0 && ri < r && cj < r) {
        atomicAdd(out + (long long)ri * r + cj, v);
        if ((ri >> 6) != (cj >> 6)) atomicAdd(out + (long long)cj * r + ri, v);
      }
    }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int x, int y, int z,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// The consumer warpgroups' side of the kernel.
__device__ __forceinline__ void consume(const Gram& g, const Run& run, uint32_t ring, uint32_t full,
                                        uint32_t empty, int* __restrict__ out) {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int lane = threadIdx.x & 31;
  const int wg = threadIdx.x >> 7;
  const bool square = g.n_t == 2;  // the one 256-row job
  int acc[160];
#pragma unroll
  for (int e = 0; e < 160; ++e) acc[e] = 0;
  long long p_cur = -1;
  int ti = 0, tj = 0, col0 = 0;
  bool active = false, wide = false;
  for (long long i = 0; i < run.n; ++i) {
    const int st = (int)(i % kStages);
    long long p, t;
    run.at(g, i, &p, &t);
    if (p != p_cur) {
      p_cur = p;
      tile_pair(p, g.n_t, &ti, &tj);
      // Warpgroup 1 of a diagonal tile: columns 64..127 only.
      col0 = (ti == tj && wg == 1) ? 64 : 0;
      active = ti * kTile + wg * 64 < g.r;
      // m64n128 where more than 64 of its columns are live rows.
      wide = min(kTile, g.r - tj * kTile) - col0 > 64;
    }
    mbar_wait(full + 8 * st, (uint32_t)(i / kStages) & 1);
    const uint32_t stage = ring + st * kStageBytes;
    fence_operands<160>(acc);
    wgmma_fence();
    if (square) {
      // Stage row k at stage + 128 k, k < 256.
      if (wg == 0) {
        products<256>(acc, stage, stage);
        if (g.r > 192) products<64>(acc + 128, stage + 192 * 128, stage + 192 * 128);
      } else {
        products<192>(acc, stage + 64 * 128, stage + 64 * 128);
        products<128>(acc + 96, stage + 128 * 128, stage + 128 * 128);
      }
    } else if (active) {
      const uint32_t a = stage + wg * 64 * 128;
      const uint32_t b = stage + (ti == tj ? 0 : kTileBytes) + col0 * 128;
      if (wide)
        products<128>(acc, a, b);
      else
        products<64>(acc, a, b);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands<160>(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);

    if (run.leaves(g, i, p)) {
      // Leaving job p: add the partial sums, and their mirrors.
      if (square) {
        if (wg == 0) {
          add_band<256>(acc, 0, 0, g.r, out);
          add_band<64>(acc + 128, 192, 192, g.r, out);
        } else {
          add_band<192>(acc, 64, 64, g.r, out);
          add_band<128>(acc + 96, 128, 128, g.r, out);
        }
      } else if (active) {
        if (wide)
          add_band<128>(acc, ti * kTile + wg * 64, tj * kTile + col0, g.r, out);
        else
          add_band<64>(acc, ti * kTile + wg * 64, tj * kTile + col0, g.r, out);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    pair_gram_kernel(Gram g, const __grid_constant__ CUtensorMap map, int* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t full = ring + kStages * kStageBytes;  // kStages barriers
  const uint32_t empty = full + kStages * 8;            // kStages barriers
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const Run run(g);

  if (warp >= kConsumers / 32) {
    // The producer warpgroup: its first warp fills the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    for (long long i = 0; warp == kConsumers / 32 && i < run.n; ++i) {
      const int st = (int)(i % kStages);
      const uint32_t ph = (uint32_t)(i / kStages) & 1;
      mbar_wait(empty + 8 * st, ph ^ 1);
      long long p, t;
      run.at(g, i, &p, &t);
      const int s = (int)(t / g.n_chunks);
      const int c = (int)(t - (long long)s * g.n_chunks);
      int ti, tj;
      tile_pair(p, g.n_t, &ti, &tj);
      const uint32_t stage = ring + st * kStageBytes;
      if (lane == 0) {
        mbar_expect_tx(full + 8 * st, (ti == tj ? 1 : 2) * kTileBytes);
        tma_load(stage, &map, c * kChunk, ti * kTile, s, full + 8 * st);
        if (ti != tj) tma_load(stage + kTileBytes, &map, c * kChunk, tj * kTile, s, full + 8 * st);
      }
    }
  } else {
    consume(g, run, ring, full, empty, out);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (null if
// the driver has none).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// rm: int32 words, row i of slice s at rm + s * slice_stride + i *
// row_stride (strides in words, multiples of 4; rows 16-byte aligned);
// out: int32[r, r], zeroed; n_blocks: the persistent grid (ops/kernels.py
// gram_schedule).
extern "C" int pk_pair_gram(const void* rm, void* out, int s, int r, int w,
                            long long slice_stride, long long row_stride, int n_blocks,
                            void* stream) {
  if (s <= 0 || r <= 0 || w <= 0) return (int)cudaSuccess;
  if (n_blocks <= 0 || (w & 3) || (slice_stride & 3) || (row_stride & 3))
    return (int)cudaErrorInvalidValue;
  Gram g;
  g.rm = static_cast<const int*>(rm);
  g.slice_stride = slice_stride;
  g.row_stride = row_stride;
  g.r = r;
  g.w = w;
  g.n_chunks = (w + kChunk - 1) / kChunk;
  g.n_t = (r + kTile - 1) / kTile;
  g.n_k = (long long)s * g.n_chunks;
  if (n_blocks > (g.n_t <= 2 ? 1 : (long long)g.n_t * (g.n_t + 1) / 2) * g.n_k)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {(cuuint64_t)w, (cuuint64_t)r, (cuuint64_t)s};
  const cuuint64_t strides[2] = {(cuuint64_t)row_stride * 4, (cuuint64_t)slice_stride * 4};
  const cuuint32_t box[3] = {kChunk, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(rm), dims, strides, box, unit,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      pair_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  pair_gram_kernel<<<n_blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      g, map, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
