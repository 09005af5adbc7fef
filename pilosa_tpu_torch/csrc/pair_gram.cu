// pair_gram: G[i, j] = sum_s popcount(rm[s, i] & rm[s, j]) for every row
// pair i, j < R of an int32 matrix rm[S, R, W], exact in int32.
//
// Replaces the reference's all-pairs Gram (pilosa_tpu/ops/bitwise.py:282
// pair_gram), which is not a Pallas kernel: one int8 x int8 -> int32
// product on the MXU over the bits unpacked to 0/1 bytes.  The executor
// builds it once per warm pool and answers every pair op from it.
//
// Bound on this card: bytes at the executor's shape.  At S = 64, R = 256
// the upper triangle is 2.2e12 bit products, 0.47 ms at the b1
// instruction's rate below (4.7e15 a second from registers: mma_probe.cu,
// which chip_smoke.py runs to bound this kernel), against 2 GiB read once
// (0.64 ms); at R = 4,096 over 2 GiB the products bind.  Its shared-memory
// fragment traffic and the mma.sync issue rate hold it above that bound.
//
// Design: tensor cores through mma.sync m16n8k256 b1 with AND-popc, which
// takes 256 packed bits of a row as they lie in memory (no unpack): A is
// 16 rows x 8 words, B 8 rows x 8 words, D[m][n] += popc(A[m] & B[n]).
// (The int8 route, m16n8k32 on bits expanded to 0/1 bytes, needs 3
// integer ops a register to expand and 8x the fragment traffic per bit;
// on the H100 it did 1/17 of b1's bit products: PERF_GATES.md.)  The fragment
// layouts of b1 m16n8k256 are those of f16 m16n8k16 in 32-bit words, so
// ldmatrix.x4 loads them from shared memory.
//
// A block computes one 128 x 128 output tile (ti, tj) with ti <= tj at a
// time: 8 warps of 64 x 32, 64 int32 accumulators a thread, two blocks
// an SM.  The contraction runs over k-tiles, one 32-word chunk of one
// slice each (4 mma steps).  Work units are (tile pair, k-tile), tile-major; blocks
// are persistent and block g of G walks the contiguous, balanced run
// [g*U/G, (g+1)*U/G), so even R = 256 (3 upper tiles) fills every SM:
// the blocks of one tile split its contraction, and those of
// neighbouring tiles read the same rows at the same k-tiles (L2 serves
// the repeat).  Where a block's run leaves a tile it adds its partial
// tile into the zeroed int32 output with atomics, at (i, j) and, off the
// diagonal, at the mirror (j, i).  A diagonal tile stages its rows once.
//
// Operand tiles (128 rows x 32 words) are copied by cp.async 16-byte
// copies into a 2-stage ring (72 KiB a block); a row is padded by 16
// bytes so the 8 rows an ldmatrix reads fall on distinct banks.  (On the
// H100, 32-word chunks in 2 stages at two blocks an SM ran 3-13% faster
// than 64-word chunks in 3 stages at one, and 4 stages of 32 words or
// 16-word chunks were slower still: PERF_GATES.md.)  Rows past R and words
// past W are zero-filled (cp.async's source size 0), so any R and any W
// % 4 == 0 work; a warp whose 64 x 32 sub-tile lies wholly past R skips
// its products.  Slice and row strides are arguments: the executor hands
// a [:, :bucket, :] view of a pool with spare rows, and it is not copied.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 128;            // output rows and columns of a block tile
constexpr int kChunk = 32;            // words of a k-tile: 4 steps of 256 bits
constexpr int kPitch = kChunk + 4;    // shared words a staged row takes
constexpr int kStages = 2;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;
constexpr int kTileInts = kTile * kPitch;          // one operand tile
constexpr int kStageInts = 2 * kTileInts;          // A and B
constexpr int kPieces = kTile * (kChunk / 4);      // 16-byte copies an operand tile
constexpr size_t kSmemBytes = (size_t)kStages * kStageInts * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Upper tile pair p of n_t tiles a side, row-major over i <= j.
__device__ __forceinline__ void tile_pair(long long p, int n_t, int* ti, int* tj) {
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
  long long n_k;                       // k-tiles a tile pair: S x n_chunks

  // Start copying unit u (u < 0: none) into ring buffer buf; every thread
  // commits one group, empty when u < 0.
  __device__ void issue(long long u, int* ring, int buf) const {
    if (u >= 0) {
      const long long p = u / n_k;
      const long long t = u - p * n_k;
      const int s = (int)(t / n_chunks);
      const int c = (int)(t - (long long)s * n_chunks);
      int ti, tj;
      tile_pair(p, n_t, &ti, &tj);
      const int* base = rm + (long long)s * slice_stride + (long long)c * kChunk;
      const int w_left = w - c * kChunk;
      const uint32_t d0 = smem_u32(ring + (size_t)buf * kStageInts);
      const int n = (ti == tj ? 1 : 2) * kPieces;
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int opnd = i / kPieces;          // 0: A rows, 1: B rows
        const int k = (i / (kChunk / 4)) % kTile;
        const int v = i % (kChunk / 4);
        const int row = (opnd ? tj : ti) * kTile + k;
        const bool ok = row < r && v * 4 < w_left;
        const int* src = ok ? base + (long long)row * row_stride + v * 4 : rm;
        const uint32_t dst = d0 + (uint32_t)(opnd * kTileInts + k * kPitch + v * 4) * 4;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                     "r"(ok ? 16 : 0)
                     : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_b1(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) pair_gram_kernel(Gram g, int* __restrict__ out) {
  extern __shared__ __align__(128) int ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;   // 64-row half of the tile
  const int wn = warp >> 1;  // 32-column quarter
  // ldmatrix row addresses (bytes within an operand tile): A takes rows
  // lane % 16 and words (lane / 16) * 4 of each m16 fragment; B takes row
  // lane % 8 + (lane / 16) * 8 and words ((lane / 8) % 2) * 4 of each
  // pair of n8 fragments.
  const uint32_t a_off = ((wm * 64 + (lane & 15)) * kPitch + (lane >> 4) * 4) * 4;
  const uint32_t b_off =
      ((wn * 32 + (lane & 7) + (lane >> 4) * 8) * kPitch + ((lane >> 3) & 1) * 4) * 4;

  const long long n_units = (long long)g.n_t * (g.n_t + 1) / 2 * g.n_k;
  const long long u0 = (long long)blockIdx.x * n_units / gridDim.x;
  const long long u1 = (long long)(blockIdx.x + 1) * n_units / gridDim.x;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0;

  for (int p = 0; p < kStages - 1; ++p) g.issue(u0 + p < u1 ? u0 + p : -1, ring, p);
  for (long long u = u0; u < u1; ++u) {
    const int i = (int)(u - u0);
    const int buf = i % kStages;
    const long long next = u + kStages - 1;
    // The buffer refilled here held unit u - 1, released by the block
    // sync that ended it.
    g.issue(next < u1 ? next : -1, ring, (i + kStages - 1) % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncthreads();

    const long long p = u / g.n_k;
    int ti, tj;
    tile_pair(p, g.n_t, &ti, &tj);
    const uint32_t a_base = smem_u32(ring + (size_t)buf * kStageInts);
    const uint32_t b_base = a_base + (ti == tj ? 0 : kTileInts * 4);
    // A warp whose rows or columns all lie past R (a ragged last tile)
    // has nothing to count.
    if (ti * kTile + wm * 64 < g.r && tj * kTile + wn * 32 < g.r) {
#pragma unroll
      for (int ks = 0; ks < kChunk / 8; ++ks) {
        uint32_t a[4][4], b[4][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(a_base + a_off + (mi * 16 * kPitch + ks * 8) * 4, a[mi][0], a[mi][1],
                  a[mi][2], a[mi][3]);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm_x4(b_base + b_off + (np * 16 * kPitch + ks * 8) * 4, b[2 * np][0], b[2 * np][1],
                  b[2 * np + 1][0], b[2 * np + 1][1]);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) mma_b1(acc[mi][nj], a[mi], b[nj]);
      }
    }
    __syncthreads();  // the buffer is consumed before it refills

    if (u + 1 == u1 || (u + 1) / g.n_k != p) {
      // Leaving tile (ti, tj): add the partial tile, and its mirror.
      // Accumulator e of fragment (mi, nj) is row g + 8 * (e / 2), column
      // 2 * (lane % 4) + e % 2 of that 16 x 8 fragment.
      const int row0 = ti * kTile + wm * 64 + (lane >> 2);
      const int col0 = tj * kTile + wn * 32 + (lane & 3) * 2;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ri = row0 + mi * 16 + (e >> 1) * 8;
            const int cj = col0 + nj * 8 + (e & 1);
            const int v = acc[mi][nj][e];
            acc[mi][nj][e] = 0;
            if (v != 0 && ri < g.r && cj < g.r) {
              atomicAdd(out + (long long)ri * g.r + cj, v);
              if (ti != tj) atomicAdd(out + (long long)cj * g.r + ri, v);
            }
          }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace

// rm: int32 words, row i of slice s at rm + s * slice_stride + i *
// row_stride (strides in words, multiples of 4; rows 16-byte aligned);
// out: int32[r, r], zeroed; n_blocks: the persistent grid
// (ops/kernels.py gram_schedule).
extern "C" int pk_pair_gram(const void* rm, void* out, int s, int r, int w,
                            long long slice_stride, long long row_stride, int n_blocks,
                            void* stream) {
  if (s <= 0 || r <= 0 || w <= 0) return (int)cudaSuccess;
  if (n_blocks <= 0 || (w & 3) || (slice_stride & 3) || (row_stride & 3))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(pair_gram_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  Gram g;
  g.rm = static_cast<const int*>(rm);
  g.slice_stride = slice_stride;
  g.row_stride = row_stride;
  g.r = r;
  g.w = w;
  g.n_chunks = (w + kChunk - 1) / kChunk;
  g.n_t = (r + kTile - 1) / kTile;
  g.n_k = (long long)s * g.n_chunks;
  pair_gram_kernel<<<n_blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
