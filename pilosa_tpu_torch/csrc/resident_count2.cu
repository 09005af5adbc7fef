// resident_count2: out[q] = sum_s popcount(op(rm[s, p0], rm[s, p1])) for a
// batch of row pairs, with the rows of one word chunk held in shared
// memory.
//
// Replaces the Pallas kernel fused_resident_count2
// (pilosa_tpu/ops/pallas_kernels.py _resident_count_kernel), the pair
// lane's direct dispatch when the row working set is small next to the
// batch (R < 2B): streaming every row once beats gathering two rows per
// pair.
//
// Bound on this card: bytes — the whole [S, R, W] matrix is read once.
// Design: block (s, y) walks the word chunks c = y, y + gridDim.y, ...
// of slice s.  Per chunk it stages the chunk of ALL R rows in shared
// memory (R x chunk_words x 4 bytes, sized by the wrapper to fit the
// 227 KB per-block budget), then each warp answers its pairs
// (q = warp, warp + n_warps, ...) from shared memory: one int4 per lane,
// popc, warp sum.  A warp owns the same pairs for every chunk, so the
// per-pair partials sit in shared memory without atomics; the block adds
// them into the int32 out[B] (zeroed by the wrapper) with one atomicAdd
// per pair at the end.  Integer atomics are exact and order-independent.
// The TPU kernel's sequential grid carried the sums in VMEM; on Hopper
// blocks run in no order, so the cross-block reduction is the atomic.

#include "common.cuh"

namespace {

template <int OP>
__global__ void __launch_bounds__(256) resident_count2_kernel(
    const int4* __restrict__ rm, const int* __restrict__ pairs, int* __restrict__ out,
    int n_rows, int wv, int cv_shift, int n_chunks, int n_pairs) {
  extern __shared__ int4 smem[];
  const int cv = 1 << cv_shift;  // int4 vectors per row per chunk
  int4* tile = smem;             // [n_rows, cv]
  int* acc = reinterpret_cast<int*>(smem + (size_t)n_rows * cv);  // [n_pairs]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int4* slice = rm + (long long)blockIdx.x * n_rows * wv;

  for (int q = threadIdx.x; q < n_pairs; q += blockDim.x) acc[q] = 0;

  const int total = n_rows << cv_shift;
  for (int c = blockIdx.y; c < n_chunks; c += gridDim.y) {
    __syncthreads();  // the previous chunk's tile is fully consumed
    const int4* src = slice + (long long)c * cv;
#pragma unroll 8
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int r = i >> cv_shift;
      const int v = i & (cv - 1);
      tile[i] = src[(long long)r * wv + v];
    }
    __syncthreads();
    for (int q = warp; q < n_pairs; q += n_warps) {
      const int4* ra = tile + ((size_t)pairs[2 * q] << cv_shift);
      const int4* rb = tile + ((size_t)pairs[2 * q + 1] << cv_shift);
      int part = 0;
      for (int v = lane; v < cv; v += 32) part += popc_op4<OP>(ra[v], rb[v]);
      part = warp_sum(part);
      if (lane == 0) acc[q] += part;
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < n_pairs; q += blockDim.x) {
    const int v = acc[q];
    if (v) atomicAdd(out + q, v);
  }
}

}  // namespace

// rm: int32[s, r, w]; pairs: int32[b, 2] (ids < r); out: int32[b], zeroed.
// chunk_words: power of two dividing w, multiple of 4; grid_y: blocks per
// slice.  Shared memory: r * chunk_words * 4 + b * 4 bytes.
extern "C" int pk_resident_count2(const void* rm, const void* pairs, void* out, int s, int r,
                                  int w, int b, int chunk_words, int grid_y, int op,
                                  void* stream) {
  if (s <= 0 || b <= 0) return (int)cudaSuccess;
  const int cv = chunk_words / 4;
  int cv_shift = 0;
  while ((1 << cv_shift) < cv) ++cv_shift;
  const int n_chunks = w / chunk_words;
  const size_t smem = (size_t)r * chunk_words * 4 + (size_t)b * 4;
  const dim3 grid(s, grid_y);
  const dim3 block(256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PK_DISPATCH_OP(op, {
    cudaError_t e = cudaFuncSetAttribute(resident_count2_kernel<OPC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    resident_count2_kernel<OPC><<<grid, block, smem, st>>>(
        static_cast<const int4*>(rm), static_cast<const int*>(pairs), static_cast<int*>(out),
        r, w / 4, cv_shift, n_chunks, b);
  });
  return (int)cudaGetLastError();
}
