// mma_probe: the tensor-core rates of the two b1 AND-popc instructions on
// packed words.
//
// pk_mma_probe: mma.sync m16n8k256 (32,768 bit products an instruction),
// from registers, at the warp tile of the Gram's first design (64 x 32
// outputs: 4 x 4 fragments a k-step, 16 independent accumulators a
// thread).
//
// pk_wgmma_probe: wgmma m64n128k256 (2,097,152 bit products an
// instruction), the instruction of pair_gram.cu, from shared memory at its
// tile: two warpgroups a block, each 64 rows of a 128 x 128-byte A tile
// against a 128 x 128-byte B tile under the 128-byte swizzle, four k-steps
// a group, committed and waited for as pair_gram.cu does a unit.
//
// Not a kernel of the port: the card's data sheet gives no 1-bit rate, so
// chip_smoke.py builds this beside the kernels and bounds the Gram's bit
// products by the faster rate it measures.

#include <stdint.h>

#include <cuda_runtime.h>

#include "wgmma_b1.cuh"

namespace {

__device__ __forceinline__ void mma_b1(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(256) probe_kernel(int iters, int* __restrict__ out) {
  const uint32_t seed = threadIdx.x * 0x9E3779B9u + blockIdx.x;
  uint32_t a[4][4], b[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[mi][e] = seed * (mi * 4 + e + 1);
#pragma unroll
  for (int nj = 0; nj < 4; ++nj)
#pragma unroll
    for (int e = 0; e < 2; ++e) b[nj][e] = seed ^ (nj * 2 + e + 7) * 0x85EBCA6Bu;
  int acc[4][4][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) mma_b1(acc[mi][nj], a[mi], b[nj]);
  }
  int sum = 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum += acc[mi][nj][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

constexpr int kTileBytes = 128 * 128;

__global__ void __launch_bounds__(256) wgmma_probe_kernel(int iters, int* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  unsigned char* gen = smem_raw + (base - smem_u32(smem_raw));
  // Both tiles filled with seeded words (the layout does not change the rate).
  uint32_t* words = reinterpret_cast<uint32_t*>(gen);
  for (int i = threadIdx.x; i < 2 * kTileBytes / 4; i += blockDim.x)
    words[i] = (i + 1) * 0x9E3779B9u ^ blockIdx.x;
  fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  const uint64_t da = sw128_desc(base + wg * 64 * 128);
  const uint64_t db = sw128_desc(base + kTileBytes);
  int acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;
  for (int it = 0; it < iters; ++it) {
    fence_operands<64>(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_b1<128>(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands<64>(acc);
  }
  int sum = 0;
#pragma unroll
  for (int e = 0; e < 64; ++e) sum += acc[e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

}  // namespace

// out: int32[blocks * 256].  Each block's two warpgroups run iters groups
// of 4 products (m64n128k256).
extern "C" int pk_wgmma_probe(int blocks, int iters, void* out, void* stream) {
  const int smem = 2 * kTileBytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(wgmma_probe_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_probe_kernel<<<blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int*>(out));
  return (int)cudaGetLastError();
}

// out: int32[blocks * 256].  Each of the blocks' 8 warps runs iters
// steps of 16 products.
extern "C" int pk_mma_probe(int blocks, int iters, void* out, void* stream) {
  probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(iters, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
