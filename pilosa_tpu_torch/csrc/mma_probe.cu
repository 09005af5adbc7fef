// mma_probe: the tensor-core rate of pair_gram.cu's instruction,
// mma.sync m16n8k256 b1 AND-popc on packed words (32,768 bit products an
// instruction), from registers, at pair_gram.cu's warp tile (64 x 32
// outputs: 4 x 4 fragments a k-step, 16 independent accumulators a
// thread).
//
// Not a kernel of the port: the card's data sheet gives no 1-bit rate, so
// chip_smoke.py builds this beside the kernels and bounds the Gram's bit
// products by the rate it measures.

#include <stdint.h>

#include <cuda_runtime.h>

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

}  // namespace

// out: int32[blocks * 256].  Each of the blocks' 8 warps runs iters
// steps of 16 products.
extern "C" int pk_mma_probe(int blocks, int iters, void* out, void* stream) {
  probe_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(iters, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
