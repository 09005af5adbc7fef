// Shared device helpers for the fused popcount kernels.
//
// Words are 32-bit (int32 on the torch side, a bit-exact view of the
// uint32 packed bitmap words).  Every kernel reads its rows as int4
// vectors: four words per 16-byte load, neighbouring threads on
// neighbouring addresses, which is the load width Hopper streams fastest.
// Callers guarantee W % 4 == 0 and 16-byte aligned rows.

#pragma once

#include <cuda_runtime.h>

// Pair op codes: the wrapper's op name -> template argument.
enum PairOp { OP_NONE = 0, OP_AND = 1, OP_OR = 2, OP_XOR = 3, OP_ANDNOT = 4 };

template <int OP>
__device__ __forceinline__ int apply_op(int a, int b) {
  if (OP == OP_AND) return a & b;
  if (OP == OP_OR) return a | b;
  if (OP == OP_XOR) return a ^ b;
  if (OP == OP_ANDNOT) return a & ~b;
  return a;
}

// The op applied to each of four words.
template <int OP>
__device__ __forceinline__ int4 op4(int4 a, int4 b) {
  return make_int4(apply_op<OP>(a.x, b.x), apply_op<OP>(a.y, b.y), apply_op<OP>(a.z, b.z),
                   apply_op<OP>(a.w, b.w));
}

template <int OP>
__device__ __forceinline__ int popc_op4(int4 a, int4 b) {
  return __popc(apply_op<OP>(a.x, b.x)) + __popc(apply_op<OP>(a.y, b.y)) +
         __popc(apply_op<OP>(a.z, b.z)) + __popc(apply_op<OP>(a.w, b.w));
}

__device__ __forceinline__ int popc4(int4 a) {
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the block; the result is valid in thread 0.  blockDim.x must
// be a multiple of 32 and at most 1024.
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int partial[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = (threadIdx.x < n_warps) ? partial[threadIdx.x] : 0;
  if (warp == 0) v = warp_sum(v);
  return v;
}

// Dispatch a runtime op code to the OP template argument.
#define PK_DISPATCH_OP(op, ...)                           \
  switch (op) {                                           \
    case OP_NONE: { constexpr int OPC = OP_NONE; __VA_ARGS__; } break;     \
    case OP_AND: { constexpr int OPC = OP_AND; __VA_ARGS__; } break;       \
    case OP_OR: { constexpr int OPC = OP_OR; __VA_ARGS__; } break;         \
    case OP_XOR: { constexpr int OPC = OP_XOR; __VA_ARGS__; } break;       \
    case OP_ANDNOT: { constexpr int OPC = OP_ANDNOT; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;           \
  }
