// build_planes: OR each bulk pair's bit into its (slice, row) word plane.
//
//   words[key >> 5] |= 1u << (key & 31)   for every key
//
// where key = gid * 2^20 + local (gid the pair's dense (slice, row) group,
// local its column within the slice), so key >> 5 = gid * 32768 + local / 32
// is the word's index in the [G, 32768] arena.
//
// Replaces the device half of the reference's bulk build lane
// (pilosa_tpu/bulk/build.py build_planes_jax, its jitted `pack`): not a
// Pallas kernel, but the reference's one device lane for bulk writes.  XLA
// has no scatter-OR, so the reference sorts the keys, zeroes every key that
// repeats the one before it, and scatter-ADDs (after the dedup, addition is
// OR).  On this card atomicOr is idempotent: a repeated key ORs the same bit
// again, so the kernel needs neither the sort nor the dedup.  The keys
// arrive sorted by (slice, row, local) from the host's group table
// (group_pairs), so neighbouring lanes touch the same or nearby words.
//
// Bound on this card: bytes — the arena written once (G x 128 KiB) and
// each key read once (8 bytes).  Design: the arena is zeroed by
// cudaMemsetAsync on the launch's stream, then one thread a key,
// grid-stride, one atomicOr a key into it, so every touched sector is
// written a second time (read-modify-write in L2).  A kernel that writes
// each word once from the sorted keys, with no memset and no atomics,
// would come nearer the bound.
// Keys outside [0, n_bits) are dropped, as the reference drops its pads
// into a scratch word: nothing is written out of bounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Grid cap: a larger key count is walked grid-stride.
constexpr long long kMaxBlocks = 1 << 20;

__global__ void __launch_bounds__(kThreads) build_planes_kernel(
    const long long* __restrict__ keys, long long n, unsigned* __restrict__ words,
    unsigned long long n_bits) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    const unsigned long long k = (unsigned long long)keys[i];
    if (k < n_bits) atomicOr(words + (k >> 5), 1u << (unsigned)(k & 31));
  }
}

}  // namespace

// keys: int64[n] (any order); words: int32[n_words], zeroed here on the
// stream first (n_words = G * 32768, so n_bits = 32 * n_words).
extern "C" int pk_build_planes(const void* keys, long long n, void* words, long long n_words,
                               void* stream) {
  if (n < 0 || n_words < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_words == 0) return (int)cudaSuccess;
  cudaError_t err = cudaMemsetAsync(words, 0, (size_t)n_words * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  build_planes_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const long long*>(keys), n, static_cast<unsigned*>(words),
      (unsigned long long)n_words * 32ull);
  return (int)cudaGetLastError();
}
