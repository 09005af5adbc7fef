// A ring of staged shared-memory tiles fed by one producer warp through
// full / empty mbarrier pairs (resident_count_multi).
//
// A tile is what csrc/stage.cuh stages: the word chunk c (chunk_words
// words) of U listed rows of one slice s, row k of the tile the chunk c of
// row ids[k], 4 * chunk_words contiguous bytes at rm + s * slice_stride +
// ids[k] * row_stride + c * chunk_words (strides in words).  A block walks
// the contiguous, balanced run of tiles [g*T/G, (g+1)*T/G) of the T = S x
// W/chunk_words (slice, chunk) tiles, slice-major, as stage_walk does.
//
// What differs from stage_walk: no block-wide barrier.  The block's last
// P warps are producers.  For tile i they wait until stage i % stages is
// empty (every consumer warp has released the tile it held), spread the
// tile's 16-byte cp.async copies over their 32 x P lanes, and each lane
// ends with cp.async.mbarrier.arrive.noinc on the stage's "full" barrier
// (32 x P arrivals a phase), which fires once that lane's copies have
// landed.
// Each consumer warp waits on "full" for its own stage only, folds the
// tile, and its lane 0 arrives on "empty" (one arrival a consumer warp a
// phase).  Up to `stages` tiles are in flight or held at once: the
// producer runs ahead of the slowest consumer by the ring's depth.
//
// Shared memory: [stages x U x chunk_words ints: tiles][2 x stages
// mbarriers: full, then empty][the kernel's own].

#pragma once

#include <stdint.h>

#include "stage.cuh"

// Bytes reserved for the barriers of a ring of up to kRingMaxStages stages.
constexpr int kRingMaxStages = 4;
constexpr int kRingBarBytes = 2 * kRingMaxStages * 8;

__device__ __forceinline__ void ring_bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void ring_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrive on the barrier once every cp.async this thread issued before
// has landed; the arrival counts toward the barrier's expected count.
__device__ __forceinline__ void ring_copies_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A wait this long (about 10 s at the H100's clocks) means a lost
// arrival: the launch traps and fails instead of hanging the card.
constexpr long long kRingWaitTrapCycles = 20000000000LL;

// Waits for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void ring_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > kRingWaitTrapCycles) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

struct Ring {
  const int* rm;         // global int32 matrix, [S, R, W] or [R, S, W]
  const int* ids;        // shared int32[U]: matrix row of tile row k
  unsigned char* tiles;  // shared, stages x U x chunk_words ints
  uint32_t bars;         // shared address of full[0]; empty[s] follows the full ones
  long long row_stride, slice_stride;  // words from one row / slice to the next
  int u, chunk_words, n_chunks, stages;

  __device__ size_t tile_bytes() const { return (size_t)u * chunk_words * 4; }
  __device__ const unsigned char* tile(int s) const { return tiles + (size_t)s * tile_bytes(); }
  __device__ uint32_t full(int s) const { return bars + 8u * s; }
  __device__ uint32_t empty(int s) const { return bars + 8u * (stages + s); }

  // One thread: the barriers, before the block's first __syncthreads.
  __device__ void init(int consumer_warps, int producer_warps) const {
    for (int s = 0; s < stages; ++s) {
      ring_bar_init(full(s), 32 * producer_warps);
      ring_bar_init(empty(s), consumer_warps);
    }
  }

  // A producer thread (every lane of the P producer warps; p its index
  // among their 32 x P lanes): its share of tiles [t0, t1) into the ring.
  __device__ void produce(long long t0, long long t1, int p, int producer_threads) const {
    const int per_row = chunk_words >> 2;  // 16-byte pieces a row
    int shift = 0;
    while ((1 << shift) < per_row) ++shift;
    const int total = u << shift;
    int s = 0;
    uint32_t round = 0;
    for (long long t = t0; t < t1; ++t) {
      if (round) ring_wait(empty(s), (round - 1) & 1);
      const int sl = (int)(t / n_chunks);
      const int c = (int)(t - (long long)sl * n_chunks);
      const int* base = rm + (long long)sl * slice_stride + (long long)c * chunk_words;
      const uint32_t d0 = smem_u32(tile(s));
      // No memory clobber: the row ids' shared loads may run ahead of
      // the copies (the waits order the copies against the consumers).
#pragma unroll 4
      for (int i = p; i < total; i += producer_threads) {
        const int k = i >> shift;
        const int v = i & (per_row - 1);
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d0 + (uint32_t)i * 16),
                     "l"(base + (long long)ids[k] * row_stride + v * 4));
      }
      ring_copies_arrive(full(s));
      if (++s == stages) {
        s = 0;
        ++round;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }

  // A consumer warp (every lane): fold(tile) on each of tiles [t0, t1) as
  // it lands, then release its stage.
  template <typename Fold>
  __device__ __forceinline__ void consume(long long t0, long long t1, int lane, Fold&& fold) const {
    int s = 0;
    uint32_t round = 0;
    for (long long t = t0; t < t1; ++t) {
      ring_wait(full(s), round & 1);
      fold(tile(s));
      __syncwarp();
      if (lane == 0) ring_arrive(empty(s));
      if (++s == stages) {
        s = 0;
        ++round;
      }
    }
  }
};
