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
// OR).  Here the keys arrive in ascending order (the host's group table,
// group_pairs, sorts the pairs by (slice, row, local) and numbers the groups
// densely in that order), so the keys of any run of arena words are one
// contiguous run of the key array.
//
// Bound on this card: bytes — the arena written once (G x 128 KiB) and
// each key read once (8 bytes).  Design: each arena word is written exactly
// once, by one launch, with no memset and no atomics to device memory.  The
// arena is cut into tiles of kTileWords words; persistent blocks
// (kBlocksPerSm an SM) own contiguous, balanced runs of tiles.  A block
// finds the first key of its run with one block-wide search (each step 256
// probes and one barrier, so 2^17 to 2^23 keys take 3 dependent steps),
// then walks tiles and keys together: a window of 256 keys at the cursor
// is ORed into the tile in shared memory (shared-memory atomicOr: combining
// a warp's lanes of one word first, by __match_any_sync and
// __reduce_or_sync, took longer at every timed shape on the H100:
// PERF_GATES.md), the count of keys below the tile's end advances
// the cursor, and the tile is written out with 16-byte stores and zeroed for
// the next one.  The next window is loaded before the tile is written out,
// so its latency overlaps the stores.  A tile that no key falls in is
// written as zeros.  Keys outside [0, n_bits) are dropped: the ones below 0
// lie before block 0's search result, the ones past the arena after the
// last tile.
//
// Order: the kernel records in flags[b] whether block b met a key below the
// one before it.  Each block checks the pairs (i - 1, i) of its own key run
// [c_lo, c_hi): the runs come from the same search at each run's first bit,
// and that search is monotone in its target even on unsorted keys (two
// targets part where a probe's comparison differs, and then the smaller
// goes left), so the runs partition [0, n) whatever the keys.  Either every
// pair is checked and none descends (the keys ascend and the planes are
// right), or some flag is set: the wrapper's caller reads the flags after
// the copy that brings the planes back and raises.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;              // keys a window and probes a search step
constexpr int kTileWords = 4096;           // 16 KiB of shared memory a block
constexpr int kBlocksPerSm = 4;
constexpr int kTileVecs = kTileWords / 4;
constexpr long long kTileBits = (long long)kTileWords * 32;

// The sum of v over the block, in every thread: one barrier.  The two
// halves of `part` take turns, so a call's writes never meet the reads of
// the call before it.
__device__ __forceinline__ int block_sum(int v, int (*part)[kThreads / 32], int& turn) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) part[turn][threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += part[turn][w];
  turn ^= 1;
  return s;
}

// The first index in [0, n) whose key is >= x on ascending keys (n if
// none), for two targets at once; every thread returns the same results.
// A step probes kThreads positions spread over the candidate range, one a
// thread, and narrows it to the gap between the last probe below the
// target and the next one: 2^17 to 2^23 keys take 3 steps.
__device__ void search2(const long long* __restrict__ keys, long long n, long long x0,
                        long long x1, long long* r0, long long* r1, int (*part)[kThreads / 32],
                        int& turn) {
  long long lo[2] = {0, 0}, hi[2] = {n, n};
  const long long x[2] = {x0, x1};
  while (hi[0] > lo[0] || hi[1] > lo[1]) {
    int below = 0;  // target 0's count in the low half, target 1's in the high
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long long m = hi[s] - lo[s];
      const long long l = threadIdx.x;
      // Final step: every candidate probed.
      const long long pos = m <= kThreads ? lo[s] + l : lo[s] + (l + 1) * m / (kThreads + 1);
      if (m > 0 && (m > kThreads || l < m) && keys[pos] < x[s]) below += 1 << (16 * s);
    }
    const int sum = block_sum(below, part, turn);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long long m = hi[s] - lo[s];
      const long long c = (sum >> (16 * s)) & 0xffff;
      if (m == 0) continue;
      if (m <= kThreads) {
        lo[s] += c;
        hi[s] = lo[s];
      } else {
        const long long a = c == 0 ? lo[s] : lo[s] + c * m / (kThreads + 1) + 1;
        const long long b = c == kThreads ? hi[s] : lo[s] + (c + 1) * m / (kThreads + 1);
        lo[s] = a;
        hi[s] = b;
      }
    }
  }
  *r0 = lo[0];
  *r1 = lo[1];
}

// The window of keys at a cursor: thread t holds key cursor + t if it lies
// below `end`, and whether it lies below the key before it.
struct Window {
  long long key;
  bool in;
  bool desc;
};

__device__ __forceinline__ Window load_window(const long long* __restrict__ keys,
                                              long long cursor, long long end) {
  const long long i = cursor + threadIdx.x;
  Window w{0, i < end, false};
  if (w.in) {
    w.key = keys[i];
    w.desc = i > 0 && w.key < keys[i - 1];
  }
  return w;
}

__global__ void __launch_bounds__(kThreads) build_planes_kernel(
    const long long* __restrict__ keys, long long n, unsigned* __restrict__ words,
    long long n_tiles, int* __restrict__ flags) {
  __shared__ __align__(16) unsigned tile[kTileWords];
  __shared__ int part[2][kThreads / 32];
  int turn = 0;
  const int t = threadIdx.x;
  const long long b = blockIdx.x, nb = gridDim.x;
  const long long t0 = b * n_tiles / nb, t1 = (b + 1) * n_tiles / nb;
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  for (int v = t; v < kTileVecs; v += kThreads) tile4[v] = make_uint4(0, 0, 0, 0);

  long long start, next;
  search2(keys, n, t0 * kTileBits, t1 * kTileBits, &start, &next, part, turn);
  // This block's run of the key array: block 0's also holds the keys
  // below 0, the last block's the keys past the arena.
  const long long c_lo = b == 0 ? 0 : start;
  const long long c_hi = b == nb - 1 ? n : next;
  bool desc = false;

  long long cursor = start;
  Window w = load_window(keys, cursor, c_hi);
  for (long long tt = t0; tt < t1; ++tt) {
    const long long bit0 = tt * kTileBits;
    for (;;) {
      desc |= w.desc;
      const bool take = w.in && w.key >= bit0 && w.key < bit0 + kTileBits;
      if (take) atomicOr(tile + ((w.key - bit0) >> 5), 1u << (unsigned)(w.key & 31));
      // The barrier inside orders the ORs before the tile is read out.
      const int c = block_sum(take, part, turn);
      cursor += c;
      w = load_window(keys, cursor, c_hi);
      // On ascending keys the taken ones are a prefix of the window: fewer
      // than a full window means the rest lie past this tile.
      if (c < kThreads) break;
    }
    uint4* out = reinterpret_cast<uint4*>(words + tt * kTileWords);
    for (int v = t; v < kTileVecs; v += kThreads) {
      out[v] = tile4[v];
      tile4[v] = make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
  }
  // Pairs of the run no window loaded: on ascending keys only keys outside
  // the arena.
  for (long long i = c_lo + t; i < start; i += kThreads) desc |= i > 0 && keys[i] < keys[i - 1];
  for (long long i = cursor + t; i < c_hi; i += kThreads) desc |= i > 0 && keys[i] < keys[i - 1];
  const int any = __syncthreads_or(desc);
  if (t == 0) flags[b] = any;
}

}  // namespace

// keys: int64[n], ascending (repeats allowed); words: int32[n_words]
// (n_words = G * 32768, a multiple of kTileWords), every word written;
// flags: int32[n_blocks], flags[b] != 0 where block b met a descent (the
// planes are then wrong); n_blocks: the persistent grid
// (ops/kernels.py build_schedule).
extern "C" int pk_build_planes(const void* keys, long long n, void* words, long long n_words,
                               void* flags, int n_blocks, void* stream) {
  if (n < 0 || n_words < 0 || n_words % kTileWords || n_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  if (n_words == 0) return (int)cudaSuccess;
  const long long n_tiles = n_words / kTileWords;
  if (n_blocks > n_tiles) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  unsigned* wd = static_cast<unsigned*>(words);
  int* fl = static_cast<int*>(flags);
  build_planes_kernel<<<n_blocks, kThreads, 0, st>>>(k, n, wd, n_tiles, fl);
  return (int)cudaGetLastError();
}
