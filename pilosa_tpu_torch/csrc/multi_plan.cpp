// multi_plan: the launch plan of resident_count_multi, built on the host.
//
// Host code (no device code): ops/kernels.py compiles it with the host C++
// compiler into its own shared library and calls pk_multi_plan through
// ctypes, on the CPU as on the card's machine.  The plan's layout is
// ops/kernels.py MultiPlan's; resident_count_multi.cu reads it.
//
// The queries of a batch share their operands (a Range batch's Counts of
// one bitmap row over overlapping spans name the same day views), so the
// plan cuts the batch into groups of kQ queries that share rows and splits
// each group's rows into classes by the exact set of the group's queries
// that name them; the kernel folds a class's rows once and applies the
// result to each query of its mask.
// - Each query's operands lose their repeats (a fold ignores them; andnot
//   keeps its first operand apart and folds the rest with or: first &
//   ~(rest_1 | rest_2 | ...) is its left fold).
// - The queries are ordered by the connected component of the
//   row-sharing graph they lie in (union-find over the rows; a component
//   is labelled by its least query), then by their sorted operands
//   (lexicographically), then by index, and cut into groups of kQ in that
//   order.
// - A group's rows, each with the mask of its queries naming it, are
//   bucketed by mask: a bucket is a class, in order of mask, its rows in
//   order of first naming (query by query, each's rows ascending).

#include <algorithm>
#include <numeric>
#include <vector>

namespace {

constexpr int kQ = 4;                // queries a group
constexpr int kGroupsPerBlock = 32;  // groups a block of the kernel copies

int find(std::vector<int>& parent, int x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

}  // namespace

// local: int32[b, k], each query's operands as indices into the u staged
// rows ids (int32[u]); lead: 1 for andnot (each query's first operand kept
// apart), else 0 (k > lead); out: room for cap int32s.  Writes the plan
// and returns its length in ints, with the groups in meta[0], the most
// ints one block copies (its groups' records and offsets) in meta[1] and
// the rows the groups' classes fold (the shared-memory reads of a tile's
// vector) in meta[2]; -1 when cap is too small.
extern "C" long long pk_multi_plan(const int* local, int b, int k, const int* ids, int u, int lead,
                                   int* out, long long cap, int* meta) {
  const int kk = k - lead;
  std::vector<int> ops((size_t)b * kk);
  std::vector<int> len(b);
  for (int q = 0; q < b; ++q) {
    int* o = ops.data() + (size_t)q * kk;
    std::copy(local + (size_t)q * k + lead, local + (size_t)(q + 1) * k, o);
    std::sort(o, o + kk);
    len[q] = (int)(std::unique(o, o + kk) - o);
  }
  std::vector<int> parent(u);
  std::iota(parent.begin(), parent.end(), 0);
  for (int q = 0; q < b; ++q) {
    const int* o = ops.data() + (size_t)q * kk;
    const int r0 = find(parent, o[0]);
    for (int j = 1; j < len[q]; ++j) {
      const int r = find(parent, o[j]);
      if (r != r0) parent[r] = r0;
    }
  }
  std::vector<int> label(u, -1), comp(b);
  for (int q = 0; q < b; ++q) {
    const int r = find(parent, ops[(size_t)q * kk]);
    if (label[r] < 0) label[r] = q;
    comp[q] = label[r];
  }
  std::vector<int> order(b);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int x, int y) {
    if (comp[x] != comp[y]) return comp[x] < comp[y];
    const int* a = ops.data() + (size_t)x * kk;
    const int* c = ops.data() + (size_t)y * kk;
    if (std::lexicographical_compare(a, a + len[x], c, c + len[y])) return true;
    if (std::lexicographical_compare(c, c + len[y], a, a + len[x])) return false;
    return x < y;
  });

  const int groups = (b + kQ - 1) / kQ;
  long long at = ((long long)u + groups + 1 + 3) / 4 * 4;
  if (at > cap) return -1;
  std::copy(ids, ids + u, out);
  for (long long i = u; i < at; ++i) out[i] = 0;
  // Per group: each row's mask of the group's queries naming it (mask,
  // reset after the group), the rows in order of first naming (seen),
  // then the rows bucketed by mask (a counting sort: a run of one mask
  // is a class, its rows in order of first naming).
  std::vector<unsigned char> mask(u, 0);
  std::vector<int> seen;
  long long group_rows = 0;
  int count[1 << kQ];
  for (int g = 0; g < groups; ++g) {
    out[u + g] = (int)at;
    seen.clear();
    for (int j = 0; j < kQ; ++j) {
      const int i = g * kQ + j;
      if (i >= b) break;
      const int* o = ops.data() + (size_t)order[i] * kk;
      for (int x = 0; x < len[order[i]]; ++x) {
        if (!mask[o[x]]) seen.push_back(o[x]);
        mask[o[x]] |= (unsigned char)(1 << j);
      }
    }
    group_rows += (long long)seen.size();
    std::fill(count, count + (1 << kQ), 0);
    for (const int r : seen) ++count[mask[r]];
    // At most 15 classes, each a header and up to three ints of padding.
    if (at + 2 * kQ + (long long)seen.size() + 4 * ((1 << kQ) - 1) > cap) return -1;
    for (int j = 0; j < kQ; ++j) {
      const int i = g * kQ + j;
      out[at + j] = i < b ? order[i] : -1;
      out[at + kQ + j] = i < b && lead ? local[(size_t)order[i] * k] : 0;
    }
    at += 2 * kQ;
    int start[1 << kQ];
    long long end = at;
    for (int m = 1; m < (1 << kQ); ++m) {
      if (!count[m]) continue;
      out[end] = m | count[m] << 4;
      start[m] = (int)(end + 1);
      const long long next = end + 4 * ((count[m] + 4) / 4);
      for (long long x = end + 1 + count[m]; x < next; ++x) out[x] = 0;
      end = next;
    }
    for (const int r : seen) {
      out[start[mask[r]]++] = r;
      mask[r] = 0;
    }
    at = end;
  }
  out[u + groups] = (int)at;
  int block_ints = 0;
  for (int g = 0; g < groups; g += kGroupsPerBlock) {
    const int e = std::min(groups, g + kGroupsPerBlock);
    block_ints = std::max(block_ints, out[u + e] - out[u + g]);
  }
  meta[0] = groups;
  meta[1] = block_ints + std::min(groups, kGroupsPerBlock) + 1;
  meta[2] = (int)group_rows;
  return at;
}
