// Linear Deterministic Greedy balanced graph partitioning — host core.
//
// A copy of the JAX package's native core (csrc/ldg_partition.cpp), kept so
// that both packages give the same assignment bit for bit: that package
// runs this core wherever it can build it, and its pure-Python sweep, which
// it falls back to otherwise, assigns nodes differently. Stream nodes in
// random order, place each on the partition maximizing
// |already-local neighbors| * (1 - size/capacity), repeat for `passes`
// refinement sweeps, then rebalance so every partition holds at least
// floor(n / n_parts) nodes.
//
// C ABI for ctypes; no dependencies beyond the C++ standard library. Built
// with the host compiler by leann_torch/ops/cuda_build.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// xorshift128+ — deterministic, seedable, fast; used for the initial
// assignment and per-pass node orders (not numpy-compatible).
struct Rng {
  uint64_t s0, s1;
  explicit Rng(uint64_t seed) {
    s0 = seed * 0x9E3779B97F4A7C15ull + 1;
    s1 = (seed ^ 0xDEADBEEFCAFEBABEull) * 0xBF58476D1CE4E5B9ull + 1;
    for (int i = 0; i < 8; i++) next();
  }
  uint64_t next() {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s1 + y;
  }
  // unbiased-enough bounded draw for shuffles
  uint64_t below(uint64_t n) { return next() % n; }
};

}  // namespace

extern "C" {

// neighbors: i32[n*r] row-major, -1 padded. assign_out: i32[n].
// Returns the number of refinement passes actually run (< 0 on bad args).
int ldg_partition(const int32_t* neighbors, int64_t n, int64_t r,
                  int32_t n_parts, int32_t passes, uint64_t seed,
                  int32_t* assign_out) {
  if (n <= 0 || r <= 0 || n_parts <= 0 || !neighbors || !assign_out) return -1;
  if (n_parts == 1) {
    std::memset(assign_out, 0, sizeof(int32_t) * static_cast<size_t>(n));
    return 0;
  }
  const int64_t cap = (n + n_parts - 1) / n_parts + 1;
  Rng rng(seed);

  std::vector<int32_t> assign(n);
  std::vector<int64_t> sizes(n_parts, 0);
  for (int64_t u = 0; u < n; u++) {
    int32_t p = static_cast<int32_t>(rng.below(n_parts));
    assign[u] = p;
    sizes[p]++;
  }

  std::vector<int64_t> order(n);
  for (int64_t i = 0; i < n; i++) order[i] = i;
  std::vector<double> score(n_parts);
  std::vector<int32_t> counts(n_parts);
  std::vector<int32_t> touched;
  touched.reserve(r);

  int pass = 0;
  for (; pass < passes; pass++) {
    // Fisher-Yates with our rng
    for (int64_t i = n - 1; i > 0; i--) {
      int64_t j = static_cast<int64_t>(rng.below(static_cast<uint64_t>(i + 1)));
      std::swap(order[i], order[j]);
    }
    int64_t moved = 0;
    for (int64_t oi = 0; oi < n; oi++) {
      const int64_t u = order[oi];
      const int32_t* row = neighbors + u * r;
      touched.clear();
      for (int64_t j = 0; j < r; j++) {
        const int32_t v = row[j];
        if (v < 0) continue;
        const int32_t p = assign[v];
        if (counts[p]++ == 0) touched.push_back(p);
      }
      if (touched.empty()) continue;
      // argmax over touched partitions only (others score 0 and can't win
      // unless all touched score <= 0, in which case staying put is fine)
      int32_t best = assign[u];
      double best_score = -1.0;
      for (int32_t p : touched) {
        const double s =
            counts[p] * (1.0 - static_cast<double>(sizes[p]) / cap);
        if (s > best_score) {
          best_score = s;
          best = p;
        }
        counts[p] = 0;  // reset for next node
      }
      const int32_t cur = assign[u];
      if (best != cur && sizes[best] < cap) {
        sizes[cur]--;
        sizes[best]++;
        assign[u] = best;
        moved++;
      }
    }
    if (moved == 0) break;
  }

  // hard rebalance: every partition holds >= floor(n/n_parts) nodes
  const int64_t target_lo = n / n_parts;
  for (;;) {
    int32_t recv = 0, donor = 0;
    for (int32_t p = 1; p < n_parts; p++) {
      if (sizes[p] < sizes[recv]) recv = p;
      if (sizes[p] > sizes[donor]) donor = p;
    }
    if (sizes[recv] >= target_lo) break;
    // move the donor node with the fewest donor-local edges
    int64_t best_u = -1;
    int32_t best_local = INT32_MAX;
    for (int64_t u = 0; u < n; u++) {
      if (assign[u] != donor) continue;
      const int32_t* row = neighbors + u * r;
      int32_t local = 0;
      for (int64_t j = 0; j < r; j++) {
        const int32_t v = row[j];
        if (v >= 0 && assign[v] == donor) local++;
      }
      if (local < best_local) {
        best_local = local;
        best_u = u;
        if (local == 0) break;
      }
    }
    if (best_u < 0) break;
    assign[best_u] = recv;
    sizes[donor]--;
    sizes[recv]++;
  }

  std::memcpy(assign_out, assign.data(), sizeof(int32_t) * static_cast<size_t>(n));
  return pass;
}

}  // extern "C"
