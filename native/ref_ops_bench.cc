// Reference-analog ORDER BY and HashJoin benchmarks.
//
// Faithful single-threaded re-implementations of the reference's
// execution model for the remaining headline operators, raced against
// the device kernels on the same data shapes:
//
//  orderby — the reference fully materializes input rows as
//    Vector<Vector<SValue>> and std::sorts them with a comparator that
//    invokes a compiled cmp expression per pair; ORDER BY ... LIMIT has
//    no top-k shortcut, the full sort runs and the result is trimmed
//    (reference: sql/statements/select/orderby.cc:58-168,
//    sql/scheduler.cc:95 buildOrderByExpression; LIMIT trims batches
//    afterwards, limit.cc).
//
//  join — the reference builds an in-memory multimap of the right
//    table keyed by murmur3-32 (seed 42) of the packed (value, tag)
//    join-key tuple, then probes per base row, re-checking the join
//    condition per candidate (reference:
//    sql/statements/select/hash_join.cc:29-33,123-230,253+).
//
// Usage: ref_ops_bench orderby [rows] [k] [reps]
//        ref_ops_bench join    [rows] [dims] [buckets] [reps]

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <unordered_map>
#include <vector>

// ---- reference value model: boxed scalar with a tag byte -----------
// (sql/svalue.h:58-128 — 16-byte inline data + type/tag)
struct SVal {
  uint64_t payload;
  uint8_t tag;
};

// the comparator goes through a function pointer per pair, modelling
// the reference's per-comparison VM::evaluate of the compiled cmp
// expression (orderby.cc:119-150, vm.cc:107)
using CmpFn = int (*)(const SVal&, const SVal&);
static int cmp_uint64_desc(const SVal& a, const SVal& b) {
  if (a.payload == b.payload) return 0;
  return a.payload > b.payload ? -1 : 1;
}

// ---- murmur3 x86_32 (public domain algorithm), seed 42 -------------
// (the reference hashes the packed join-key tuple with murmur3-32
// seed 42, hash_join.cc:29-33)
static uint32_t murmur3_32(const uint8_t* data, size_t len, uint32_t seed) {
  uint32_t h = seed;
  const uint32_t c1 = 0xcc9e2d51, c2 = 0x1b873593;
  size_t nblocks = len / 4;
  for (size_t i = 0; i < nblocks; ++i) {
    uint32_t k;
    memcpy(&k, data + i * 4, 4);
    k *= c1; k = (k << 15) | (k >> 17); k *= c2;
    h ^= k; h = (h << 13) | (h >> 19); h = h * 5 + 0xe6546b64;
  }
  uint32_t k = 0;
  const uint8_t* tail = data + nblocks * 4;
  switch (len & 3) {
    case 3: k ^= uint32_t(tail[2]) << 16; [[fallthrough]];
    case 2: k ^= uint32_t(tail[1]) << 8;  [[fallthrough]];
    case 1: k ^= tail[0];
            k *= c1; k = (k << 15) | (k >> 17); k *= c2; h ^= k;
  }
  h ^= uint32_t(len);
  h ^= h >> 16; h *= 0x85ebca6b; h ^= h >> 13; h *= 0xc2b2ae35; h ^= h >> 16;
  return h;
}

static uint64_t rng_state = 88172645463325252ULL;
static inline uint64_t xorshift() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return rng_state;
}

static int bench_orderby(size_t n, size_t limit, int reps) {
  // source column
  std::vector<uint64_t> col(n);
  for (size_t i = 0; i < n; ++i) col[i] = xorshift() >> 2;

  double best = 1e100;
  uint64_t check = 0;
  volatile CmpFn cmp = cmp_uint64_desc;  // defeat devirtualization
  for (int rep = 0; rep < reps; ++rep) {
    auto t0 = std::chrono::steady_clock::now();
    // materialize every input row as a boxed-value row vector
    // (orderby.cc:58-117: rows are copied into Vector<Vector<SValue>>)
    std::vector<std::vector<SVal>> rows;
    rows.reserve(n);
    for (size_t i = 0; i < n; ++i)
      rows.push_back({SVal{col[i] + rep, 0}});
    std::sort(rows.begin(), rows.end(),
              [&](const std::vector<SVal>& a, const std::vector<SVal>& b) {
                return cmp(a[0], b[0]) < 0;
              });
    // LIMIT trims after the full sort (limit.cc)
    for (size_t i = 0; i < limit && i < rows.size(); ++i)
      check += rows[i][0].payload & 0xFF;
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    if (dt < best) best = dt;
  }
  printf("{\"name\": \"reference_analog_orderby\", \"rows_per_sec\": %.1f, "
         "\"rows\": %zu, \"limit\": %zu, \"check\": %llu}\n",
         double(n) / best, n, limit, (unsigned long long)check);
  return 0;
}

static int bench_join(size_t n, uint64_t ndim, uint64_t nbuckets, int reps) {
  std::vector<uint64_t> dim_keys(ndim);
  std::vector<uint32_t> dim_bucket(ndim);
  for (uint64_t i = 0; i < ndim; ++i) {
    dim_keys[i] = i * 7919 + 3;
    dim_bucket[i] = uint32_t(xorshift() % nbuckets);
  }
  std::vector<uint64_t> fact_keys(n);
  std::vector<uint64_t> fact_vals(n);
  for (size_t i = 0; i < n; ++i) {
    fact_keys[i] = (xorshift() % ndim) * 7919 + 3;
    fact_vals[i] = xorshift() % 1000;
  }

  double best = 1e100;
  uint64_t check = 0;
  for (int rep = 0; rep < reps; ++rep) {
    auto t0 = std::chrono::steady_clock::now();
    // build: multimap keyed by murmur3-32 of the packed tuple
    // (hash_join.cc:253+ — the bucket is NOT re-checked for equality,
    // the ON condition re-evaluates per candidate, :203-230)
    std::unordered_multimap<uint32_t, uint32_t> built;
    built.reserve(ndim * 2);
    for (uint64_t i = 0; i < ndim; ++i) {
      uint8_t tuple[9];
      memcpy(tuple, &dim_keys[i], 8);
      tuple[8] = 0;
      built.emplace(murmur3_32(tuple, sizeof(tuple), 42), uint32_t(i));
    }
    // probe + aggregate (the fused pipeline the device kernel runs)
    std::vector<uint64_t> sums(nbuckets, 0), counts(nbuckets, 0);
    for (size_t i = 0; i < n; ++i) {
      uint8_t tuple[9];
      uint64_t k = fact_keys[i];
      memcpy(tuple, &k, 8);
      tuple[8] = 0;
      auto range = built.equal_range(murmur3_32(tuple, sizeof(tuple), 42));
      for (auto it = range.first; it != range.second; ++it) {
        // per-candidate join-condition re-check (hash_join.cc:203-230)
        if (dim_keys[it->second] != k) continue;
        uint32_t b = dim_bucket[it->second];
        sums[b] += fact_vals[i] + rep;
        counts[b] += 1;
      }
    }
    for (uint64_t b = 0; b < nbuckets; ++b) check += counts[b];
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    if (dt < best) best = dt;
  }
  printf("{\"name\": \"reference_analog_join\", \"rows_per_sec\": %.1f, "
         "\"rows\": %zu, \"dims\": %llu, \"check\": %llu}\n",
         double(n) / best, n, (unsigned long long)ndim,
         (unsigned long long)check);
  return 0;
}

int main(int argc, char** argv) {
  const char* mode = argc > 1 ? argv[1] : "orderby";
  if (!strcmp(mode, "orderby")) {
    size_t n = argc > 2 ? strtoull(argv[2], nullptr, 10) : 100000000ULL;
    size_t k = argc > 3 ? strtoull(argv[3], nullptr, 10) : 100;
    int reps = argc > 4 ? atoi(argv[4]) : 1;
    return bench_orderby(n, k, reps);
  }
  if (!strcmp(mode, "join")) {
    size_t n = argc > 2 ? strtoull(argv[2], nullptr, 10) : (1ULL << 24);
    uint64_t d = argc > 3 ? strtoull(argv[3], nullptr, 10) : 1024;
    uint64_t b = argc > 4 ? strtoull(argv[4], nullptr, 10) : 1024;
    int reps = argc > 5 ? atoi(argv[5]) : 3;
    return bench_join(n, d, b, reps);
  }
  fprintf(stderr, "usage: %s orderby|join [...]\n", argv[0]);
  return 2;
}
