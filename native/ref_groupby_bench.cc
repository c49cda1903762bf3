// Reference-analog hash-aggregate benchmark.
//
// A faithful single-threaded re-implementation of EventQL's GroupBy
// inner loop so the device kernel can be compared against the
// reference's own execution model on the same host and data:
//   per row: evaluate the WHERE predicate, evaluate the group
//   expression, SHA1 the packed (value, tag) key tuple, look the
//   digest up in a hash map of accumulator instances, and accumulate
//   sum + count (reference: sql/statements/select/groupby.cc:69-219 —
//   the per-row SHA1 of the packed tuple is the reference's own
//   design, groupby.cc:129-135; accumulators are
//   sum_uint64/count vtable instances, sql/expressions/aggregate.cc).
//
// The data distribution matches bench.py's BENCH_CONFIG=groupby:
// 16.7M rows, gid uniform in [0, K), values uniform in [0, 1000),
// WHERE value + rep < 800. Output: one JSON line with rows/s.
//
// Build: make -C native  (produces build/ref_groupby_bench)
// Usage: ref_groupby_bench [rows] [keys] [reps]

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <chrono>
#include <unordered_map>
#include <vector>

// ---- SHA-1 (FIPS 180-1, textbook implementation) --------------------
struct SHA1 {
  uint32_t h[5];
  void init() {
    h[0] = 0x67452301; h[1] = 0xEFCDAB89; h[2] = 0x98BADCFE;
    h[3] = 0x10325476; h[4] = 0xC3D2E1F0;
  }
  static uint32_t rol(uint32_t v, int s) {
    return (v << s) | (v >> (32 - s));
  }
  void block(const uint8_t* p) {
    uint32_t w[80];
    for (int i = 0; i < 16; ++i)
      w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
             (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
    for (int i = 16; i < 80; ++i)
      w[i] = rol(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1);
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4];
    for (int i = 0; i < 80; ++i) {
      uint32_t f, k;
      if (i < 20)      { f = (b & c) | (~b & d);            k = 0x5A827999; }
      else if (i < 40) { f = b ^ c ^ d;                     k = 0x6ED9EBA1; }
      else if (i < 60) { f = (b & c) | (b & d) | (c & d);   k = 0x8F1BBCDC; }
      else             { f = b ^ c ^ d;                     k = 0xCA62C1D6; }
      uint32_t t = rol(a, 5) + f + e + k + w[i];
      e = d; d = c; c = rol(b, 30); b = a; a = t;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d; h[4] += e;
  }
  // single-shot digest of a short (<56 byte) message — the packed
  // group-key tuple is 9 bytes, so one padded block suffices
  void digest_short(const uint8_t* msg, size_t len, uint8_t out[20]) {
    init();
    uint8_t buf[64];
    memset(buf, 0, sizeof(buf));
    memcpy(buf, msg, len);
    buf[len] = 0x80;
    uint64_t bits = uint64_t(len) * 8;
    for (int i = 0; i < 8; ++i) buf[56 + i] = uint8_t(bits >> (56 - 8 * i));
    block(buf);
    for (int i = 0; i < 5; ++i) {
      out[i * 4] = uint8_t(h[i] >> 24);
      out[i * 4 + 1] = uint8_t(h[i] >> 16);
      out[i * 4 + 2] = uint8_t(h[i] >> 8);
      out[i * 4 + 3] = uint8_t(h[i]);
    }
  }
};

struct Digest {
  uint8_t b[20];
  bool operator==(const Digest& o) const { return !memcmp(b, o.b, 20); }
};
struct DigestHash {
  size_t operator()(const Digest& d) const {
    size_t v;
    memcpy(&v, d.b, sizeof(v));  // the digest is already uniform
    return v;
  }
};

// accumulator instance (reference: sum_uint64 + count instances,
// sql/expressions/aggregate.cc:35-38,178-190)
struct Instance {
  uint64_t sum = 0;
  uint64_t count = 0;
};

// xorshift64* — deterministic data, matching bench.py's distribution
// shape (uniform gid, uniform values) without depending on numpy's RNG
static uint64_t rng_state = 88172645463325252ULL;
static inline uint64_t xorshift() {
  rng_state ^= rng_state << 13;
  rng_state ^= rng_state >> 7;
  rng_state ^= rng_state << 17;
  return rng_state;
}

int main(int argc, char** argv) {
  size_t n = argc > 1 ? strtoull(argv[1], nullptr, 10) : (1ULL << 24);
  uint64_t k = argc > 2 ? strtoull(argv[2], nullptr, 10) : 1024;
  int reps = argc > 3 ? atoi(argv[3]) : 3;

  std::vector<uint32_t> gid(n);
  std::vector<uint64_t> values(n);
  for (size_t i = 0; i < n; ++i) {
    gid[i] = uint32_t(xorshift() % k);
    values[i] = xorshift() % 1000;
  }

  double best = 1e100;
  uint64_t check = 0;
  for (int rep = 0; rep < reps; ++rep) {
    auto t0 = std::chrono::steady_clock::now();
    std::unordered_map<Digest, Instance, DigestHash> groups;
    groups.reserve(k * 2);
    SHA1 sha;
    for (size_t i = 0; i < n; ++i) {
      // WHERE value + rep < 800 (vectorized as
      // evaluatePredicateVector in the reference; scalar here matches
      // the GroupBy path's per-row evaluate, groupby.cc:107-120)
      uint64_t v = values[i] + uint64_t(rep);
      if (v >= 800) continue;
      // packed (value, tag) tuple of the group expression: u64 payload
      // + 1 STag byte (reference: sql_sizeof_tuple, svalue.cc:569)
      uint8_t tuple[9];
      uint64_t g = gid[i];
      memcpy(tuple, &g, 8);
      tuple[8] = 0;
      Digest d;
      sha.digest_short(tuple, sizeof(tuple), d.b);
      Instance& inst = groups[d];
      inst.sum += v;      // sum_uint64_acc (aggregate.cc:178-186)
      inst.count += 1;    // count_acc (aggregate.cc:35-38)
    }
    uint64_t total = 0;
    for (auto& kv : groups) total += kv.second.count;
    check += total;
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0).count();
    if (dt < best) best = dt;
  }

  printf("{\"name\": \"reference_analog_groupby\", \"rows_per_sec\": %.1f, "
         "\"rows\": %zu, \"keys\": %llu, \"check\": %llu}\n",
         double(n) / best, n, (unsigned long long)k,
         (unsigned long long)check);
  return 0;
}
