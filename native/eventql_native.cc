// eventql_tpu native runtime: columnar codec hot paths.
//
// The reference implements its columnar file codecs in C++
// (reference: io/cstable/columns/*, util/util/BitPackDecoder.cc,
// deps/3rdparty/libsimdcomp). This library provides the same
// decode primitives for the engine's host-side ingest path,
// exposed through a plain C ABI consumed via ctypes
// (eventql_tpu/columnar/native.py). The numpy implementations in
// eventql_tpu/columnar/cstable.py are the semantic reference; this
// library must match them bit-for-bit (tests/test_native_codec.py).
//
// Build: make -C native   (produces build/libeventql_native.so)

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// Decode `n` values from simdcomp SIMD-BP128 vertical bit-packing
// (128-value blocks, 16*maxbits bytes per block; value order within a
// block is out[4*k + lane] across 4 interleaved 32-bit lanes).
// Returns 0 on success, -1 if the buffer is too small.
int evql_simdbp128_unpack(
    const uint8_t* buf,
    uint64_t buf_len,
    uint32_t maxbits,
    uint64_t n,
    uint32_t* out) {
  if (maxbits == 0) {
    memset(out, 0, n * sizeof(uint32_t));
    return 0;
  }
  if (maxbits > 32) {
    return -1;
  }

  const uint64_t nblocks = (n + 127) / 128;
  const uint64_t block_bytes = 16ull * maxbits;
  if (buf_len < nblocks * block_bytes) {
    return -1;
  }

  const uint32_t mask =
      maxbits == 32 ? 0xffffffffu : ((1u << maxbits) - 1u);

  uint64_t out_pos = 0;
  for (uint64_t blk = 0; blk < nblocks; ++blk) {
    const uint32_t* words =
        reinterpret_cast<const uint32_t*>(buf + blk * block_bytes);
    // words layout: [word][lane], word = 0..maxbits-1, lane = 0..3
    for (uint32_t lane = 0; lane < 4; ++lane) {
      // per-lane bitstream: 32 values of `maxbits` bits, LSB-first
      // across the lane's words
      uint64_t acc = 0;
      uint32_t acc_bits = 0;
      uint32_t w = 0;
      for (uint32_t k = 0; k < 32; ++k) {
        while (acc_bits < maxbits && w < maxbits) {
          acc |= static_cast<uint64_t>(words[w * 4 + lane]) << acc_bits;
          acc_bits += 32;
          ++w;
        }
        const uint64_t idx = blk * 128 + 4ull * k + lane;
        if (idx < n) {
          out[idx] = static_cast<uint32_t>(acc) & mask;
        }
        acc >>= maxbits;
        acc_bits -= maxbits;
      }
    }
    out_pos += 128;
    (void)out_pos;
  }
  return 0;
}

// Decode `count` LEB128 varints. Returns the number of bytes consumed,
// or -1 on truncated input.
int64_t evql_leb128_decode(
    const uint8_t* buf,
    uint64_t buf_len,
    uint64_t count,
    uint64_t* out) {
  uint64_t pos = 0;
  for (uint64_t i = 0; i < count; ++i) {
    uint64_t v = 0;
    uint32_t shift = 0;
    for (;;) {
      if (pos >= buf_len) {
        return -1;
      }
      const uint8_t b = buf[pos++];
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      shift += 7;
      if (!(b & 0x80)) {
        break;
      }
    }
    out[i] = v;
  }
  return static_cast<int64_t>(pos);
}

// Encode `count` values as LEB128 varints into `out` (caller allocates
// count*10 bytes, the worst case). Returns bytes written. The segment
// flush encodes every UINT64/INT64 column this way
// (reference encoder: io/cstable/columns/UnsignedIntColumnWriter via
// util/util/binarymessagewriter appendVarUInt) — the Python
// per-byte-append version was 66% of the whole insert wall.
int64_t evql_leb128_encode(
    const uint64_t* vals,
    uint64_t count,
    uint8_t* out) {
  uint8_t* p = out;
  for (uint64_t i = 0; i < count; ++i) {
    uint64_t v = vals[i];
    while (v >= 0x80) {
      *p++ = static_cast<uint8_t>(v) | 0x80;
      v >>= 7;
    }
    *p++ = static_cast<uint8_t>(v);
  }
  return static_cast<int64_t>(p - out);
}

// Parse [u32 len][bytes] length-prefixed strings: writes each value's
// (offset, length) pair. Returns bytes consumed or -1 on truncation.
int64_t evql_lenenc_strings(
    const uint8_t* buf,
    uint64_t buf_len,
    uint64_t count,
    uint64_t* offsets,
    uint32_t* lengths) {
  uint64_t pos = 0;
  for (uint64_t i = 0; i < count; ++i) {
    if (pos + 4 > buf_len) {
      return -1;
    }
    uint32_t len;
    memcpy(&len, buf + pos, 4);
    pos += 4;
    if (pos + len > buf_len) {
      return -1;
    }
    offsets[i] = pos;
    lengths[i] = len;
    pos += len;
  }
  return static_cast<int64_t>(pos);
}

// Scatter defined values into a dense row vector: out[i] = values[j++]
// where dlvls[i] == d_max else 0. uint64 variant.
void evql_scatter_defined_u64(
    const uint32_t* dlvls,
    uint64_t n,
    uint32_t d_max,
    const uint64_t* values,
    uint64_t* out,
    uint8_t* valid) {
  uint64_t j = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (dlvls[i] == d_max) {
      out[i] = values[j++];
      valid[i] = 1;
    } else {
      out[i] = 0;
      valid[i] = 0;
    }
  }
}

}  // extern "C"

// -- record-id SHA1 batch (insert hot path) ---------------------------
//
// The reference keys every record by the SHA1 of its packed primary
// key, computed in C++ on the insert path (reference:
// db/table_service.cc:795-837). The Python engine's per-row hashlib
// loop measured 1.5 us/row of the 2.4 us/row insert wall; this batch
// implementation (SHA-1 per FIPS 180-1, implemented from the spec)
// takes the whole column in one call and releases the GIL via ctypes.

namespace {

struct Sha1Ctx {
  uint32_t h[5];
  uint64_t len;
  uint8_t block[64];
  size_t fill;
};

static inline uint32_t rol32(uint32_t v, int s) {
  return (v << s) | (v >> (32 - s));
}

static void sha1_init(Sha1Ctx* c) {
  c->h[0] = 0x67452301u;
  c->h[1] = 0xEFCDAB89u;
  c->h[2] = 0x98BADCFEu;
  c->h[3] = 0x10325476u;
  c->h[4] = 0xC3D2E1F0u;
  c->len = 0;
  c->fill = 0;
}

static void sha1_block(Sha1Ctx* c, const uint8_t* p) {
  uint32_t w[80];
  for (int i = 0; i < 16; ++i) {
    w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
           (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
  }
  for (int i = 16; i < 80; ++i) {
    w[i] = rol32(w[i - 3] ^ w[i - 8] ^ w[i - 14] ^ w[i - 16], 1);
  }
  uint32_t a = c->h[0], b = c->h[1], d = c->h[2], e = c->h[3], f = c->h[4];
  for (int i = 0; i < 80; ++i) {
    uint32_t k, g;
    if (i < 20) {
      g = (b & d) | ((~b) & e);
      k = 0x5A827999u;
    } else if (i < 40) {
      g = b ^ d ^ e;
      k = 0x6ED9EBA1u;
    } else if (i < 60) {
      g = (b & d) | (b & e) | (d & e);
      k = 0x8F1BBCDCu;
    } else {
      g = b ^ d ^ e;
      k = 0xCA62C1D6u;
    }
    uint32_t t = rol32(a, 5) + g + f + k + w[i];
    f = e;
    e = d;
    d = rol32(b, 30);
    b = a;
    a = t;
  }
  c->h[0] += a;
  c->h[1] += b;
  c->h[2] += d;
  c->h[3] += e;
  c->h[4] += f;
}

static void sha1_update(Sha1Ctx* c, const uint8_t* data, size_t n) {
  c->len += n;
  if (c->fill) {
    while (n && c->fill < 64) {
      c->block[c->fill++] = *data++;
      --n;
    }
    if (c->fill == 64) {
      sha1_block(c, c->block);
      c->fill = 0;
    }
  }
  while (n >= 64) {
    sha1_block(c, data);
    data += 64;
    n -= 64;
  }
  while (n) {
    c->block[c->fill++] = *data++;
    --n;
  }
}

static void sha1_final(Sha1Ctx* c, uint8_t* out20) {
  uint64_t bits = c->len * 8;
  uint8_t pad = 0x80;
  sha1_update(c, &pad, 1);
  uint8_t zero = 0;
  while (c->fill != 56) sha1_update(c, &zero, 1);
  uint8_t lenb[8];
  for (int i = 0; i < 8; ++i) lenb[i] = uint8_t(bits >> (56 - 8 * i));
  sha1_update(c, lenb, 8);
  for (int i = 0; i < 5; ++i) {
    out20[4 * i] = uint8_t(c->h[i] >> 24);
    out20[4 * i + 1] = uint8_t(c->h[i] >> 16);
    out20[4 * i + 2] = uint8_t(c->h[i] >> 8);
    out20[4 * i + 3] = uint8_t(c->h[i]);
  }
}

static inline void sha1_one(const uint8_t* data, size_t n, uint8_t* out20) {
  Sha1Ctx c;
  sha1_init(&c);
  sha1_update(&c, data, n);
  sha1_final(&c, out20);
}

}  // namespace

extern "C" {

// SHA1 of n variable-length rows packed in one buffer:
// row i = buf[offsets[i] .. offsets[i+1]); out = 20*n digest bytes.
int evql_sha1_rows(
    const uint8_t* buf,
    const uint64_t* offsets,
    uint64_t n,
    uint8_t* out) {
  for (uint64_t i = 0; i < n; ++i) {
    sha1_one(buf + offsets[i], size_t(offsets[i + 1] - offsets[i]),
             out + 20 * i);
  }
  return 0;
}

// Single unsigned-integer primary key fast path: record id = SHA1 of
// the decimal string of the value ("" when the key is NULL) — exactly
// the wire-string form (shredded_record_list._wire_str).
int evql_record_ids_u64(
    const uint64_t* vals,
    const uint8_t* valid,
    uint64_t n,
    uint8_t* out) {
  char dec[24];
  for (uint64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) {
      sha1_one(nullptr, 0, out + 20 * i);
      continue;
    }
    uint64_t v = vals[i];
    int pos = 24;
    do {
      dec[--pos] = char('0' + (v % 10));
      v /= 10;
    } while (v);
    sha1_one(reinterpret_cast<const uint8_t*>(dec + pos),
             size_t(24 - pos), out + 20 * i);
  }
  return 0;
}

// Signed variant (INT64 primary keys).
int evql_record_ids_i64(
    const int64_t* vals,
    const uint8_t* valid,
    uint64_t n,
    uint8_t* out) {
  char dec[26];
  for (uint64_t i = 0; i < n; ++i) {
    if (valid && !valid[i]) {
      sha1_one(nullptr, 0, out + 20 * i);
      continue;
    }
    int64_t sv = vals[i];
    uint64_t v = sv < 0 ? uint64_t(-(sv + 1)) + 1 : uint64_t(sv);
    int pos = 26;
    do {
      dec[--pos] = char('0' + (v % 10));
      v /= 10;
    } while (v);
    if (sv < 0) dec[--pos] = '-';
    sha1_one(reinterpret_cast<const uint8_t*>(dec + pos),
             size_t(26 - pos), out + 20 * i);
  }
  return 0;
}

}  // extern "C"
