// gandiva_tpu_torch native host runtime: the pieces of the engine that run
// on the host, per batch or per distinct dictionary value, and are
// throughput sensitive (the device path is torch's and the CUDA kernels'):
//
//  - MemoryPool: aligned allocations with live/peak accounting (the
//    arrow::MemoryPool analogue the reference takes on every Evaluate call,
//    libgandiva.pxd:219).
//  - Validity bitmap codec: Arrow packed bitmaps <-> the engine's byte masks
//    (one bool per row, batch.py).
//  - SQL LIKE matcher: %/_/escape wildcards evaluated per *distinct*
//    dictionary value (the LikeHolder analogue, like_holder.cc/regex — here a
//    direct backtracking matcher instead of RE2, byte-oriented, no regex
//    compilation).
//  - FNV-1a-64 byte hashing for string dictionaries (bit-identical to
//    registry/string_ops.py::hash_bytes_np).
//
// Exposed as a C ABI for ctypes. Built by native/__init__.py:
// g++ -O3 -std=c++17 -shared -fPIC.

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// memory pool
// ---------------------------------------------------------------------------

struct GtPool {
  std::atomic<int64_t> bytes_allocated{0};
  std::atomic<int64_t> peak_bytes{0};
  std::atomic<int64_t> num_allocs{0};
};

GtPool* gt_pool_create() { return new GtPool(); }

void gt_pool_destroy(GtPool* pool) { delete pool; }

void* gt_pool_alloc(GtPool* pool, int64_t size, int64_t alignment) {
  if (size <= 0) size = 1;
  if (alignment < 64) alignment = 64;  // cache-line default
  int64_t padded = (size + alignment - 1) / alignment * alignment;
  void* p = std::aligned_alloc(static_cast<size_t>(alignment),
                               static_cast<size_t>(padded));
  if (p == nullptr) return nullptr;
  int64_t cur = pool->bytes_allocated.fetch_add(padded) + padded;
  int64_t peak = pool->peak_bytes.load();
  while (cur > peak && !pool->peak_bytes.compare_exchange_weak(peak, cur)) {
  }
  pool->num_allocs.fetch_add(1);
  return p;
}

void gt_pool_free(GtPool* pool, void* p, int64_t size, int64_t alignment) {
  if (p == nullptr) return;
  if (alignment < 64) alignment = 64;
  int64_t padded = (size + alignment - 1) / alignment * alignment;
  pool->bytes_allocated.fetch_sub(padded);
  std::free(p);
}

int64_t gt_pool_bytes_allocated(GtPool* pool) {
  return pool->bytes_allocated.load();
}
int64_t gt_pool_peak_bytes(GtPool* pool) { return pool->peak_bytes.load(); }
int64_t gt_pool_num_allocs(GtPool* pool) { return pool->num_allocs.load(); }

// ---------------------------------------------------------------------------
// validity bitmap codec (Arrow LSB-first packed bits)
// ---------------------------------------------------------------------------

void gt_unpack_bitmap(const uint8_t* bits, int64_t bit_offset, int64_t n,
                      uint8_t* out) {
  if (bits == nullptr) {  // absent bitmap = all valid
    std::memset(out, 1, static_cast<size_t>(n));
    return;
  }
  int64_t i = 0;
  // align to byte boundary
  while (i < n && ((bit_offset + i) & 7) != 0) {
    int64_t b = bit_offset + i;
    out[i] = (bits[b >> 3] >> (b & 7)) & 1;
    ++i;
  }
  // full bytes: unroll 8 lanes per byte
  const uint8_t* base = bits + ((bit_offset + i) >> 3);
  int64_t full = (n - i) >> 3;
  for (int64_t j = 0; j < full; ++j) {
    uint8_t byte = base[j];
    uint8_t* o = out + i + (j << 3);
    o[0] = byte & 1;
    o[1] = (byte >> 1) & 1;
    o[2] = (byte >> 2) & 1;
    o[3] = (byte >> 3) & 1;
    o[4] = (byte >> 4) & 1;
    o[5] = (byte >> 5) & 1;
    o[6] = (byte >> 6) & 1;
    o[7] = (byte >> 7) & 1;
  }
  i += full << 3;
  for (; i < n; ++i) {
    int64_t b = bit_offset + i;
    out[i] = (bits[b >> 3] >> (b & 7)) & 1;
  }
}

void gt_pack_bitmap(const uint8_t* bools, int64_t n, uint8_t* out) {
  int64_t full = n >> 3;
  for (int64_t j = 0; j < full; ++j) {
    const uint8_t* b = bools + (j << 3);
    out[j] = static_cast<uint8_t>(b[0] | (b[1] << 1) | (b[2] << 2) |
                                  (b[3] << 3) | (b[4] << 4) | (b[5] << 5) |
                                  (b[6] << 6) | (b[7] << 7));
  }
  if (n & 7) {
    uint8_t last = 0;
    for (int64_t k = 0; k < (n & 7); ++k) {
      last |= static_cast<uint8_t>(bools[(full << 3) + k] << k);
    }
    out[full] = last;
  }
}

// ---------------------------------------------------------------------------
// SQL LIKE matcher (direct backtracking over bytes; % = any run, _ = one
// code point approximated as one byte for ASCII — multibyte-safe because %
// backtracking is byte-oriented and _ counts UTF-8 lead bytes)
// ---------------------------------------------------------------------------

static bool utf8_is_cont(uint8_t c) { return (c & 0xC0) == 0x80; }

static bool like_match(const uint8_t* s, int64_t slen, const uint8_t* p,
                       int64_t plen, uint8_t esc, bool has_esc) {
  int64_t si = 0, pi = 0;
  int64_t star_si = -1, star_pi = -1;
  while (si < slen) {
    if (pi < plen) {
      uint8_t pc = p[pi];
      bool literal = false;
      if (has_esc && pc == esc && pi + 1 < plen) {
        pc = p[pi + 1];
        literal = true;
      }
      if (!literal && pc == '%') {
        star_pi = pi++;
        star_si = si;
        continue;
      }
      if (!literal && pc == '_') {
        // consume one UTF-8 code point
        ++si;
        while (si < slen && utf8_is_cont(s[si])) ++si;
        ++pi;
        continue;
      }
      if (s[si] == pc) {
        ++si;
        pi += literal ? 2 : 1;
        continue;
      }
    }
    if (star_pi >= 0) {
      pi = star_pi + 1;
      si = ++star_si;
      continue;
    }
    return false;
  }
  while (pi < plen) {
    uint8_t pc = p[pi];
    if (has_esc && pc == esc && pi + 1 < plen) return false;  // literal left
    if (pc != '%') return false;
    ++pi;
  }
  return true;
}

// values: concatenated utf-8 bytes; offsets: n+1 int32 (arrow layout)
void gt_like_match_many(const uint8_t* values, const int32_t* offsets,
                        int64_t n, const uint8_t* pattern, int64_t plen,
                        uint8_t escape, int32_t has_escape, uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* s = values + offsets[i];
    int64_t slen = offsets[i + 1] - offsets[i];
    out[i] = like_match(s, slen, pattern, plen, escape, has_escape != 0);
  }
}

// case-insensitive (ASCII fold) variant for ILIKE
static inline uint8_t fold(uint8_t c) {
  return (c >= 'A' && c <= 'Z') ? static_cast<uint8_t>(c + 32) : c;
}

static bool ilike_match(const uint8_t* s, int64_t slen, const uint8_t* p,
                        int64_t plen) {
  int64_t si = 0, pi = 0, star_si = -1, star_pi = -1;
  while (si < slen) {
    if (pi < plen) {
      uint8_t pc = p[pi];
      if (pc == '%') {
        star_pi = pi++;
        star_si = si;
        continue;
      }
      if (pc == '_') {
        ++si;
        while (si < slen && utf8_is_cont(s[si])) ++si;
        ++pi;
        continue;
      }
      if (fold(s[si]) == fold(pc)) {
        ++si;
        ++pi;
        continue;
      }
    }
    if (star_pi >= 0) {
      pi = star_pi + 1;
      si = ++star_si;
      continue;
    }
    return false;
  }
  while (pi < plen && p[pi] == '%') ++pi;
  return pi == plen;
}

void gt_ilike_match_many(const uint8_t* values, const int32_t* offsets,
                         int64_t n, const uint8_t* pattern, int64_t plen,
                         uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    out[i] = ilike_match(values + offsets[i], offsets[i + 1] - offsets[i],
                         pattern, plen);
  }
}

// ---------------------------------------------------------------------------
// FNV-1a 64-bit over byte slices (bit-identical to string_ops.hash_bytes_np)
// ---------------------------------------------------------------------------

void gt_hash_bytes_many(const uint8_t* values, const int32_t* offsets,
                        int64_t n, uint64_t seed, uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = 0xCBF29CE484222325ULL ^ seed;
    const uint8_t* s = values + offsets[i];
    int64_t len = offsets[i + 1] - offsets[i];
    for (int64_t j = 0; j < len; ++j) {
      h = (h ^ s[j]) * 0x100000001B3ULL;
    }
    out[i] = h;
  }
}

}  // extern "C"
