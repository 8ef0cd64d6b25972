// Host tokenizer and Hash64 of the PyTorch port.
//
// A copy of the tokenizer and Hash64 part of
// dryad_tpu/runtime/native/dryadnative.cpp (the rest of that file, zlib
// transforms and the prefetch channel, is not needed by the port), so
// the port builds without zlib and never loads the JAX package's
// library.  Semantics must stay identical: FNV-1a 64-bit hash, ASCII
// whitespace separators, big-endian 4-byte prefix ranks.
//
// Exposed as a C ABI for ctypes; see runtime/bindings.py.

#include <cstddef>
#include <cstdint>

extern "C" {

// ---------------------------------------------------------------- hash64
static const uint64_t FNV_OFFSET = 0xCBF29CE484222325ULL;
static const uint64_t FNV_PRIME = 0x100000001B3ULL;

uint64_t dn_hash64(const uint8_t* data, size_t len) {
  uint64_t h = FNV_OFFSET;
  for (size_t i = 0; i < len; ++i) {
    h ^= (uint64_t)data[i];
    h *= FNV_PRIME;
  }
  return h;
}

// ------------------------------------------------------------- tokenizer
static inline int is_space(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

// Count whitespace-separated tokens in buf.
size_t dn_token_count(const uint8_t* buf, size_t len) {
  size_t n = 0;
  size_t i = 0;
  while (i < len) {
    while (i < len && is_space(buf[i])) ++i;
    if (i >= len) break;
    ++n;
    while (i < len && !is_space(buf[i])) ++i;
  }
  return n;
}

// Tokenize: fill per-token hash (lo/hi u32 words), 8-byte prefix rank
// words (r0 bytes 0-4, r1 bytes 4-8), and byte offsets/lengths (for
// host-side dictionary construction).
// Returns the number of tokens written (<= max_tokens).
size_t dn_tokenize(const uint8_t* buf, size_t len, size_t max_tokens,
                   uint32_t* h0, uint32_t* h1, uint32_t* r0, uint32_t* r1,
                   uint64_t* starts, uint32_t* lens) {
  size_t n = 0;
  size_t i = 0;
  while (i < len && n < max_tokens) {
    while (i < len && is_space(buf[i])) ++i;
    if (i >= len) break;
    size_t s = i;
    uint64_t h = FNV_OFFSET;
    uint32_t rank0 = 0, rank1 = 0;
    while (i < len && !is_space(buf[i])) {
      uint8_t c = buf[i];
      h ^= (uint64_t)c;
      h *= FNV_PRIME;
      size_t pos = i - s;
      if (pos < 4)
        rank0 |= ((uint32_t)c) << (8 * (3 - pos));
      else if (pos < 8)
        rank1 |= ((uint32_t)c) << (8 * (7 - pos));
      ++i;
    }
    h0[n] = (uint32_t)(h & 0xFFFFFFFFULL);
    h1[n] = (uint32_t)(h >> 32);
    r0[n] = rank0;
    r1[n] = rank1;
    starts[n] = (uint64_t)s;
    lens[n] = (uint32_t)(i - s);
    ++n;
  }
  return n;
}

}  // extern "C"
