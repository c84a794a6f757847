// Chained KV-block hash kernel: canonical CBOR + SHA-256, C ABI for ctypes.
//
// Native equivalent of the pure-Python path in
// kvcache/kvblock/token_processor.py (the parity oracle). Semantics mirror
// the reference's hot per-request hash core
// (pkg/kvcache/kvblock/token_processor.go:105-133): per block,
//   h = low 8 bytes (big-endian) of SHA-256(canonical-CBOR([parent, chunk, null]))
// chained from the seed-derived root. The CBOR subset needed is tiny
// (unsigned ints, arrays, null, text string for the seed), encoded
// shortest-form per RFC 8949 s4.2.1.
//
// Build: python -m llm_d_kv_cache_manager_tpu.native.build  (or `make native`).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4), self-contained.
// ---------------------------------------------------------------------------
struct Sha256 {
  uint32_t state[8];
  uint8_t buf[64];
  size_t buflen = 0;

  Sha256() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    std::memcpy(state, init, sizeof(init));
  }

  static uint32_t rotr(uint32_t x, uint32_t n) { return (x >> n) | (x << (32 - n)); }

  void transform(const uint8_t* chunk) {
    static const uint32_t k[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
        0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
        0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
        0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
        0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
        0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
        0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
        0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++) {
      w[i] = (uint32_t(chunk[i * 4]) << 24) | (uint32_t(chunk[i * 4 + 1]) << 16) |
             (uint32_t(chunk[i * 4 + 2]) << 8) | uint32_t(chunk[i * 4 + 3]);
    }
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
    uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
    for (int i = 0; i < 64; i++) {
      uint32_t s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = h + s1 + ch + k[i] + w[i];
      uint32_t s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = s0 + maj;
      h = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    state[0] += a; state[1] += b; state[2] += c; state[3] += d;
    state[4] += e; state[5] += f; state[6] += g; state[7] += h;
  }

  void update(const uint8_t* data, size_t len) {
    while (len > 0) {
      size_t take = 64 - buflen;
      if (take > len) take = len;
      std::memcpy(buf + buflen, data, take);
      buflen += take;
      data += take;
      len -= take;
      if (buflen == 64) {
        transform(buf);
        buflen = 0;
      }
    }
  }
};

// One-shot SHA-256.
void sha256(const uint8_t* data, size_t len, uint8_t out[32]) {
  Sha256 s;
  uint64_t bitlen = uint64_t(len) * 8;
  s.update(data, len);
  uint8_t pad = 0x80;
  s.update(&pad, 1);
  uint8_t zero = 0;
  while (s.buflen != 56) s.update(&zero, 1);
  for (int i = 7; i >= 0; i--) {
    uint8_t b = uint8_t(bitlen >> (i * 8));
    s.update(&b, 1);
  }
  for (int i = 0; i < 8; i++) {
    out[i * 4] = uint8_t(s.state[i] >> 24);
    out[i * 4 + 1] = uint8_t(s.state[i] >> 16);
    out[i * 4 + 2] = uint8_t(s.state[i] >> 8);
    out[i * 4 + 3] = uint8_t(s.state[i]);
  }
}

// ---------------------------------------------------------------------------
// Canonical CBOR (shortest-form heads), subset: unsigned int, array, null,
// text string.
// ---------------------------------------------------------------------------
void cbor_head(std::vector<uint8_t>& out, uint8_t major, uint64_t arg) {
  uint8_t mt = uint8_t(major << 5);
  if (arg < 24) {
    out.push_back(mt | uint8_t(arg));
  } else if (arg < 0x100) {
    out.push_back(mt | 24);
    out.push_back(uint8_t(arg));
  } else if (arg < 0x10000) {
    out.push_back(mt | 25);
    out.push_back(uint8_t(arg >> 8));
    out.push_back(uint8_t(arg));
  } else if (arg < 0x100000000ULL) {
    out.push_back(mt | 26);
    for (int i = 3; i >= 0; i--) out.push_back(uint8_t(arg >> (i * 8)));
  } else {
    out.push_back(mt | 27);
    for (int i = 7; i >= 0; i--) out.push_back(uint8_t(arg >> (i * 8)));
  }
}

uint64_t low64_be(const uint8_t digest[32]) {
  uint64_t v = 0;
  for (int i = 24; i < 32; i++) v = (v << 8) | digest[i];
  return v;
}

// Hash one block: CBOR [parent, [tokens...], null] -> sha256 -> low 8B BE.
uint64_t hash_one(uint64_t parent, const uint32_t* tokens, size_t n,
                  std::vector<uint8_t>& scratch) {
  scratch.clear();
  cbor_head(scratch, 4, 3);       // array(3)
  cbor_head(scratch, 0, parent);  // parent uint
  cbor_head(scratch, 4, n);       // array(n)
  for (size_t i = 0; i < n; i++) cbor_head(scratch, 0, tokens[i]);
  scratch.push_back(0xF6);        // null
  uint8_t digest[32];
  sha256(scratch.data(), scratch.size(), digest);
  return low64_be(digest);
}

}  // namespace

extern "C" {

// Root parent hash: sha256(CBOR(text-string seed)), low 8 bytes big-endian.
uint64_t hashcore_root_hash(const uint8_t* seed, size_t len) {
  std::vector<uint8_t> buf;
  cbor_head(buf, 3, len);  // text string head
  buf.insert(buf.end(), seed, seed + len);
  uint8_t digest[32];
  sha256(buf.data(), buf.size(), digest);
  return low64_be(digest);
}

// Chained block hashes over complete blocks of `block_size` tokens.
// Writes up to n/block_size hashes to `out`; *out_n receives the count.
void hashcore_chain(uint64_t parent, const uint32_t* tokens, size_t n,
                    size_t block_size, uint64_t* out, size_t* out_n) {
  if (block_size == 0) {
    *out_n = 0;
    return;
  }
  size_t n_blocks = n / block_size;
  std::vector<uint8_t> scratch;
  scratch.reserve(block_size * 5 + 16);
  uint64_t prefix = parent;
  for (size_t b = 0; b < n_blocks; b++) {
    prefix = hash_one(prefix, tokens + b * block_size, block_size, scratch);
    out[b] = prefix;
  }
  *out_n = n_blocks;
}

}  // extern "C"
