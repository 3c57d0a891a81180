// Native ASCII path of the deterministic hash tokenizer — host core.
//
// A copy of the JAX package's native tokenizer (csrc/hash_tokenizer.cpp)
// with two repairs, so that it gives exactly the ids of the Python
// HashTokenizer (leann_torch/embeddings/tokenizer.py), which defines them:
//   * a word of any length is hashed whole (the JAX package's copy cuts a
//     word at 2,048 bytes and hashes the rest as another word);
//   * \x1c-\x1f separate words, as Python's \s does (the JAX package's copy
//     makes each of them a symbol token).
// Words are [a-z0-9]+(?:'[a-z]+)? runs (after lowercasing) or single
// non-alnum non-space symbols; token id = 4 + blake2b_64(word) % (vocab - 4).
// NFKC is the identity on ASCII, so only ASCII texts come here.
//
// C ABI for ctypes; no dependencies beyond the C++ standard library. Built
// with the host compiler by leann_torch/ops/cuda_build.py.

#include <cstdint>
#include <cstring>
#include <string>

namespace {

// ---- blake2b (RFC 7693), sequential, no key --------------------------------

constexpr uint64_t kIV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

constexpr uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

struct Blake2bState {
  uint64_t h[8];
  uint64_t t = 0;
};

void compress(Blake2bState* S, const uint8_t* block, uint64_t t, bool last) {
  uint64_t m[16];
  memcpy(m, block, 128);
  uint64_t v[16];
  memcpy(v, S->h, 64);
  memcpy(v + 8, kIV, 64);
  v[12] ^= t;
  // t_hi = 0 (messages < 2^64)
  if (last) v[14] = ~v[14];
  auto G = [&](int r, int i, uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d) {
    a = a + b + m[kSigma[r][2 * i]];
    d = rotr64(d ^ a, 32);
    c = c + d;
    b = rotr64(b ^ c, 24);
    a = a + b + m[kSigma[r][2 * i + 1]];
    d = rotr64(d ^ a, 16);
    c = c + d;
    b = rotr64(b ^ c, 63);
  };
  for (int r = 0; r < 12; ++r) {
    G(r, 0, v[0], v[4], v[8], v[12]);
    G(r, 1, v[1], v[5], v[9], v[13]);
    G(r, 2, v[2], v[6], v[10], v[14]);
    G(r, 3, v[3], v[7], v[11], v[15]);
    G(r, 4, v[0], v[5], v[10], v[15]);
    G(r, 5, v[1], v[6], v[11], v[12]);
    G(r, 6, v[2], v[7], v[8], v[13]);
    G(r, 7, v[3], v[4], v[9], v[14]);
  }
  for (int i = 0; i < 8; ++i) S->h[i] ^= v[i] ^ v[i + 8];
}

// blake2b with digest_size=8 -> first 8 output bytes as LE u64 (matches
// python hashlib.blake2b(s, digest_size=8) + int.from_bytes(..., "little"))
uint64_t blake2b64(const uint8_t* data, size_t len) {
  Blake2bState S;
  memcpy(S.h, kIV, 64);
  S.h[0] ^= 0x01010000ULL ^ 8ULL;  // param block: digest_len=8, fanout=1, depth=1
  uint8_t block[128];
  size_t off = 0;
  uint64_t t = 0;
  while (len - off > 128) {
    t += 128;
    compress(&S, data + off, t, false);
    off += 128;
  }
  size_t rem = len - off;
  memset(block, 0, 128);
  memcpy(block, data + off, rem);
  t += rem;
  compress(&S, block, t, true);
  return S.h[0];  // first 8 bytes little-endian == h[0] on LE hosts
}

constexpr int kPad = 0, kCls = 1, kSep = 2, kReserved = 4;

inline bool is_alnum(uint8_t c) { return (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9'); }

inline uint8_t lower(uint8_t c) { return (c >= 'A' && c <= 'Z') ? c + 32 : c; }

// Python's str.isspace() on ASCII: \t \n \v \f \r, the space, and \x1c-\x1f
inline bool is_space(uint8_t c) { return c == ' ' || (c >= 9 && c <= 13) || (c >= 0x1c && c <= 0x1f); }

inline int32_t word_id(const std::string& w, int32_t vocab) {
  return kReserved + static_cast<int32_t>(
      blake2b64(reinterpret_cast<const uint8_t*>(w.data()), w.size()) % static_cast<uint64_t>(vocab - kReserved));
}

}  // namespace

extern "C" {

// Tokenize one ASCII text (any case; lowercased here). Returns the number
// of ids written (<= max_len): [CLS, w..., SEP]; the CALLER pads with 0.
// vocab must be > 4.
int32_t tok_encode_ascii(const char* text, int64_t text_len, int32_t max_len,
                         int32_t vocab, int32_t* out_ids) {
  int32_t n = 0;
  out_ids[n++] = kCls;
  std::string word;
  int64_t i = 0;
  const int32_t word_budget = max_len - 2;
  int32_t words = 0;
  while (i < text_len && words < word_budget) {
    uint8_t c = lower(static_cast<uint8_t>(text[i]));
    if (is_alnum(c)) {
      word.clear();
      while (i < text_len && is_alnum(lower(static_cast<uint8_t>(text[i])))) {
        word += static_cast<char>(lower(static_cast<uint8_t>(text[i])));
        ++i;
      }
      // [a-z0-9]+(?:'[a-z]+)? — an apostrophe joins only if a-z follows
      if (i + 1 < text_len && text[i] == '\'') {
        uint8_t e = lower(static_cast<uint8_t>(text[i + 1]));
        if (e >= 'a' && e <= 'z') {
          word += '\'';
          ++i;
          while (i < text_len) {
            uint8_t f = lower(static_cast<uint8_t>(text[i]));
            if (!(f >= 'a' && f <= 'z')) break;
            word += static_cast<char>(f);
            ++i;
          }
        }
      }
      out_ids[n++] = word_id(word, vocab);
      ++words;
    } else if (is_space(c)) {
      ++i;
    } else {
      word.assign(1, static_cast<char>(c));  // a single symbol token
      out_ids[n++] = word_id(word, vocab);
      ++words;
      ++i;
    }
  }
  out_ids[n++] = kSep;
  return n;
}

// Batch over a concatenated buffer. offsets has n_texts+1 entries.
// out_ids is [n_texts, max_len] int32 pre-zeroed; out_lens [n_texts].
void tok_encode_batch_ascii(const char* buf, const int64_t* offsets, int32_t n_texts,
                            int32_t max_len, int32_t vocab, int32_t* out_ids,
                            int32_t* out_lens) {
  for (int32_t i = 0; i < n_texts; ++i) {
    out_lens[i] = tok_encode_ascii(buf + offsets[i], offsets[i + 1] - offsets[i],
                                   max_len, vocab, out_ids + static_cast<int64_t>(i) * max_len);
  }
}

}  // extern "C"
