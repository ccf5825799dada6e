// PHOC (Pyramidal Histogram of Characters) featurizer, C++ / ctypes ABI.
//
// Produces the same 604-dim descriptor as the reference C extension
// (reference: sam/phoc/cphoc.c:10-112): unigram pyramid levels 2..5 over 36
// characters (14 regions * 36 = 504 dims) followed by a level-2 bigram
// histogram over 50 common bigrams (2 * 50 = 100 dims).
//
// Exposed as a plain C function so Python can bind it with ctypes (pybind11
// is not available in this environment):
//   int sam_build_phoc(const char* word, float* out /* 604 floats */);
// Returns 0 on success, -1 if the word contains a character outside [a-z0-9].
//
// Build: ops/host_build.py (g++ -O2 -shared -fPIC).

#include <cstring>

namespace {

constexpr int kNumUnigrams = 36;
constexpr int kNumBigrams = 50;
constexpr int kPhocDim = 604;
constexpr int kBigramOffset = kNumUnigrams * 14;  // 14 unigram regions

const char kUnigrams[kNumUnigrams + 1] = "abcdefghijklmnopqrstuvwxyz0123456789";

const char* const kBigrams[kNumBigrams] = {
    "th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
    "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
    "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
    "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
    "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el"};

inline int unigram_index(char c) {
  const char* p = std::strchr(kUnigrams, c);
  return (p != nullptr && c != '\0') ? static_cast<int>(p - kUnigrams) : -1;
}

inline int bigram_index(const char* s) {
  for (int k = 0; k < kNumBigrams; ++k) {
    if (s[0] == kBigrams[k][0] && s[1] == kBigrams[k][1]) return k;
  }
  return -1;
}

// Fraction of the character's occupancy interval covered by the region,
// computed in float to match the reference extension's arithmetic
// (cphoc.c:55-60 does the same comparison in 32-bit float).
inline bool occupies(float occ0, float occ1, int region, int level) {
  float region0 = static_cast<float>(region) / level;
  float region1 = static_cast<float>(region + 1) / level;
  float lo = occ0 > region0 ? occ0 : region0;
  float hi = occ1 < region1 ? occ1 : region1;
  return (hi - lo) / (occ1 - occ0) >= 0.5f;
}

}  // namespace

extern "C" int sam_build_phoc(const char* word, float* out) {
  for (int i = 0; i < kPhocDim; ++i) out[i] = 0.0f;
  const int n = static_cast<int>(std::strlen(word));
  if (n == 0) return 0;

  for (int index = 0; index < n; ++index) {
    const int char_index = unigram_index(word[index]);
    if (char_index < 0) return -1;
    const float occ0 = static_cast<float>(index) / n;
    const float occ1 = static_cast<float>(index + 1) / n;
    int level_base = 0;  // cumulative regions of completed levels, in dims
    for (int level = 2; level < 6; ++level) {
      for (int region = 0; region < level; ++region) {
        if (occupies(occ0, occ1, region, level)) {
          out[(level_base + region) * kNumUnigrams + char_index] = 1.0f;
        }
      }
      level_base += level;
    }
  }

  for (int i = 0; i + 1 < n; ++i) {
    const int ngram_index = bigram_index(word + i);
    if (ngram_index < 0) continue;
    const float occ0 = static_cast<float>(i) / n;
    const float occ1 = static_cast<float>(i + 2) / n;
    for (int region = 0; region < 2; ++region) {
      if (occupies(occ0, occ1, region, 2)) {
        out[kBigramOffset + region * kNumBigrams + ngram_index] = 1.0f;
      }
    }
  }
  return 0;
}

// Batched entry point: words are NUL-separated in one buffer; out has
// num_words * 604 floats. Lets the host pipeline featurize a whole OCR
// token column in one FFI crossing.
extern "C" int sam_build_phoc_batch(const char* words, int num_words,
                                    float* out) {
  const char* p = words;
  for (int w = 0; w < num_words; ++w) {
    if (sam_build_phoc(p, out + w * kPhocDim) != 0) return -(w + 1);
    p += std::strlen(p) + 1;
  }
  return 0;
}
