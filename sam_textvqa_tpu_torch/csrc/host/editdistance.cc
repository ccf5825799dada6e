// Levenshtein edit distance, C++ / ctypes ABI.
//
// The reference's ANLS metric depends on the `editdistance` C++ pip package
// (reference sam/datasets/metrics.py:360-364). This provides the same
// native-speed primitive without the pip dependency; the Python version in
// evaluation/metrics.py is its plain twin.
//
//   int sam_edit_distance(const char* a, int len_a, const char* b, int len_b);
//
// Operates on UTF-32 code points passed as int arrays for correct unicode
// behavior:
//   int sam_edit_distance_u32(const unsigned* a, int len_a,
//                             const unsigned* b, int len_b);

#include <algorithm>
#include <cstring>
#include <vector>

namespace {

template <typename Char>
int levenshtein(const Char* a, int la, const Char* b, int lb) {
  if (la < lb) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  if (lb == 0) return la;
  std::vector<int> prev(lb + 1), cur(lb + 1);
  for (int j = 0; j <= lb; ++j) prev[j] = j;
  for (int i = 0; i < la; ++i) {
    cur[0] = i + 1;
    for (int j = 0; j < lb; ++j) {
      cur[j + 1] = std::min({prev[j + 1] + 1, cur[j] + 1,
                             prev[j] + (a[i] != b[j] ? 1 : 0)});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

}  // namespace

extern "C" int sam_edit_distance(const char* a, int la, const char* b,
                                 int lb) {
  return levenshtein(a, la, b, lb);
}

extern "C" int sam_edit_distance_u32(const unsigned* a, int la,
                                     const unsigned* b, int lb) {
  return levenshtein(a, la, b, lb);
}
