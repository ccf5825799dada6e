// 12-relation spatial graph over bounding-box pairs (native path).
//
// C++ mirror of ops/spatial_graph.py:build_spatial_graph_numpy, which is
// itself the vectorized, bit-equal reimplementation of the reference's
// scalar double loop (reference sam/spatial_utils.py:92-218). The numpy
// version always pays for ~20 dense (N, N) temporaries per sample, while
// this pass short-circuits padded (all-zero) rows, which most rows are at
// real obj/OCR occupancy.
//
// BIT-EQUALITY CONTRACT (tests/test_torch_native.py): all arithmetic is
// IEEE double exactly as numpy evaluates it, and the angle path uses the
// same libm asin/acos calls numpy's ufuncs resolve to, so outputs are
// byte-identical to the numpy implementation (and transitively to the
// reference oracle).
//
// Relation classes: 0 none/padded | 1 i-covers-j | 2 j-covers-i |
// 3 IoU>=0.5 | 4..11 directional octants within 0.5*diag | 12 self.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

inline double clip1(double v) {
  // np.clip(v, -1, 1) — NaN propagates (np.clip keeps NaN)
  if (v < -1.0) return -1.0;
  if (v > 1.0) return 1.0;
  return v;
}

// One sample: bbox (n, 4) doubles [xmin, ymin, xmax, ymax], out (n, n) int8.
void spatial_graph_one(const double* bbox, int64_t n, double dist_thr,
                       int8_t* out) {
  const double diag_cut = dist_thr * std::sqrt(2.0);  // normalized 1x1 image
  for (int64_t i = 0; i < n; ++i) {
    const double* bi = bbox + 4 * i;
    const bool valid_i = (((bi[0] + bi[1]) + bi[2]) + bi[3]) != 0.0;
    const double ai = (bi[2] - bi[0]) * (bi[3] - bi[1]);
    const double cxi = 0.5 * (bi[0] + bi[2]);
    const double cyi = 0.5 * (bi[1] + bi[3]);
    int8_t* row = out + n * i;
    for (int64_t j = 0; j < n; ++j) {
      if (i == j) {
        row[j] = valid_i ? int8_t{12} : int8_t{0};
        continue;
      }
      const double* bj = bbox + 4 * j;
      if (!valid_i || (((bj[0] + bj[1]) + bj[2]) + bj[3]) == 0.0) {
        row[j] = 0;
        continue;
      }
      // class 1/2: strict containment (reference :143-159)
      if (bi[0] < bj[0] && bi[2] > bj[2] && bi[1] < bj[1] && bi[3] > bj[3]) {
        row[j] = 1;
        continue;
      }
      if (bj[0] < bi[0] && bj[2] > bi[2] && bj[1] < bi[1] && bj[3] > bi[3]) {
        row[j] = 2;
        continue;
      }
      // class 3: IoU >= 0.5 (reference :161-166)
      const double ix = bi[0] > bj[0] ? bi[0] : bj[0];
      const double iy = bi[1] > bj[1] ? bi[1] : bj[1];
      const double ix2 = bi[2] < bj[2] ? bi[2] : bj[2];
      const double iy2 = bi[3] < bj[3] ? bi[3] : bj[3];
      const double iw = ix2 - ix > 0.0 ? ix2 - ix : 0.0;
      const double ih = iy2 - iy > 0.0 ? iy2 - iy : 0.0;
      const double inter = iw * ih;
      const double aj = (bj[2] - bj[0]) * (bj[3] - bj[1]);
      const double uni = ai + aj - inter;
      const double iou = uni != 0.0 ? inter / uni : 0.0;
      if (iou >= 0.5) {
        row[j] = 3;
        continue;
      }
      // classes 4..11: directional octants (reference :168-203); the
      // angle is of the vector from j's center to i's center
      const double ydiff = cyi - (0.5 * (bj[1] + bj[3]));
      const double xdiff = cxi - (0.5 * (bj[0] + bj[2]));
      const double dist = std::sqrt(ydiff * ydiff + xdiff * xdiff);
      if (!(dist < diag_cut)) {
        row[j] = 0;
        continue;
      }
      if (dist == 0.0) {
        // coincident centers: numpy's 0/0 -> NaN angle -> class 4
        row[j] = 4;
        continue;
      }
      const double s = ydiff / dist;
      const double c = xdiff / dist;
      double label;
      if (s >= 0.0 && c >= 0.0) {
        label = std::asin(clip1(s));
      } else if (s < 0.0 && c >= 0.0) {
        label = std::asin(clip1(s)) + 2.0 * kPi;
      } else if (s >= 0.0 && c < 0.0) {
        label = std::acos(clip1(c));
      } else {
        label = 2.0 * kPi - std::acos(clip1(c));
      }
      const double octant = std::ceil(label / (kPi / 4.0));
      row[j] = static_cast<int8_t>(octant + 3.0);
    }
  }
}

}  // namespace

extern "C" {

// bbox: (b, n, 4) contiguous doubles; out: (b, n, n) int8.
// Samples are independent, so the batch fans out over hardware threads
// (bit-equality is per-sample and unaffected by the split). Threading
// engages only when there is enough work to amortize thread start-up:
// offline preprocessing ships thousands of samples per call, while the
// serving featurizer's single-sample calls stay on the caller's thread.
// threads: 0 = auto (hardware concurrency, capped at b/4).
void sam_spatial_graph(const double* bbox, int64_t b, int64_t n,
                       double dist_thr, int8_t* out, int64_t threads) {
  const int64_t hw = threads > 0
      ? threads
      : static_cast<int64_t>(std::thread::hardware_concurrency());
  const int64_t workers = std::max<int64_t>(1, std::min(hw, b / 4));
  if (workers <= 1) {
    for (int64_t s = 0; s < b; ++s) {
      spatial_graph_one(bbox + s * n * 4, n, dist_thr, out + s * n * n);
    }
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(static_cast<size_t>(workers));
  for (int64_t w = 0; w < workers; ++w) {
    pool.emplace_back([=] {
      for (int64_t s = w; s < b; s += workers) {
        spatial_graph_one(bbox + s * n * 4, n, dist_thr, out + s * n * n);
      }
    });
  }
  for (auto& t : pool) t.join();
}

}  // extern "C"
