// Host ops of the port: rotated-box geometry, IoU matrices, greedy NMS and
// point-in-rotated-box tests, multithreaded on the CPU. The same C++ as the
// JAX package's native library, kept here so that the port builds and loads
// it on its own (``minddet_tpu_torch/ops/host_ops.py`` compiles it with the
// host compiler at first use); the GT-database sampler and the per-object
// noise accept or reject candidates on these exact areas.
//
// C ABI only (loaded via ctypes). Box layout: [x, y, w, l, yaw].

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

inline double cross(const Pt& o, const Pt& a, const Pt& b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// corners of [x, y, w, l, yaw], CCW
inline void corners(const float* b, Pt out[4]) {
  const double c = std::cos((double)b[4]);
  const double s = std::sin((double)b[4]);
  const double hw = 0.5 * b[2];
  const double hl = 0.5 * b[3];
  const double dx[4] = {hw, -hw, -hw, hw};
  const double dy[4] = {hl, hl, -hl, -hl};
  for (int i = 0; i < 4; ++i) {
    out[i].x = c * dx[i] - s * dy[i] + b[0];
    out[i].y = s * dx[i] + c * dy[i] + b[1];
  }
}

// Sutherland-Hodgman clip of convex polygon `poly` against half-plane left of
// edge a->b. Writes result to `out`, returns vertex count.
int clip_edge(const Pt* poly, int n, Pt a, Pt b, Pt* out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    const Pt& cur = poly[i];
    const Pt& nxt = poly[(i + 1) % n];
    const double dc = cross(a, b, cur);
    const double dn = cross(a, b, nxt);
    if (dc >= 0) out[m++] = cur;
    if ((dc >= 0) != (dn >= 0)) {
      const double t = dc / (dc - dn);
      out[m].x = cur.x + t * (nxt.x - cur.x);
      out[m].y = cur.y + t * (nxt.y - cur.y);
      ++m;
    }
  }
  return m;
}

double rotated_intersection(const float* ba, const float* bb) {
  Pt pa[4], pb[4];
  corners(ba, pa);
  corners(bb, pb);
  Pt buf1[16], buf2[16];
  std::memcpy(buf1, pa, sizeof(pa));
  int n = 4;
  Pt* src = buf1;
  Pt* dst = buf2;
  for (int e = 0; e < 4 && n > 2; ++e) {
    n = clip_edge(src, n, pb[e], pb[(e + 1) % 4], dst);
    std::swap(src, dst);
  }
  if (n < 3) return 0.0;
  double area = 0.0;
  for (int i = 0; i < n; ++i) {
    const Pt& p = src[i];
    const Pt& q = src[(i + 1) % n];
    area += p.x * q.y - q.x * p.y;
  }
  return std::abs(area) * 0.5;
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  const unsigned hw = std::max(1u, std::thread::hardware_concurrency());
  const int64_t chunk = (n + hw - 1) / hw;
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < hw; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back(fn, lo, hi);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Pairwise rotated IoU: boxes1 (n, 5), boxes2 (m, 5) -> out (n, m).
// criterion: -1 union, 0 over area1, 1 over area2 (KITTI eval semantics).
void rotated_iou_matrix(const float* boxes1, int64_t n, const float* boxes2,
                        int64_t m, int criterion, float* out) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* a = boxes1 + i * 5;
      const double area_a = (double)a[2] * a[3];
      for (int64_t j = 0; j < m; ++j) {
        const float* b = boxes2 + j * 5;
        const double inter = rotated_intersection(a, b);
        const double area_b = (double)b[2] * b[3];
        double denom;
        if (criterion == 0) denom = area_a;
        else if (criterion == 1) denom = area_b;
        else denom = area_a + area_b - inter;
        out[i * m + j] = (float)(denom > 1e-8 ? inter / denom : 0.0);
      }
    }
  });
}

// Greedy rotated NMS. boxes (n, 5) with scores (n,) ALREADY sorted descending.
// Writes kept indices (into the sorted order); returns keep count.
int64_t rotated_nms(const float* boxes, const float* scores, int64_t n,
                    float iou_threshold, float score_threshold,
                    int64_t max_out, int64_t* keep) {
  std::vector<uint8_t> suppressed(n, 0);
  int64_t kept = 0;
  for (int64_t i = 0; i < n && kept < max_out; ++i) {
    if (suppressed[i] || scores[i] <= score_threshold) continue;
    keep[kept++] = i;
    const float* a = boxes + i * 5;
    const double area_a = (double)a[2] * a[3];
    for (int64_t j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const float* b = boxes + j * 5;
      const double inter = rotated_intersection(a, b);
      const double denom = area_a + (double)b[2] * b[3] - inter;
      if (denom > 1e-8 && inter / denom > iou_threshold) suppressed[j] = 1;
    }
  }
  return kept;
}

// Axis-aligned greedy NMS, same contract; boxes (n, 4) xyxy sorted by score.
int64_t nms_2d(const float* boxes, const float* scores, int64_t n,
               float iou_threshold, float score_threshold, int64_t max_out,
               int64_t* keep) {
  std::vector<uint8_t> suppressed(n, 0);
  int64_t kept = 0;
  for (int64_t i = 0; i < n && kept < max_out; ++i) {
    if (suppressed[i] || scores[i] <= score_threshold) continue;
    keep[kept++] = i;
    const float* a = boxes + i * 4;
    const double aa = std::max(0.f, a[2] - a[0]) * std::max(0.f, a[3] - a[1]);
    for (int64_t j = i + 1; j < n; ++j) {
      if (suppressed[j]) continue;
      const float* b = boxes + j * 4;
      const double x1 = std::max(a[0], b[0]);
      const double y1 = std::max(a[1], b[1]);
      const double x2 = std::min(a[2], b[2]);
      const double y2 = std::min(a[3], b[3]);
      const double inter =
          std::max(0.0, x2 - x1) * std::max(0.0, y2 - y1);
      const double ab = std::max(0.f, b[2] - b[0]) * std::max(0.f, b[3] - b[1]);
      const double denom = aa + ab - inter;
      if (denom > 1e-8 && inter / denom > iou_threshold) suppressed[j] = 1;
    }
  }
  return kept;
}

// Points-in-rotated-boxes: points (n, 2), boxes (m, 5) -> mask (n, m) uint8.
// Used by the GT-AUG database sampler's collision tests.
void points_in_rboxes(const float* points, int64_t n, const float* boxes,
                      int64_t m, uint8_t* out) {
  std::vector<Pt> cs(m * 4);
  for (int64_t j = 0; j < m; ++j) corners(boxes + j * 5, &cs[j * 4]);
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      Pt p{points[i * 2], points[i * 2 + 1]};
      for (int64_t j = 0; j < m; ++j) {
        const Pt* c = &cs[j * 4];
        bool inside = true;
        for (int e = 0; e < 4 && inside; ++e)
          inside = cross(c[e], c[(e + 1) % 4], p) >= 0;
        out[i * m + j] = inside ? 1 : 0;
      }
    }
  });
}

int host_ops_version() { return 1; }

}  // extern "C"
