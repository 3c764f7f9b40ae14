// Rotated BEV IoU + NMS, native host implementation.
//
// The port's copy of epropnp_tpu/ops/iou3d/src/iou3d.cpp (the same code).
// It serves the host-side evaluation and multi-camera fusion path, where
// the reference uses a CUDA extension (EPro-PnP-Det/epropnp_det/ops/iou3d/
// src/iou3d_kernel.cu) and numba-CUDA kernels; the torch functions of
// epropnp_tpu_torch/core/bbox_3d are its plain references. Exact convex
// polygon clipping (Sutherland-Hodgman) in double precision.
//
// Box layout: [cx, cy, w, h, angle] (radians).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct P2 {
  double x, y;
};

// corners of a rotated rect, counterclockwise
inline void rect_corners(const float* b, P2* c) {
  const double cx = b[0], cy = b[1], hw = 0.5 * b[2], hh = 0.5 * b[3];
  const double ca = std::cos((double)b[4]), sa = std::sin((double)b[4]);
  const double dx[4] = {hw, hw, -hw, -hw};
  const double dy[4] = {hh, -hh, -hh, hh};
  for (int i = 0; i < 4; ++i) {
    c[i].x = cx + dx[i] * ca - dy[i] * sa;
    c[i].y = cy + dx[i] * sa + dy[i] * ca;
  }
}

inline double polygon_area(const P2* p, int n) {
  double a = 0.0;
  for (int i = 0; i < n; ++i) {
    const int j = (i + 1) % n;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  return 0.5 * std::abs(a);
}

inline void ensure_ccw(P2* p) {
  double a = 0.0;
  for (int i = 0; i < 4; ++i) {
    const int j = (i + 1) % 4;
    a += p[i].x * p[j].y - p[j].x * p[i].y;
  }
  if (a < 0.0) std::swap(p[0], p[3]), std::swap(p[1], p[2]);
}

// clip polygon (in, n_in) by the half-plane left of edge a->b
inline int clip_edge(const P2* in, int n_in, P2 a, P2 b, P2* out) {
  int n_out = 0;
  const double ex = b.x - a.x, ey = b.y - a.y;
  for (int i = 0; i < n_in; ++i) {
    const P2 p = in[i];
    const P2 q = in[(i + 1) % n_in];
    const double dp = ex * (p.y - a.y) - ey * (p.x - a.x);
    const double dq = ex * (q.y - a.y) - ey * (q.x - a.x);
    if (dp >= 0.0) out[n_out++] = p;
    if ((dp < 0.0) != (dq < 0.0)) {
      const double t = dp / (dp - dq);
      out[n_out].x = p.x + t * (q.x - p.x);
      out[n_out].y = p.y + t * (q.y - p.y);
      ++n_out;
    }
  }
  return n_out;
}

double rect_intersection(const float* b1, const float* b2) {
  P2 c1[4], c2[4];
  rect_corners(b1, c1);
  rect_corners(b2, c2);
  ensure_ccw(c1);
  ensure_ccw(c2);
  P2 buf_a[16], buf_b[16];
  std::memcpy(buf_a, c1, sizeof(c1));
  int n = 4;
  P2* cur = buf_a;
  P2* nxt = buf_b;
  for (int e = 0; e < 4 && n > 0; ++e) {
    n = clip_edge(cur, n, c2[e], c2[(e + 1) % 4], nxt);
    std::swap(cur, nxt);
  }
  if (n < 3) return 0.0;
  return polygon_area(cur, n);
}

}  // namespace

extern "C" {

// criterion: 0 = IoU (union), 1 = IoF1 (area of box1), 2 = intersection
void rotated_iou_matrix(const float* boxes1, int n1, const float* boxes2,
                        int n2, int criterion, float* out) {
  for (int i = 0; i < n1; ++i) {
    const float* b1 = boxes1 + i * 5;
    const double a1 = (double)b1[2] * b1[3];
    for (int j = 0; j < n2; ++j) {
      const float* b2 = boxes2 + j * 5;
      const double inter = rect_intersection(b1, b2);
      double denom;
      if (criterion == 2) {
        out[i * n2 + j] = (float)inter;
        continue;
      } else if (criterion == 1) {
        denom = a1;
      } else {
        denom = a1 + (double)b2[2] * b2[3] - inter;
      }
      out[i * n2 + j] = (float)(inter / std::max(denom, 1e-8));
    }
  }
}

// Greedy NMS; keep[i] = 1 if box i survives. O(n^2) with early pruning.
void nms_rotated(const float* boxes, const float* scores, int n,
                 float thresh, uint8_t* keep) {
  // argsort by score descending
  int* order = new int[n];
  for (int i = 0; i < n; ++i) order[i] = i;
  std::sort(order, order + n,
            [&](int a, int b) { return scores[a] > scores[b]; });
  std::memset(keep, 0, n);
  uint8_t* dead = new uint8_t[n]();
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (dead[oi]) continue;
    keep[i] = 1;
    const float* bi = boxes + i * 5;
    const double ai = (double)bi[2] * bi[3];
    for (int oj = oi + 1; oj < n; ++oj) {
      if (dead[oj]) continue;
      const int j = order[oj];
      const float* bj = boxes + j * 5;
      const double inter = rect_intersection(bi, bj);
      const double uni = ai + (double)bj[2] * bj[3] - inter;
      if (inter / std::max(uni, 1e-8) > thresh) dead[oj] = 1;
    }
  }
  delete[] order;
  delete[] dead;
}

// 3D IoU for camera-frame boxes [l, h, w, x, y, z, ry]:
// BEV (x-z plane) overlap x vertical (y) overlap.
void boxes_iou_3d(const float* boxes1, int n1, const float* boxes2, int n2,
                  float* out) {
  for (int i = 0; i < n1; ++i) {
    const float* a = boxes1 + i * 7;
    const float bev_a[5] = {a[3], a[5], a[0], a[2], a[6]};
    const double va = (double)a[0] * a[1] * a[2];
    for (int j = 0; j < n2; ++j) {
      const float* b = boxes2 + j * 7;
      const float bev_b[5] = {b[3], b[5], b[0], b[2], b[6]};
      const double inter_bev = rect_intersection(bev_a, bev_b);
      const double ya_top = a[4] - a[1], yb_top = b[4] - b[1];
      const double inter_h =
          std::max(std::min((double)a[4], (double)b[4]) -
                       std::max(ya_top, yb_top),
                   0.0);
      const double inter = inter_bev * inter_h;
      const double vb = (double)b[0] * b[1] * b[2];
      out[i * n2 + j] = (float)(inter / std::max(va + vb - inter, 1e-8));
    }
  }
}

}  // extern "C"
