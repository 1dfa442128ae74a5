// Native match densification: per-square homography rasterization.
//
// The host-hot inner loop of dense initialization (the role of the
// reference's C++ DensifyMatches, reference: applications/
// camera_calibration/src/camera_calibration/calibration_initialization/
// dense_initialization.cc:118-292): for each detected pattern square,
// estimate the exact 4-point homography image->pattern and write the
// pattern-plane 3D point of every buffer pixel inside the square.
//
// Exposed as a C ABI for ctypes; compiled on demand by the package
// (see native/__init__.py).  Interior test is done in pattern space
// (the homography maps the quad exactly onto the unit cell).

#include <cmath>
#include <cstring>

namespace {

// Solve the 8x8 linear system for the 4-point homography h (h22 = 1),
// mapping (x_i, y_i) -> (u_i, v_i).  Returns false if singular.
bool homography4(const double* src, const double* dst, double* h) {
  double a[8][9];
  for (int i = 0; i < 4; ++i) {
    const double x = src[2 * i], y = src[2 * i + 1];
    const double u = dst[2 * i], v = dst[2 * i + 1];
    double* r0 = a[2 * i];
    double* r1 = a[2 * i + 1];
    r0[0] = x; r0[1] = y; r0[2] = 1; r0[3] = 0; r0[4] = 0; r0[5] = 0;
    r0[6] = -u * x; r0[7] = -u * y; r0[8] = u;
    r1[0] = 0; r1[1] = 0; r1[2] = 0; r1[3] = x; r1[4] = y; r1[5] = 1;
    r1[6] = -v * x; r1[7] = -v * y; r1[8] = v;
  }
  // Gaussian elimination with partial pivoting.
  for (int col = 0; col < 8; ++col) {
    int piv = col;
    double best = std::fabs(a[col][col]);
    for (int r = col + 1; r < 8; ++r) {
      const double m = std::fabs(a[r][col]);
      if (m > best) { best = m; piv = r; }
    }
    if (best < 1e-14) return false;
    if (piv != col) {
      for (int c = 0; c < 9; ++c) {
        const double tmp = a[col][c]; a[col][c] = a[piv][c]; a[piv][c] = tmp;
      }
    }
    const double inv = 1.0 / a[col][col];
    for (int c = col; c < 9; ++c) a[col][c] *= inv;
    for (int r = 0; r < 8; ++r) {
      if (r == col) continue;
      const double f = a[r][col];
      if (f == 0.0) continue;
      for (int c = col; c < 9; ++c) a[r][c] -= f * a[col][c];
    }
  }
  for (int i = 0; i < 8; ++i) h[i] = a[i][8];
  h[8] = 1.0;
  return true;
}

}  // namespace

extern "C" {

// corners_img: (n_squares, 4, 2) pixel-corner coords (order: (cx,cy),
// (cx+1,cy), (cx+1,cy+1), (cx,cy+1)); cells: (n_squares, 2) integer cell
// coords (cx, cy).  Output buffers: pts (bh, bw, 3) doubles and valid
// (bh, bw) uint8 — both preinitialized by the caller (NaN / 0), so calls
// can accumulate multiple geometries.  Pattern points are transformed by
// x_out = r_kg * (cell_len*u, cell_len*v, 0) + t_kg.
// Returns the number of written pixels.
long densify_matches(
    const double* corners_img, const long* cells, long n_squares,
    double cell_len, const double* r_kg, const double* t_kg,
    long bw, long bh, double scale_x, double scale_y,
    double* pts, unsigned char* valid) {
  long written = 0;
  for (long s = 0; s < n_squares; ++s) {
    const double* ci = corners_img + s * 8;
    const double cx = static_cast<double>(cells[2 * s]);
    const double cy = static_cast<double>(cells[2 * s + 1]);
    const double pat[8] = {cx, cy, cx + 1, cy, cx + 1, cy + 1, cx, cy + 1};
    double h[9];
    if (!homography4(ci, pat, h)) continue;

    // bounding box in buffer coords
    double min_x = ci[0], max_x = ci[0], min_y = ci[1], max_y = ci[1];
    for (int k = 1; k < 4; ++k) {
      min_x = std::fmin(min_x, ci[2 * k]);
      max_x = std::fmax(max_x, ci[2 * k]);
      min_y = std::fmin(min_y, ci[2 * k + 1]);
      max_y = std::fmax(max_y, ci[2 * k + 1]);
    }
    long bx0 = static_cast<long>(std::floor(min_x / scale_x));
    long bx1 = static_cast<long>(std::ceil(max_x / scale_x));
    long by0 = static_cast<long>(std::floor(min_y / scale_y));
    long by1 = static_cast<long>(std::ceil(max_y / scale_y));
    if (bx0 < 0) bx0 = 0;
    if (by0 < 0) by0 = 0;
    if (bx1 > bw - 1) bx1 = bw - 1;
    if (by1 > bh - 1) by1 = bh - 1;

    for (long by = by0; by <= by1; ++by) {
      const double py = (by + 0.5) * scale_y;
      for (long bx = bx0; bx <= bx1; ++bx) {
        const double px = (bx + 0.5) * scale_x;
        const double w = h[6] * px + h[7] * py + h[8];
        if (std::fabs(w) < 1e-14) continue;
        const double u = (h[0] * px + h[1] * py + h[2]) / w;
        const double v = (h[3] * px + h[4] * py + h[5]) / w;
        if (u < cx || u >= cx + 1.0 || v < cy || v >= cy + 1.0) continue;
        const double mu = u * cell_len;
        const double mv = v * cell_len;
        double* out = pts + (by * bw + bx) * 3;
        out[0] = r_kg[0] * mu + r_kg[1] * mv + t_kg[0];
        out[1] = r_kg[3] * mu + r_kg[4] * mv + t_kg[1];
        out[2] = r_kg[6] * mu + r_kg[7] * mv + t_kg[2];
        if (!valid[by * bw + bx]) ++written;
        valid[by * bw + bx] = 1;
      }
    }
  }
  return written;
}

// Star-pattern intensity oracle, vectorized (reference:
// feature_detector_tagged_pattern.h:115-130).  positions: (n, 2);
// out: (n,) with 1 = white, 0 = black, 0.5 at centers.
void pattern_intensity(const double* positions, long n, long num_segments,
                       double* out) {
  const double two_pi = 6.283185307179586476925286766559;
  for (long i = 0; i < n; ++i) {
    const double px = positions[2 * i];
    const double py = positions[2 * i + 1];
    const double cx = px - (px > 0 ? 1.0 : -1.0) *
        std::floor(std::fabs(px) + 0.5);
    const double cy = py - (py > 0 ? 1.0 : -1.0) *
        std::floor(std::fabs(py) + 0.5);
    if (cx * cx + cy * cy < 1e-8) {
      out[i] = 0.5;
      continue;
    }
    double angle = std::atan2(cy, cx) - 1.5707963267948966;
    if (angle < 0) angle += two_pi;
    const long seg = static_cast<long>(num_segments * angle / two_pi);
    out[i] = (seg % 2 == 0) ? 1.0 : 0.0;
  }
}

}  // extern "C"
