// LSD, the line segment detector of R. Grompone von Gioi, J. Jakubowicz,
// J.-M. Morel and G. Randall, "LSD: a Line Segment Detector", IPOL 2012,
// with the front end and the defaults of OpenCV's
// createLineSegmentDetector(): scale 0.8, sigma_scale 0.6, quant 2.0,
// ang_th 22.5, density_th 0.7, n_bins 1024, standard refinement (which
// runs no NFA test, so log_eps plays no part).
//
// The front end reproduces OpenCV's integer image path bit for bit, so the
// gradients are the ones cv2 sees:
//   * Gaussian blur of the 8-bit image, sigma = sigma_scale / scale, a
//     (2h+1)^2 kernel with h = ceil(sigma * sqrt(2 * 3 * ln 10)); the kernel
//     is quantised to 8 fraction bits by error diffusion, applied separably
//     in exact integer arithmetic with reflect-101 borders and rounded back
//     to 8 bits;
//   * bilinear resize by `scale` (half-pixel centres, 8-bit weights,
//     replicated edges), rounded to 8 bits;
//   * level-line angles from the 2x2 integer gradient with a float
//     polynomial atan2 (OpenCV's fastAtan2), pseudo-ordered by 1024 bins
//     of the gradient norm, strongest bin first and raster order within a
//     bin (the seed order decides which region claims a pixel).
// Everything after the front end is double, as in the paper.
//
// Plain C interface for ctypes: pv_lsd(gray, rows, cols, &segs) returns the
// number of segments and a malloc'ed (n, 4) float array [x1 y1 x2 y2] in
// input pixels, freed with pv_lsd_free.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr double kScale = 0.8;
constexpr double kSigmaScale = 0.6;
constexpr double kQuant = 2.0;
constexpr double kAngTh = 22.5;
constexpr double kDensityTh = 0.7;
constexpr int kBins = 1024;

constexpr double kPi = 3.14159265358979323846;
constexpr double k3Half = (3 * kPi) / 2;
constexpr double k2Pi = 2 * kPi;
constexpr double kDegToRad = kPi / 180;
constexpr double kNotDef = -1024.0;
constexpr double kRelErr = 100.0;

// atan2 in degrees, [0, 360), as OpenCV's fastAtan2 evaluates it in float.
float fast_atan2(float y, float x) {
  static const float d = float(180 / kPi);
  static const float p1 = 0.9997878412794807f * d;
  static const float p3 = -0.3258083974640975f * d;
  static const float p5 = 0.1555786518463281f * d;
  static const float p7 = -0.04432655554792128f * d;
  const float eps = float(2.220446049250313e-16);
  float ax = std::fabs(x), ay = std::fabs(y), a, c, c2;
  if (ax >= ay) {
    c = ay / (ax + eps);
    c2 = c * c;
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c;
  } else {
    c = ax / (ay + eps);
    c2 = c * c;
    a = 90.f - (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c;
  }
  if (x < 0) a = 180.f - a;
  if (y < 0) a = 360.f - a;
  return a;
}

// Gaussian kernel of n taps quantised to 8 fraction bits (sum 256) by
// error diffusion from the outer taps inward; the centre takes the rest.
std::vector<int64_t> gaussian_q8(int n, double sigma) {
  const double scale2 = -0.125 / (sigma * sigma);
  const int n2 = (n - 1) / 2;
  std::vector<double> vals(n2);
  double sum = 0;
  for (int i = 0, x = 1 - n; i < n2; i++, x += 2) {
    vals[i] = std::exp(double(x * x) * scale2);
    sum += vals[i];
  }
  sum = sum * 2 + 1.0;
  const double mul = 1.0 / sum;
  std::vector<int64_t> k(n);
  double err = 0;
  int64_t s = 0;
  for (int i = 0; i < n2; i++) {
    double adj = vals[i] * mul * 256.0 + err;
    int64_t v = (int64_t)std::nearbyint(adj);   // ties to even
    err = adj - double(v);
    k[i] = k[n - 1 - i] = v;
    s += v;
  }
  k[n2] = 256 - 2 * s;
  return k;
}

int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) i = i < 0 ? -i : 2 * n - 2 - i;
  return i;
}

std::vector<uint8_t> gaussian_blur(const uint8_t* img, int H, int W, double sigma) {
  const int h = (int)std::ceil(sigma * std::sqrt(2 * 3 * std::log(10.0)));
  const int n = 2 * h + 1;
  const std::vector<int64_t> k = gaussian_q8(n, sigma);
  std::vector<int64_t> hz((size_t)H * W);
  std::vector<int> xs(W + 2 * h);
  for (int j = 0; j < W + 2 * h; j++) xs[j] = reflect101(j - h, W);
  for (int y = 0; y < H; y++) {
    const uint8_t* row = img + (size_t)y * W;
    for (int x = 0; x < W; x++) {
      int64_t acc = 0;
      for (int j = 0; j < n; j++) acc += k[j] * row[xs[x + j]];
      hz[(size_t)y * W + x] = acc;
    }
  }
  std::vector<uint8_t> out((size_t)H * W);
  for (int y = 0; y < H; y++) {
    for (int x = 0; x < W; x++) {
      int64_t acc = 0;
      for (int j = 0; j < n; j++) acc += k[j] * hz[(size_t)reflect101(y + j - h, H) * W + x];
      out[(size_t)y * W + x] = (uint8_t)std::min<int64_t>(255, (acc + (1 << 15)) >> 16);
    }
  }
  return out;
}

// Source offset and 8-bit weight of the right/lower neighbour for each
// destination index; an edge index copies the edge pixel.
void linear_coeffs(int n_src, int n_dst, double scale, std::vector<int>& ofs,
                   std::vector<int64_t>& w1) {
  ofs.assign(n_dst, 0);
  w1.assign(n_dst, 0);
  const double inv = 1.0 / scale;
  for (int d = 0; d < n_dst; d++) {
    double f = inv * (double(d) + 0.5) - 0.5;
    int i = (int)std::floor(f);
    if (i < 0 || n_src <= 1) {
      ofs[d] = 0;
    } else if (i >= n_src - 1) {
      ofs[d] = n_src - 1;
    } else {
      ofs[d] = i;
      w1[d] = (int64_t)std::nearbyint((f - i) * 256.0);
    }
  }
}

std::vector<uint8_t> resize_linear(const std::vector<uint8_t>& img, int H, int W,
                                   double scale, int& H2, int& W2) {
  H2 = (int)std::lround(H * scale);
  W2 = (int)std::lround(W * scale);
  std::vector<int> ox, oy;
  std::vector<int64_t> wx, wy;
  linear_coeffs(W, W2, scale, ox, wx);
  linear_coeffs(H, H2, scale, oy, wy);
  std::vector<int64_t> hz((size_t)H * W2);
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W2; x++) {
      const uint8_t* row = img.data() + (size_t)y * W;
      const int x1 = std::min(ox[x] + 1, W - 1);
      hz[(size_t)y * W2 + x] = row[ox[x]] * (256 - wx[x]) + row[x1] * wx[x];
    }
  std::vector<uint8_t> out((size_t)H2 * W2);
  for (int y = 0; y < H2; y++) {
    const int y1 = std::min(oy[y] + 1, H - 1);
    for (int x = 0; x < W2; x++) {
      int64_t v = hz[(size_t)oy[y] * W2 + x] * (256 - wy[y]) + hz[(size_t)y1 * W2 + x] * wy[y];
      out[(size_t)y * W2 + x] = (uint8_t)std::min<int64_t>(255, (v + (1 << 15)) >> 16);
    }
  }
  return out;
}

struct NormPoint {
  int x, y, norm;
};

struct RegionPoint {
  int x, y;
  double angle, modgrad;
};

struct Rect {
  double x1, y1, x2, y2, width, x, y, theta, dx, dy;
};

double dist(double x1, double y1, double x2, double y2) {
  return std::sqrt((x2 - x1) * (x2 - x1) + (y2 - y1) * (y2 - y1));
}

double dist_sq(double x1, double y1, double x2, double y2) {
  return (x2 - x1) * (x2 - x1) + (y2 - y1) * (y2 - y1);
}

double angle_diff_signed(double a, double b) {
  double d = a - b;
  while (d <= -kPi) d += k2Pi;
  while (d > kPi) d -= k2Pi;
  return d;
}

double angle_diff(double a, double b) { return std::fabs(angle_diff_signed(a, b)); }

bool double_equal(double a, double b) {
  if (a == b) return true;
  double abs_max = std::max(std::fabs(a), std::fabs(b));
  if (abs_max < 2.2250738585072014e-308) abs_max = 2.2250738585072014e-308;
  return std::fabs(a - b) / abs_max <= kRelErr * 2.220446049250313e-16;
}

class Detector {
 public:
  Detector(const uint8_t* gray, int H, int W) {
    const double sigma = kScale < 1 ? kSigmaScale / kScale : kSigmaScale;
    std::vector<uint8_t> blurred = gaussian_blur(gray, H, W, sigma);
    img_ = resize_linear(blurred, H, W, kScale, h_, w_);
  }

  std::vector<float> run() {
    const double prec = kPi * kAngTh / 180;
    const double p = kAngTh / 180;
    const double rho = kQuant / std::sin(prec);
    ll_angle(rho);
    const double log_nt = 5 * (std::log10(double(w_)) + std::log10(double(h_))) / 2 + std::log10(11.0);
    const size_t min_reg_size = size_t(-log_nt / std::log10(p));
    used_.assign((size_t)h_ * w_, 0);
    std::vector<float> out;
    std::vector<RegionPoint> reg;
    for (const NormPoint& pt : order_) {
      const size_t at = (size_t)pt.y * w_ + pt.x;
      if (used_[at] || angles_[at] == kNotDef) continue;
      double reg_angle;
      region_grow(pt.x, pt.y, reg, reg_angle, prec);
      if (reg.size() < min_reg_size) continue;
      Rect rec;
      region2rect(reg, reg_angle, prec, rec);
      if (!refine(reg, reg_angle, prec, rec)) continue;
      out.push_back(float((rec.x1 + 0.5) / kScale));
      out.push_back(float((rec.y1 + 0.5) / kScale));
      out.push_back(float((rec.x2 + 0.5) / kScale));
      out.push_back(float((rec.y2 + 0.5) / kScale));
    }
    return out;
  }

 private:
  int h_ = 0, w_ = 0;
  std::vector<uint8_t> img_, used_;
  std::vector<double> angles_, modgrad_;
  std::vector<NormPoint> order_;

  void ll_angle(double threshold) {
    angles_.assign((size_t)h_ * w_, kNotDef);
    modgrad_.assign((size_t)h_ * w_, 0.0);
    double max_grad = -1;
    for (int y = 0; y < h_ - 1; y++) {
      const uint8_t* r0 = img_.data() + (size_t)y * w_;
      const uint8_t* r1 = r0 + w_;
      for (int x = 0; x < w_ - 1; x++) {
        int da = r1[x + 1] - r0[x];
        int bc = r0[x + 1] - r1[x];
        int gx = da + bc, gy = da - bc;
        double norm = std::sqrt((gx * gx + gy * gy) / 4.0);
        modgrad_[(size_t)y * w_ + x] = norm;
        if (norm > threshold) {
          angles_[(size_t)y * w_ + x] = fast_atan2(float(gx), float(-gy)) * kDegToRad;
          if (norm > max_grad) max_grad = norm;
        }
      }
    }
    const double bin_coef = max_grad > 0 ? double(kBins - 1) / max_grad : 0;
    order_.clear();
    order_.reserve((size_t)(h_ - 1) * (w_ - 1));
    for (int y = 0; y < h_ - 1; y++)
      for (int x = 0; x < w_ - 1; x++)
        order_.push_back({x, y, int(modgrad_[(size_t)y * w_ + x] * bin_coef)});
    std::stable_sort(order_.begin(), order_.end(),
              [](const NormPoint& a, const NormPoint& b) { return a.norm > b.norm; });
  }

  bool aligned(int x, int y, double theta, double prec) const {
    if (x < 0 || y < 0 || x >= w_ || y >= h_) return false;
    const double a = angles_[(size_t)y * w_ + x];
    if (a == kNotDef) return false;
    double n = theta - a;
    if (n < 0) n = -n;
    if (n > k3Half) {
      n -= k2Pi;
      if (n < 0) n = -n;
    }
    return n <= prec;
  }

  void region_grow(int sx, int sy, std::vector<RegionPoint>& reg, double& reg_angle,
                   double prec) {
    reg.clear();
    const size_t s = (size_t)sy * w_ + sx;
    reg_angle = angles_[s];
    reg.push_back({sx, sy, reg_angle, modgrad_[s]});
    float sumdx = float(std::cos(reg_angle));
    float sumdy = float(std::sin(reg_angle));
    used_[s] = 1;
    for (size_t i = 0; i < reg.size(); i++) {
      const int px = reg[i].x, py = reg[i].y;
      const int x0 = std::max(px - 1, 0), x1 = std::min(px + 1, w_ - 1);
      const int y0 = std::max(py - 1, 0), y1 = std::min(py + 1, h_ - 1);
      for (int yy = y0; yy <= y1; yy++)
        for (int xx = x0; xx <= x1; xx++) {
          const size_t at = (size_t)yy * w_ + xx;
          if (used_[at] || !aligned(xx, yy, reg_angle, prec)) continue;
          const double angle = angles_[at];
          used_[at] = 1;
          reg.push_back({xx, yy, angle, modgrad_[at]});
          sumdx += std::cos(float(angle));
          sumdy += std::sin(float(angle));
          reg_angle = fast_atan2(sumdy, sumdx) * kDegToRad;
        }
    }
  }

  double get_theta(const std::vector<RegionPoint>& reg, double x, double y, double reg_angle,
                   double prec) const {
    double ixx = 0, iyy = 0, ixy = 0;
    for (const RegionPoint& r : reg) {
      const double dx = double(r.x) - x, dy = double(r.y) - y;
      ixx += dy * dy * r.modgrad;
      iyy += dx * dx * r.modgrad;
      ixy -= dx * dy * r.modgrad;
    }
    if (double_equal(ixx, 0) && double_equal(iyy, 0) && double_equal(ixy, 0)) return reg_angle;
    const double lambda = 0.5 * (ixx + iyy - std::sqrt((ixx - iyy) * (ixx - iyy) + 4.0 * ixy * ixy));
    double theta = std::fabs(ixx) > std::fabs(iyy)
                       ? double(fast_atan2(float(lambda - ixx), float(ixy)))
                       : double(fast_atan2(float(ixy), float(lambda - iyy)));
    theta *= kDegToRad;
    if (angle_diff(theta, reg_angle) > prec) theta += kPi;
    return theta;
  }

  void region2rect(const std::vector<RegionPoint>& reg, double reg_angle, double prec,
                   Rect& rec) const {
    double x = 0, y = 0, sum = 0;
    for (const RegionPoint& r : reg) {
      x += double(r.x) * r.modgrad;
      y += double(r.y) * r.modgrad;
      sum += r.modgrad;
    }
    x /= sum;
    y /= sum;
    const double theta = get_theta(reg, x, y, reg_angle, prec);
    const double dx = std::cos(theta), dy = std::sin(theta);
    double l_min = 0, l_max = 0, w_min = 0, w_max = 0;
    for (const RegionPoint& r : reg) {
      const double rx = double(r.x) - x, ry = double(r.y) - y;
      const double l = rx * dx + ry * dy;
      const double w = -rx * dy + ry * dx;
      if (l > l_max) l_max = l;
      else if (l < l_min) l_min = l;
      if (w > w_max) w_max = w;
      else if (w < w_min) w_min = w;
    }
    rec.x1 = x + l_min * dx;
    rec.y1 = y + l_min * dy;
    rec.x2 = x + l_max * dx;
    rec.y2 = y + l_max * dy;
    rec.width = w_max - w_min;
    rec.x = x;
    rec.y = y;
    rec.theta = theta;
    rec.dx = dx;
    rec.dy = dy;
    if (rec.width < 1.0) rec.width = 1.0;
  }

  static double density(const std::vector<RegionPoint>& reg, const Rect& rec) {
    return double(reg.size()) / (dist(rec.x1, rec.y1, rec.x2, rec.y2) * rec.width);
  }

  bool refine(std::vector<RegionPoint>& reg, double reg_angle, double prec, Rect& rec) {
    if (density(reg, rec) >= kDensityTh) return true;
    // a tighter angle tolerance: twice the spread of the angles near the seed
    const double xc = double(reg[0].x), yc = double(reg[0].y), ang_c = reg[0].angle;
    double sum = 0, s_sum = 0;
    int n = 0;
    for (const RegionPoint& r : reg) {
      used_[(size_t)r.y * w_ + r.x] = 0;
      if (dist(xc, yc, r.x, r.y) < rec.width) {
        const double d = angle_diff_signed(r.angle, ang_c);
        sum += d;
        s_sum += d * d;
        n++;
      }
    }
    const double mean = sum / double(n);
    const double tau = 2.0 * std::sqrt((s_sum - 2.0 * mean * sum) / double(n) + mean * mean);
    region_grow(reg[0].x, reg[0].y, reg, reg_angle, tau);
    if (reg.size() < 2) return false;
    region2rect(reg, reg_angle, prec, rec);
    if (density(reg, rec) >= kDensityTh) return true;
    return reduce_radius(reg, reg_angle, prec, rec);
  }

  bool reduce_radius(std::vector<RegionPoint>& reg, double reg_angle, double prec, Rect& rec) {
    const double xc = double(reg[0].x), yc = double(reg[0].y);
    double rad_sq = std::max(dist_sq(xc, yc, rec.x1, rec.y1), dist_sq(xc, yc, rec.x2, rec.y2));
    while (density(reg, rec) < kDensityTh) {
      rad_sq *= 0.75 * 0.75;
      for (size_t i = 0; i < reg.size(); i++) {
        if (dist_sq(xc, yc, double(reg[i].x), double(reg[i].y)) > rad_sq) {
          used_[(size_t)reg[i].y * w_ + reg[i].x] = 0;
          std::swap(reg[i], reg.back());
          reg.pop_back();
          i--;   // the swapped-in point is tested next (wraps to 0 at the front)
        }
      }
      if (reg.size() < 2) return false;
      region2rect(reg, reg_angle, prec, rec);
    }
    return true;
  }
};

}  // namespace

extern "C" {

long pv_lsd(const uint8_t* gray, int rows, int cols, float** segs) {
  *segs = nullptr;
  if (rows < 2 || cols < 2) return 0;
  std::vector<float> out = Detector(gray, rows, cols).run();
  const long n = (long)(out.size() / 4);
  if (n == 0) return 0;
  *segs = (float*)std::malloc(out.size() * sizeof(float));
  if (!*segs) return -1;
  std::memcpy(*segs, out.data(), out.size() * sizeof(float));
  return n;
}

void pv_lsd_free(void* p) { std::free(p); }

}  // extern "C"
