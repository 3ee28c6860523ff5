// Pyramidal Lucas-Kanade sparse optical flow with the arithmetic of
// OpenCV's calcOpticalFlowPyrLK (modules/video/src/lkpyramid.cpp:
// buildOpticalFlowPyramid, calcSharrDeriv, LKTrackerInvoker) at the
// arguments cv2's defaults give: a 21 x 21 window, maxLevel 3, at most 30
// iterations per level, a step of at most 0.01 px ends them, no initial
// flow, minEigThreshold 1e-4. One 8-bit channel.
//
//   * pyramid: level 0 is the image, level k + 1 is pyrDown of level k
//     (5x5 [1 4 6 4 1]^2 / 256, reflect-101, ((w + 1) / 2, (h + 1) / 2));
//     the levels stop before one whose side would be 21 px or less. Each
//     level is padded by the window size, reflect-101;
//   * derivatives: Scharr (3 10 3 smoothing, central difference) of each
//     level of the first image in int16, reflect-101 inside, zero in the
//     window-wide pad;
//   * window samples: bilinear in 14-bit fixed point, the image scaled by
//     32 (5 fraction bits), rounded shifts as CV_DESCALE;
//   * sums: OpenCV accumulates the 2x2 gradient matrix and the mismatch
//     vector in float, partly in 4-lane SIMD registers. The sums here
//     follow the same lanes and the same order (columns 0-15 of a window
//     row in 4 lanes for the matrix, and as int32 pair sums in two 4-lane
//     registers for the vector; columns 16-20 serially), so that the float
//     results are OpenCV's (checked bit for bit against cv2 5.0 on x86);
//   * a point is lost (status 0) when at level 0 its window leaves the
//     padded image or the matrix's smallest eigenvalue per pixel is below
//     1e-4 (or its determinant below FLT_EPSILON).
//
// Plain C interface for ctypes: pv_lk(prev, next, rows, cols, pts, n, out,
// status) tracks n points (x, y) float32 of `prev` into `next` (both uint8
// rows x cols), writes the tracked points to out (n, 2) and the status to
// status (n,); returns the top pyramid level used, or -1 when the images
// are too small (a side of 21 px or less). The two pyramids build on two
// threads and the points are tracked on up to 8; each point's arithmetic is
// the same on any number of threads.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kWin = 21;
constexpr int kMaxLevel = 3;
constexpr int kMaxCount = 30;
constexpr float kMinEig = 1e-4f;
constexpr int kWBits = 14;
constexpr float kFltScale = 1.f / (1 << 20);

inline int descale(int x, int n) { return (x + (1 << (n - 1))) >> n; }

int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

// An image level with a kWin-wide pad on every side.
template <typename T, int C>
struct Padded {
  int rows = 0, cols = 0, stride = 0;
  std::vector<T> data;
  void init(int r, int c) {
    rows = r;
    cols = c;
    stride = (c + 2 * kWin) * C;
    data.assign((size_t)(r + 2 * kWin) * stride, T(0));
  }
  T* at(int y, int x) { return data.data() + (size_t)(y + kWin) * stride + (x + kWin) * C; }
  const T* at(int y, int x) const {
    return data.data() + (size_t)(y + kWin) * stride + (x + kWin) * C;
  }
};

using Image = Padded<uint8_t, 1>;
using Deriv = Padded<int16_t, 2>;

void pad_reflect101(Image& im) {
  for (int y = 0; y < im.rows; y++) {
    uint8_t* row = im.at(y, 0);
    for (int x = 1; x <= kWin; x++) {
      row[-x] = row[reflect101(-x, im.cols)];
      row[im.cols - 1 + x] = row[reflect101(im.cols - 1 + x, im.cols)];
    }
  }
  const size_t width = (size_t)im.cols + 2 * kWin;
  for (int y = 1; y <= kWin; y++) {
    std::memcpy(im.at(-y, -kWin), im.at(reflect101(-y, im.rows), -kWin), width);
    std::memcpy(im.at(im.rows - 1 + y, -kWin),
                im.at(reflect101(im.rows - 1 + y, im.rows), -kWin), width);
  }
}

// cv::pyrDown into an image of ((w + 1) / 2, (h + 1) / 2): exact integers.
void pyr_down(const Image& src, Image& dst) {
  dst.init((src.rows + 1) / 2, (src.cols + 1) / 2);
  std::vector<int> row((size_t)src.cols);
  std::vector<int> col_idx((size_t)dst.cols * 5);
  for (int x = 0; x < dst.cols; x++)
    for (int j = 0; j < 5; j++) col_idx[(size_t)x * 5 + j] = reflect101(2 * x + j - 2, src.cols);
  for (int y = 0; y < dst.rows; y++) {
    const uint8_t* r[5];
    for (int i = 0; i < 5; i++) r[i] = src.at(reflect101(2 * y + i - 2, src.rows), 0);
    for (int x = 0; x < src.cols; x++)
      row[(size_t)x] = r[0][x] + 4 * r[1][x] + 6 * r[2][x] + 4 * r[3][x] + r[4][x];
    for (int x = 0; x < dst.cols; x++) {
      const int* c = col_idx.data() + (size_t)x * 5;
      const int s = row[(size_t)c[0]] + 4 * row[(size_t)c[1]] + 6 * row[(size_t)c[2]] +
                    4 * row[(size_t)c[3]] + row[(size_t)c[4]];
      *dst.at(y, x) = (uint8_t)((s + 128) >> 8);
    }
  }
  pad_reflect101(dst);
}

// calcSharrDeriv: (Ix, Iy) per pixel, int16, rows and columns reflect-101.
void sharr_deriv(const Image& src, Deriv& dst) {
  const int rows = src.rows, cols = src.cols;
  dst.init(rows, cols);
  std::vector<int> t0((size_t)cols + 2), t1((size_t)cols + 2);
  for (int y = 0; y < rows; y++) {
    const int y0 = y > 0 ? y - 1 : (rows > 1 ? 1 : 0);
    const int y2 = y < rows - 1 ? y + 1 : (rows > 1 ? rows - 2 : 0);
    for (int x = 0; x < cols; x++) {
      const int a = *src.at(y0, x), b = *src.at(y, x), c = *src.at(y2, x);
      t0[(size_t)x + 1] = (int16_t)((a + c) * 3 + b * 10);
      t1[(size_t)x + 1] = (int16_t)(c - a);
    }
    const int x0 = cols > 1 ? 1 : 0, x1 = cols > 1 ? cols - 2 : 0;
    t0[0] = t0[(size_t)x0 + 1];
    t0[(size_t)cols + 1] = t0[(size_t)x1 + 1];
    t1[0] = t1[(size_t)x0 + 1];
    t1[(size_t)cols + 1] = t1[(size_t)x1 + 1];
    for (int x = 0; x < cols; x++) {
      int16_t* d = dst.at(y, x);
      d[0] = (int16_t)(t0[(size_t)x + 2] - t0[(size_t)x]);
      d[1] = (int16_t)((t1[(size_t)x + 2] + t1[(size_t)x]) * 3 + t1[(size_t)x + 1] * 10);
    }
  }
}

// The four fixed-point bilinear weights of the fraction (a, b).
struct Weights {
  int w00, w01, w10, w11;
  Weights(float a, float b) {
    w00 = (int)std::lrint((1.f - a) * (1.f - b) * (1 << kWBits));
    w01 = (int)std::lrint(a * (1.f - b) * (1 << kWBits));
    w10 = (int)std::lrint((1.f - a) * b * (1 << kWBits));
    w11 = (1 << kWBits) - w00 - w01 - w10;
  }
};

// OpenCV's v_reduce_sum of a float32x4 on SSE: the high half onto the low
// half, then the two lanes left.
inline float reduce4(const float q[4]) { return (q[0] + q[2]) + (q[1] + q[3]); }

struct Tracker {
  const Image& I;
  const Deriv& dI;
  const Image& J;
  int level;

  // One point at this level. prev: the point in level-0 pixels; next: the
  // running estimate in level-0 pixels scaled to the level before the
  // call, updated in place; status cleared at level 0 when lost.
  void track(float px, float py, float& nx, float& ny, uint8_t& status) const {
    const float half = (kWin - 1) * 0.5f;
    const float scale = (float)(1. / (1 << level));
    float prev_x = px * scale - half, prev_y = py * scale - half;
    const int ipx = (int)std::floor(prev_x), ipy = (int)std::floor(prev_y);
    if (ipx < -kWin || ipx >= dI.cols || ipy < -kWin || ipy >= dI.rows) {
      if (level == 0) status = 0;
      return;
    }
    Weights w(prev_x - ipx, prev_y - ipy);
    int16_t Iwin[kWin][kWin], Ix[kWin][kWin], Iy[kWin][kWin];
    float qA11[4] = {0, 0, 0, 0}, qA12[4] = {0, 0, 0, 0}, qA22[4] = {0, 0, 0, 0};
    float iA11 = 0, iA12 = 0, iA22 = 0;
    for (int y = 0; y < kWin; y++) {
      const uint8_t* s0 = I.at(ipy + y, ipx);
      const uint8_t* s1 = I.at(ipy + y + 1, ipx);
      const int16_t* d0 = dI.at(ipy + y, ipx);
      const int16_t* d1 = dI.at(ipy + y + 1, ipx);
      for (int x = 0; x < kWin; x++) {
        const int ival = descale(s0[x] * w.w00 + s0[x + 1] * w.w01 + s1[x] * w.w10 +
                                 s1[x + 1] * w.w11, kWBits - 5);
        const int ixval = descale(d0[2 * x] * w.w00 + d0[2 * x + 2] * w.w01 +
                                  d1[2 * x] * w.w10 + d1[2 * x + 2] * w.w11, kWBits);
        const int iyval = descale(d0[2 * x + 1] * w.w00 + d0[2 * x + 3] * w.w01 +
                                  d1[2 * x + 1] * w.w10 + d1[2 * x + 3] * w.w11, kWBits);
        Iwin[y][x] = (int16_t)ival;
        Ix[y][x] = (int16_t)ixval;
        Iy[y][x] = (int16_t)iyval;
        if (x < kWin - kWin % 8) {   // the SIMD loop of columns 0-15, 4 lanes
          const int lane = x & 3;
          qA11[lane] += (float)(ixval * ixval);
          qA12[lane] += (float)(ixval * iyval);
          qA22[lane] += (float)(iyval * iyval);
        } else {
          iA11 += (float)(ixval * ixval);
          iA12 += (float)(ixval * iyval);
          iA22 += (float)(iyval * iyval);
        }
      }
    }
    iA11 += reduce4(qA11);
    iA12 += reduce4(qA12);
    iA22 += reduce4(qA22);
    const float A11 = iA11 * kFltScale, A12 = iA12 * kFltScale, A22 = iA22 * kFltScale;
    float D = A11 * A22 - A12 * A12;
    const float min_eig = (A22 + A11 - std::sqrt((A11 - A22) * (A11 - A22) + 4.f * A12 * A12)) /
                          (float)(2 * kWin * kWin);
    if (min_eig < kMinEig || D < FLT_EPSILON) {
      if (level == 0) status = 0;
      return;
    }
    D = 1.f / D;

    double eps = 0.01;
    eps *= eps;
    float next_x = nx - half, next_y = ny - half;
    float prev_dx = 0, prev_dy = 0;
    for (int j = 0; j < kMaxCount; j++) {
      const int inx = (int)std::floor(next_x), iny = (int)std::floor(next_y);
      if (inx < -kWin || inx >= J.cols || iny < -kWin || iny >= J.rows) {
        if (level == 0) status = 0;
        break;
      }
      Weights v(next_x - inx, next_y - iny);
      float qb0[4] = {0, 0, 0, 0}, qb1[4] = {0, 0, 0, 0};
      float ib1 = 0, ib2 = 0;
      for (int y = 0; y < kWin; y++) {
        const uint8_t* j0 = J.at(iny + y, inx);
        const uint8_t* j1 = J.at(iny + y + 1, inx);
        int diff[kWin];
        for (int x = 0; x < kWin; x++)
          diff[x] = descale(j0[x] * v.w00 + j0[x + 1] * v.w01 + j1[x] * v.w10 +
                            j1[x + 1] * v.w11, kWBits - 5) - Iwin[y][x];
        // the 8-wide loop: int32 sums of the pairs (x, x + 4), lanes
        // [b1 b2 b1 b2] of columns (0, 4), (1, 5) and (2, 6), (3, 7)
        for (int g = 0; g + 8 <= kWin; g += 8) {
          for (int k = 0; k < 4; k++) {
            const int a = g + k, b = g + k + 4;
            float* q = k < 2 ? qb0 : qb1;
            const int lane = 2 * (k & 1);
            q[lane] += (float)(diff[a] * Ix[y][a] + diff[b] * Ix[y][b]);
            q[lane + 1] += (float)(diff[a] * Iy[y][a] + diff[b] * Iy[y][b]);
          }
        }
        for (int x = kWin - kWin % 8; x < kWin; x++) {
          ib1 += (float)(diff[x] * Ix[y][x]);
          ib2 += (float)(diff[x] * Iy[y][x]);
        }
      }
      ib1 += (qb0[0] + qb1[0]) + (qb0[2] + qb1[2]);
      ib2 += (qb0[1] + qb1[1]) + (qb0[3] + qb1[3]);
      const float b1 = ib1 * kFltScale, b2 = ib2 * kFltScale;
      const float dx = (A12 * b2 - A22 * b1) * D;
      const float dy = (A12 * b1 - A11 * b2) * D;
      next_x += dx;
      next_y += dy;
      nx = next_x + half;
      ny = next_y + half;
      if ((double)dx * dx + (double)dy * dy <= eps) break;
      if (j > 0 && std::fabs(dx + prev_dx) < 0.01 && std::fabs(dy + prev_dy) < 0.01) {
        nx -= dx * 0.5f;
        ny -= dy * 0.5f;
        break;
      }
      prev_dx = dx;
      prev_dy = dy;
    }
  }
};

// buildOpticalFlowPyramid without derivatives: returns the top level.
int build_pyramid(const uint8_t* img, int rows, int cols, std::vector<Image>& pyr) {
  pyr.assign(kMaxLevel + 1, Image());
  pyr[0].init(rows, cols);
  for (int y = 0; y < rows; y++)
    for (int x = 0; x < cols; x++) *pyr[0].at(y, x) = img[(size_t)y * cols + x];
  pad_reflect101(pyr[0]);
  int w = cols, h = rows;
  for (int level = 0; level <= kMaxLevel; level++) {
    if (level != 0) pyr_down(pyr[level - 1], pyr[level]);
    w = (w + 1) / 2;
    h = (h + 1) / 2;
    if (w <= kWin || h <= kWin) {
      pyr.resize(level + 1);
      return level;
    }
  }
  return kMaxLevel;
}

}  // namespace

extern "C" {

int pv_lk(const uint8_t* prev, const uint8_t* next, int rows, int cols, const float* pts,
          long n, float* out, uint8_t* status) {
  if (rows <= kWin || cols <= kWin) return -1;
  std::vector<Image> pyr_i, pyr_j;
  int max_level = 0;
  std::thread other([&] { build_pyramid(prev, rows, cols, pyr_i); });
  max_level = build_pyramid(next, rows, cols, pyr_j);
  other.join();
  for (long i = 0; i < n; i++) status[i] = 1;
  // the points are independent: contiguous blocks of them on threads
  const long n_threads =
      std::max(1L, std::min<long>((long)std::thread::hardware_concurrency(), std::min(8L, n / 64)));
  Deriv deriv;
  for (int level = max_level; level >= 0; level--) {
    sharr_deriv(pyr_i[(size_t)level], deriv);
    const Tracker tr{pyr_i[(size_t)level], deriv, pyr_j[(size_t)level], level};
    auto run = [&](long lo, long hi) {
      for (long i = lo; i < hi; i++) {
        float& nx = out[2 * i];
        float& ny = out[2 * i + 1];
        if (level == max_level) {
          nx = pts[2 * i] * (float)(1. / (1 << level));
          ny = pts[2 * i + 1] * (float)(1. / (1 << level));
        } else {
          nx *= 2.f;
          ny *= 2.f;
        }
        tr.track(pts[2 * i], pts[2 * i + 1], nx, ny, status[i]);
      }
    };
    std::vector<std::thread> workers;
    for (long t = 1; t < n_threads; t++)
      workers.emplace_back(run, n * t / n_threads, n * (t + 1) / n_threads);
    run(0, n / n_threads);
    for (auto& w : workers) w.join();
  }
  return max_level;
}

}  // extern "C"
