// SIFT keypoints and descriptors with the arithmetic of OpenCV's
// SIFT_create(nfeatures).detectAndCompute(gray, mask) (OpenCV 5.0:
// modules/features/src/sift.dispatch.cpp and sift.simd.hpp) at cv2's other
// defaults: 3 layers per octave, contrast threshold 0.04, edge threshold
// 10, sigma 1.6, no precise upscale, float descriptors. One 8-bit channel.
//
//   * base: the image as float, upscaled 2x (INTER_LINEAR: weights 3/4
//     and 1/4, exact on 8-bit input), blurred by sqrt(1.6^2 - 1);
//   * Gaussian pyramid: octaves while round(log2(min side of the base)
//     - 2) + 1 allows, each of 6 layers blurred from the one before; the
//     next octave starts from layer 3 halved (INTER_NEAREST). Each blur
//     is cv::GaussianBlur on float: an 11- to 27-tap kernel (embedded
//     below as getGaussianKernel gives it), rows then columns,
//     reflect-101;
//   * extrema of the 5 DoG layers of an octave against their 26
//     neighbours, refined by adjustLocalExtrema (3x3 Hessian solved by
//     Cramer's rule as Matx33f::solve does), the contrast and edge tests,
//     then the 36-bin orientation histogram with its peaks at 80 %;
//   * the keypoint list: sorted and deduplicated, cut to nfeatures by
//     std::nth_element on the response (the ties at the cut stay), halved
//     to the input's scale, then the mask;
//   * descriptors: the 4 x 4 x 8 trilinear histogram, clipped at 0.2 of
//     its norm, scaled by 512 / norm and rounded half to even.
//
// The float results are OpenCV's bit for bit, so the sums and fused
// multiply-adds follow OpenCV's x86 AVX2 build: the loops OpenCV writes
// with 8-lane SIMD registers use the same fused steps and lane order here
// (the blur's fma chains, the histogram updates, the norm's 8 lanes
// reduced pairwise), and the scalar code that GCC compiles with FMA
// contraction in that build (the 3x3 solve, the contrast, the edge test,
// the parabolic peak, the descriptor's rotation and the tails of the
// vector loops) has its fused steps written out with std::fma. This file
// must be built without contraction (-ffp-contract=off). cv::hal's exp,
// fastAtan2 and magnitude are OpenCV's own (the table exp, the 7th-order
// atan polynomial). The target is cv2 5.0 as pip ships it for x86-64
// (GCC 14), on its AVX2 path with IPP off. By default that cv2 takes IPP's
// exp and magnitude and, on a CPU with AVX-512, its AVX512-SKX SIFT code,
// which move some angles by a few ulps and, rarely, a descriptor value
// at a rounding half by one level (tests/test_torch_sift_host.py says how
// far). Other OpenCV builds, or its SSE path, sum otherwise.
//
// Plain C interface for ctypes:
//   pv_sift_batch(frames, n, rows, cols, mask, nfeatures, threads) runs n
//     frames (uint8 rows x cols each, the mask uint8 rows x cols or null)
//     on up to `threads` threads, one frame per thread, and returns a
//     handle; pv_sift_count(h, i) and pv_sift_fetch(h, i, kp, octave,
//     desc) give frame i's keypoints (x, y, size, angle, response), their
//     packed octave and their 128 descriptor values in cv2's order;
//     pv_sift_free(h) releases it. The result does not depend on the
//     number of threads.
//   pv_sift_blur, pv_sift_exp, pv_sift_atan, pv_sift_magnitude: the
//     building blocks on their own, for checking against cv2.

#include <algorithm>
#include <atomic>
#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kLayers = 3;                 // nOctaveLayers
constexpr double kContrast = 0.04;         // contrastThreshold
constexpr double kEdge = 10.;              // edgeThreshold
constexpr double kSigma = 1.6;             // sigma
constexpr int kBorder = 5;                 // SIFT_IMG_BORDER
constexpr int kMaxInterp = 5;              // SIFT_MAX_INTERP_STEPS
constexpr int kOriBins = 36;               // SIFT_ORI_HIST_BINS
constexpr float kOriSigFctr = 1.5f;        // SIFT_ORI_SIG_FCTR
constexpr float kOriRadius = 3 * kOriSigFctr;
constexpr float kOriPeakRatio = 0.8f;
constexpr int kDescWidth = 4;              // SIFT_DESCR_WIDTH
constexpr int kDescBins = 8;               // SIFT_DESCR_HIST_BINS
constexpr int kDescLen = kDescWidth * kDescWidth * kDescBins;
constexpr float kDescSclFctr = 3.f;
constexpr float kDescMagThr = 0.2f;
constexpr float kIntDescFctr = 512.f;
constexpr int kLanes = 8;                  // AVX2 float lanes

inline float fma_(float a, float b, float c) { return std::fma(a, b, c); }

struct Img {
  int rows = 0, cols = 0;
  std::vector<float> px;
  void create(int r, int c) {
    rows = r;
    cols = c;
    px.assign((size_t)r * c, 0.f);
  }
  float* row(int r) { return px.data() + (size_t)r * cols; }
  const float* row(int r) const { return px.data() + (size_t)r * cols; }
  float at(int r, int c) const { return px[(size_t)r * cols + c]; }
};

int reflect101(int p, int len) {
  if (len == 1) return 0;
  while (p < 0 || p >= len) p = p < 0 ? -p : 2 * len - 2 - p;
  return p;
}

// ---------------------------------------------------------------- blur --
// getGaussianKernel(ksize, sigma, CV_32F), centre and one side, for the
// base blur (sigma = sqrtf(1.6f^2 - 1)) and layers 1-5 of an octave.
struct Kernel {
  int ksize;
  float half[14];   // half[0] is the outermost tap, half[ksize / 2] the centre
};

const Kernel kKernels[6] = {
    {11, {0x1.bbb2a4p-14f, 0x1.f04b7p-10f, 0x1.2469fap-6f, 0x1.6b0372p-4f, 0x1.dac53p-3f,
          0x1.4713ccp-2f}},
    {11, {0x1.4edfacp-14f, 0x1.a1407ap-10f, 0x1.0b5ddep-6f, 0x1.606d0ep-4f, 0x1.ddcdfcp-3f,
          0x1.4d2364p-2f}},
    {13, {0x1.1f90cap-13f, 0x1.68008p-10f, 0x1.287054p-7f, 0x1.411cd4p-5f, 0x1.c995cap-4f,
          0x1.ace486p-3f, 0x1.086a76p-2f}},
    {17, {0x1.719152p-15f, 0x1.4e5a92p-12f, 0x1.d0a8dcp-10f, 0x1.eff6b8p-8f, 0x1.9695cp-6f,
          0x1.ffffbap-5f, 0x1.ef3104p-4f, 0x1.6fd80cp-3f, 0x1.a3bafcp-3f}},
    {21, {0x1.4ee0b6p-15f, 0x1.9634a6p-13f, 0x1.a141c6p-11f, 0x1.6af5d4p-9f, 0x1.0b5eb2p-7f,
          0x1.4d9348p-6f, 0x1.606e26p-5f, 0x1.3b51b8p-4f, 0x1.ddcf78p-4f, 0x1.3291cp-3f,
          0x1.4d246cp-3f}},
    {27, {0x1.36a04cp-16f, 0x1.1f903ep-14f, 0x1.df7c2p-13f, 0x1.67ffd2p-11f, 0x1.e6d384p-10f,
          0x1.286fc4p-8f, 0x1.451d18p-7f, 0x1.411c3ap-6f, 0x1.1d9ebap-5f, 0x1.c994eep-5f,
          0x1.4a176ap-4f, 0x1.ace3b6p-4f, 0x1.f5d90ep-4f, 0x1.0869f6p-3f}},
};

// cv::GaussianBlur on float (sepFilter2D): each output of the row pass is
// a chain over the taps from the left; each output of the column pass
// starts from centre * k[0] and adds (below + above) * k[j] for j = 1 ..
// ksize / 2. The steps fuse where OpenCV's AVX2 build fuses them (which
// depends on the column: see the loop bounds). Borders reflect-101.
void gaussian_blur(const Img& src, Img& dst, const Kernel& kern) {
  const int rows = src.rows, cols = src.cols, r2 = kern.ksize / 2, ks = kern.ksize;
  float k[27];
  for (int i = 0; i <= r2; i++) k[i] = k[ks - 1 - i] = kern.half[i];
  Img tmp;
  tmp.create(rows, cols);
  std::vector<float> ext((size_t)cols + 2 * r2);
  // the 8-lane loop and the 4-wide unrolled loop after it fuse; the last
  // cols % 4 outputs sum rounded products
  const int fused_end = cols - cols % 8 + (cols % 8) / 4 * 4;
  for (int y = 0; y < rows; y++) {
    const float* s = src.row(y);
    for (int x = -r2; x < cols + r2; x++) ext[(size_t)(x + r2)] = s[reflect101(x, cols)];
    float* t = tmp.row(y);
    for (int x = 0; x < cols; x++) t[x] = ext[(size_t)x] * k[0];
    for (int j = 1; j < ks; j++) {
      const float* e = ext.data() + j;
      const float kj = k[j];
      for (int x = 0; x < fused_end; x++) t[x] = fma_(e[x], kj, t[x]);
      for (int x = fused_end; x < cols; x++) t[x] += e[x] * kj;
    }
  }
  dst.create(rows, cols);
  const int vec_end = cols - cols % 8;   // past it the column pass does not fuse
  for (int y = 0; y < rows; y++) {
    float* d = dst.row(y);
    const float* c = tmp.row(y);
    for (int x = 0; x < cols; x++) d[x] = c[x] * k[r2];
    for (int j = 1; j <= r2; j++) {
      const float* a = tmp.row(reflect101(y + j, rows));
      const float* b = tmp.row(reflect101(y - j, rows));
      const float kj = k[r2 + j];
      for (int x = 0; x < vec_end; x++) d[x] = fma_(a[x] + b[x], kj, d[x]);
      for (int x = vec_end; x < cols; x++) d[x] += (a[x] + b[x]) * kj;
    }
  }
}

// cv::resize(u8 image as float, 2x size, INTER_LINEAR). Every value is a
// multiple of 1/16 below 256, so the order of the sums does not matter.
void upscale2x(const uint8_t* img, int rows, int cols, Img& dst) {
  auto taps = [](int d, int len, int& i0, int& i1, float& w1) {
    const float f = (d + 0.5f) * 0.5f - 0.5f;
    int s = (int)std::floor(f);
    float fx = f - (float)s;
    if (s < 0) { s = 0; fx = 0.f; }
    if (s >= len - 1) { s = len - 1; fx = 0.f; }
    i0 = s;
    i1 = std::min(s + 1, len - 1);
    w1 = fx;
  };
  Img h;
  h.create(rows, cols * 2);
  for (int x = 0; x < cols * 2; x++) {
    int i0, i1;
    float w1;
    taps(x, cols, i0, i1, w1);
    for (int y = 0; y < rows; y++) {
      const uint8_t* r = img + (size_t)y * cols;
      h.row(y)[x] = (float)r[i0] * (1.f - w1) + (float)r[i1] * w1;
    }
  }
  dst.create(rows * 2, cols * 2);
  for (int y = 0; y < rows * 2; y++) {
    int i0, i1;
    float w1;
    taps(y, rows, i0, i1, w1);
    const float* a = h.row(i0);
    const float* b = h.row(i1);
    float* d = dst.row(y);
    for (int x = 0; x < cols * 2; x++) d[x] = a[x] * (1.f - w1) + b[x] * w1;
  }
}

// cv::resize(src, Size(cols / 2, rows / 2), INTER_NEAREST).
void downscale_nearest(const Img& src, Img& dst) {
  const int rows = src.rows / 2, cols = src.cols / 2;
  dst.create(rows, cols);
  const double ifx = 1. / ((double)cols / src.cols), ify = 1. / ((double)rows / src.rows);
  std::vector<int> xs((size_t)cols);
  for (int x = 0; x < cols; x++) xs[(size_t)x] = std::min((int)std::floor(x * ifx), src.cols - 1);
  for (int y = 0; y < rows; y++) {
    const float* s = src.row(std::min((int)std::floor(y * ify), src.rows - 1));
    float* d = dst.row(y);
    for (int x = 0; x < cols; x++) d[x] = s[xs[(size_t)x]];
  }
}

// ------------------------------------------------------------ cv::hal --
// cv::hal::exp32f: 2^(x log2 e) through a 64-entry table (OpenCV's expTab,
// 2^(j / 64) x A0 rounded to float) and a 4th-order polynomial. 16 values
// per step in two 8-lane registers; in place, the last len % 16 values take
// the scalar code, which GCC contracts to the same fused steps.
const float kExpTab[64] = {
    0x1.3ce0f4p-7f, 0x1.40544ep-7f, 0x1.43d146p-7f, 0x1.4757f6p-7f,
    0x1.4ae87cp-7f, 0x1.4e82f2p-7f, 0x1.522772p-7f, 0x1.55d61ap-7f,
    0x1.598f06p-7f, 0x1.5d5254p-7f, 0x1.61201ep-7f, 0x1.64f882p-7f,
    0x1.68db9ep-7f, 0x1.6cc992p-7f, 0x1.70c278p-7f, 0x1.74c672p-7f,
    0x1.78d59ep-7f, 0x1.7cf01ap-7f, 0x1.811606p-7f, 0x1.854782p-7f,
    0x1.8984bp-7f, 0x1.8dcdaep-7f, 0x1.9222ap-7f, 0x1.9683a4p-7f,
    0x1.9af0dcp-7f, 0x1.9f6a6cp-7f, 0x1.a3f076p-7f, 0x1.a8831cp-7f,
    0x1.ad228p-7f, 0x1.b1cec8p-7f, 0x1.b68816p-7f, 0x1.bb4e9p-7f,
    0x1.c0225ap-7f, 0x1.c50398p-7f, 0x1.c9f272p-7f, 0x1.ceef0cp-7f,
    0x1.d3f98cp-7f, 0x1.d91218p-7f, 0x1.de38dcp-7f, 0x1.e36dfap-7f,
    0x1.e8b19cp-7f, 0x1.ee03ecp-7f, 0x1.f36512p-7f, 0x1.f8d536p-7f,
    0x1.fe5482p-7f, 0x1.01f192p-6f, 0x1.04c0ap-6f, 0x1.079784p-6f,
    0x1.0a7652p-6f, 0x1.0d5d2p-6f, 0x1.104c04p-6f, 0x1.134316p-6f,
    0x1.16426cp-6f, 0x1.194a1ep-6f, 0x1.1c5a42p-6f, 0x1.1f72eep-6f,
    0x1.22943ep-6f, 0x1.25be46p-6f, 0x1.28f122p-6f, 0x1.2c2ce8p-6f,
    0x1.2f71bp-6f, 0x1.32bf96p-6f, 0x1.3616b2p-6f, 0x1.39771ep-6f,
};

void exp32f(const float* src, float* dst, int n) {
  constexpr double A0 = .9670371139572337719125840413672004409288e-2;
  const float A4 = (float)(1.000000000000002438532970795181890933776 / A0);
  const float A3 = (float)(.6931471805521448196800669615864773144641 / A0);
  const float A2 = (float)(.2402265109513301490103372422686535526573 / A0);
  const float A1 = (float)(.5550339366753125211915322047004666939128e-1 / A0);
  constexpr double prescale = 1.4426950408889634073599246810019 * (1 << 6);
  constexpr double postscale = 1. / (1 << 6);
  constexpr double max_val = 3000. * (1 << 6);
  const float minval = (float)(-max_val / prescale), maxval = (float)(max_val / prescale);
  for (int i = 0; i < n; i++) {
    float x0 = std::min(std::max(src[i], minval), maxval);
    x0 *= (float)prescale;
    const int xi = (int)std::nearbyint(x0);
    x0 = (x0 - (float)xi) * (float)postscale;
    int t = (xi >> 6) + 127;
    t = !(t & ~255) ? t : t < 0 ? 0 : 255;
    uint32_t bits = (uint32_t)t << 23;
    float scale;
    std::memcpy(&scale, &bits, 4);
    const float y = scale * kExpTab[xi & 63];
    const float p = fma_(fma_(fma_(x0 + A1, x0, A2), x0, A3), x0, A4);
    dst[i] = p * y;
  }
}

constexpr float kAtanP1 = 0.9997878412794807f * (float)(180 / M_PI);
constexpr float kAtanP3 = -0.3258083974640975f * (float)(180 / M_PI);
constexpr float kAtanP5 = 0.1555786518463281f * (float)(180 / M_PI);
constexpr float kAtanP7 = -0.04432655554792128f * (float)(180 / M_PI);

// cv::hal::fastAtan2 in degrees: 16 values per step in two 8-lane
// registers, the last step overlapping the one before; fewer than 16
// values take the scalar code, where GCC fuses 90 - poly * c.
void fast_atan2(const float* Y, const float* X, float* out, int n) {
  const bool vec = n >= 2 * kLanes;
  for (int i = 0; i < n; i++) {
    const float x = X[i], y = Y[i];
    const float ax = std::abs(x), ay = std::abs(y);
    const float c = std::min(ax, ay) / (std::max(ax, ay) + (float)DBL_EPSILON);
    const float cc = c * c;
    const float poly = fma_(fma_(fma_(cc, kAtanP7, kAtanP5), cc, kAtanP3), cc, kAtanP1);
    float a;
    if (vec) {
      a = poly * c;
      if (!(ax >= ay)) a = 90.f - a;
    } else {
      a = ax >= ay ? poly * c : fma_(-poly, c, 90.f);
    }
    if (x < 0) a = 180.f - a;
    if (y < 0) a = 360.f - a;
    out[i] = a;
  }
}

// cv::hal::magnitude32f: sqrt(fma(x, x, y * y)) in every lane and tail.
void magnitude(const float* X, const float* Y, float* out, int n) {
  for (int i = 0; i < n; i++) out[i] = std::sqrt(fma_(X[i], X[i], Y[i] * Y[i]));
}

// ------------------------------------------------------------ pyramid --
struct Pyramid {
  int octaves = 0;
  std::vector<Img> gauss;   // octaves x (kLayers + 3)
  std::vector<Img> dog;     // octaves x (kLayers + 2)
};

void build_pyramid(const uint8_t* img, int rows, int cols, Pyramid& p) {
  Img up;
  upscale2x(img, rows, cols, up);
  const int min_side = std::min(up.cols, up.rows);
  p.octaves = std::max(0, (int)std::lrint(std::log((double)min_side) / std::log(2.) - 2) + 1);
  p.gauss.assign((size_t)p.octaves * (kLayers + 3), Img());
  if (p.octaves == 0) return;   // cv2 finds nothing in an image this small
  gaussian_blur(up, p.gauss[0], kKernels[0]);
  up = Img();
  for (int o = 0; o < p.octaves; o++)
    for (int i = 0; i < kLayers + 3; i++) {
      Img& dst = p.gauss[(size_t)(o * (kLayers + 3) + i)];
      if (o == 0 && i == 0) continue;
      if (i == 0)
        downscale_nearest(p.gauss[(size_t)((o - 1) * (kLayers + 3) + kLayers)], dst);
      else
        gaussian_blur(p.gauss[(size_t)(o * (kLayers + 3) + i - 1)], dst, kKernels[i]);
    }
  p.dog.assign((size_t)p.octaves * (kLayers + 2), Img());
  for (int o = 0; o < p.octaves; o++)
    for (int i = 0; i < kLayers + 2; i++) {
      const Img& a = p.gauss[(size_t)(o * (kLayers + 3) + i)];
      const Img& b = p.gauss[(size_t)(o * (kLayers + 3) + i + 1)];
      Img& d = p.dog[(size_t)(o * (kLayers + 2) + i)];
      d.create(a.rows, a.cols);
      for (size_t k = 0; k < a.px.size(); k++) d.px[k] = b.px[k] - a.px[k];
    }
}

// ----------------------------------------------------------- keypoints --
struct KeyPoint {
  float x, y, size, angle, response;
  int octave, class_id;
};

// adjustLocalExtrema. The 3x3 solve is Matx33f::solve's Cramer's rule
// with GCC's contraction of it: each 2x2 minor a*b - c*d fuses the first
// product, and the shared minors are computed once.
bool adjust_local_extrema(const std::vector<Img>& dog, KeyPoint& kpt, int octv, int& layer,
                          int& r, int& c) {
  const float img_scale = 1.f / 255;
  const float deriv_scale = img_scale * 0.5f;
  const float second_deriv_scale = img_scale;
  const float cross_deriv_scale = img_scale * 0.25f;
  const float contrast = (float)kContrast, edge = (float)kEdge, sigma = (float)kSigma;
  float xi = 0, xr = 0, xc = 0;
  float dx = 0, dy = 0, ds = 0, dxx = 0, dyy = 0, dxy = 0;
  int i = 0;
  for (; i < kMaxInterp; i++) {
    const int idx = octv * (kLayers + 2) + layer;
    const Img& img = dog[(size_t)idx];
    const Img& prev = dog[(size_t)idx - 1];
    const Img& next = dog[(size_t)idx + 1];
    dx = (img.at(r, c + 1) - img.at(r, c - 1)) * deriv_scale;
    dy = (img.at(r + 1, c) - img.at(r - 1, c)) * deriv_scale;
    ds = (next.at(r, c) - prev.at(r, c)) * deriv_scale;
    const float v = img.at(r, c);
    dxx = fma_(-v, 2.f, img.at(r, c + 1) + img.at(r, c - 1)) * second_deriv_scale;
    dyy = fma_(-v, 2.f, img.at(r + 1, c) + img.at(r - 1, c)) * second_deriv_scale;
    const float dss = fma_(-v, 2.f, next.at(r, c) + prev.at(r, c)) * second_deriv_scale;
    dxy = (img.at(r + 1, c + 1) - img.at(r + 1, c - 1) - img.at(r - 1, c + 1) +
           img.at(r - 1, c - 1)) * cross_deriv_scale;
    const float dxs = (next.at(r, c + 1) - next.at(r, c - 1) - prev.at(r, c + 1) +
                       prev.at(r, c - 1)) * cross_deriv_scale;
    const float dys = (next.at(r + 1, c) - next.at(r - 1, c) - prev.at(r + 1, c) +
                       prev.at(r - 1, c)) * cross_deriv_scale;
    // H = [dxx dxy dxs; dxy dyy dys; dxs dys dss], b = (dx, dy, ds)
    const float m0 = fma_(dyy, dss, -(dys * dys));
    const float m1 = fma_(dss, dxy, -(dxs * dys));
    const float m2 = fma_(dxy, dys, -(dyy * dxs));
    const float det = fma_(dxs, m2, fma_(dxx, m0, -(dxy * m1)));
    float X0 = 0, X1 = 0, X2 = 0;
    if (det != 0) {
      const float d = 1 / det;
      const float b2a11 = ds * dyy;
      const float n1 = fma_(dy, dss, -(ds * dys));
      const float n2 = fma_(dy, dys, -b2a11);
      const float n3 = fma_(ds, dxy, -(dy * dxs));
      const float n4 = fma_(-dy, dys, b2a11);
      X0 = d * fma_(dxs, n2, fma_(dx, m0, -(dxy * n1)));
      X1 = d * fma_(dxs, n3, fma_(dxx, n1, -(dx * m1)));
      X2 = d * fma_(dx, m2, fma_(dxx, n4, -(dxy * n3)));
    }
    xi = -X2;
    xr = -X1;
    xc = -X0;
    if (std::abs(xi) < 0.5f && std::abs(xr) < 0.5f && std::abs(xc) < 0.5f) break;
    if (std::abs(xi) > (float)(INT_MAX / 3) || std::abs(xr) > (float)(INT_MAX / 3) ||
        std::abs(xc) > (float)(INT_MAX / 3))
      return false;
    c += (int)std::nearbyint(xc);
    r += (int)std::nearbyint(xr);
    layer += (int)std::nearbyint(xi);
    if (layer < 1 || layer > kLayers || c < kBorder || c >= img.cols - kBorder || r < kBorder ||
        r >= img.rows - kBorder)
      return false;
  }
  if (i >= kMaxInterp) return false;
  const Img& img = dog[(size_t)(octv * (kLayers + 2) + layer)];
  // the dot product: the first two products in one 2-lane multiply
  const float t = fma_(ds, xi, dx * xc + dy * xr);
  const float contr = fma_(img.at(r, c), img_scale, t * 0.5f);
  if (std::abs(contr) * kLayers < contrast) return false;
  const float tr = dxx + dyy;
  const float det = fma_(dxx, dyy, -(dxy * dxy));
  if (det <= 0 || tr * tr * edge >= (edge + 1) * (edge + 1) * det) return false;
  const float scale = (float)(1 << octv);
  kpt.x = ((float)c + xc) * scale;
  kpt.y = ((float)r + xr) * scale;
  kpt.octave = octv + (layer << 8) + ((int)std::nearbyint(((double)xi + 0.5) * 255) << 16);
  kpt.size = sigma * powf(2.f, ((float)layer + xi) / kLayers) * scale * 2;
  kpt.response = std::abs(contr);
  kpt.angle = -1;
  kpt.class_id = -1;
  return true;
}

// calcOrientationHist: returns the histogram's largest bin.
float orientation_hist(const Img& img, int px, int py, int radius, float sigma, float* hist) {
  constexpr int n = kOriBins;
  const size_t len0 = (size_t)(radius * 2 + 1) * (radius * 2 + 1);
  static thread_local std::vector<float> buf;
  if (buf.size() < 4 * len0) buf.resize(4 * len0);
  float* X = buf.data();
  float* Y = X + len0;
  float* Ori = Y + len0;
  float* W = Ori + len0;
  float temphist_buf[n + 4];
  float* temphist = temphist_buf + 2;
  const float expf_scale = -1.f / (2.f * sigma * sigma);
  for (int i = 0; i < n; i++) temphist[i] = 0.f;
  int k = 0;
  for (int i = -radius; i <= radius; i++) {
    const int y = py + i;
    if (y <= 0 || y >= img.rows - 1) continue;
    for (int j = -radius; j <= radius; j++) {
      const int x = px + j;
      if (x <= 0 || x >= img.cols - 1) continue;
      X[k] = img.at(y, x + 1) - img.at(y, x - 1);
      Y[k] = img.at(y - 1, x) - img.at(y + 1, x);
      W[k] = (float)(i * i + j * j) * expf_scale;
      k++;
    }
  }
  const int len = k;
  exp32f(W, W, len);
  fast_atan2(Y, X, Ori, len);
  magnitude(X, Y, X, len);
  const float* Mag = X;
  const float nd360 = n / 360.f;
  const int vec_end = len - len % kLanes;
  for (k = 0; k < len; k++) {
    int bin = (int)std::nearbyint(nd360 * Ori[k]);
    if (bin >= n) bin -= n;
    if (bin < 0) bin += n;
    if (k < vec_end)
      temphist[bin] += W[k] * Mag[k];
    else
      temphist[bin] = fma_(W[k], Mag[k], temphist[bin]);
  }
  temphist[-1] = temphist[n - 1];
  temphist[-2] = temphist[n - 2];
  temphist[n] = temphist[0];
  temphist[n + 1] = temphist[1];
  int i = 0;
  for (; i < n - n % kLanes; i++)   // the 8-lane loop
    hist[i] = fma_(temphist[i - 2] + temphist[i + 2], 1.f / 16.f,
                   fma_(temphist[i - 1] + temphist[i + 1], 4.f / 16.f, temphist[i] * (6.f / 16.f)));
  for (; i < n; i++)   // the tail as GCC contracts it
    hist[i] = fma_(temphist[i], 6.f / 16.f,
                   fma_(temphist[i - 2] + temphist[i + 2], 1.f / 16.f,
                        (temphist[i - 1] + temphist[i + 1]) * (4.f / 16.f)));
  float maxval = hist[0];
  for (i = 1; i < n; i++) maxval = std::max(maxval, hist[i]);
  return maxval;
}

void find_extrema(const Pyramid& p, std::vector<KeyPoint>& out) {
  const float threshold = (float)(int)std::floor(0.5 * kContrast / kLayers * 255);
  float hist[kOriBins];
  for (int o = 0; o < p.octaves; o++)
    for (int i = 1; i <= kLayers; i++) {
      const int idx = o * (kLayers + 2) + i;
      const Img& img = p.dog[(size_t)idx];
      const Img& prev = p.dog[(size_t)idx - 1];
      const Img& next = p.dog[(size_t)idx + 1];
      const int rows = img.rows, cols = img.cols, step = cols;
      for (int r = kBorder; r < rows - kBorder; r++) {
        const float* cur = img.row(r);
        const float* pre = prev.row(r);
        const float* nxt = next.row(r);
        for (int c = kBorder; c < cols - kBorder; c++) {
          const float val = cur[c];
          if (!(std::abs(val) > threshold)) continue;
          const int off[8] = {-step - 1, -step, -step + 1, -1, 1, step - 1, step, step + 1};
          bool ext = true;
          if (val > 0) {
            for (int q = 0; q < 8 && ext; q++) ext = val >= cur[c + off[q]];
            for (int q = 0; q < 8 && ext; q++) ext = val >= pre[c + off[q]];
            for (int q = 0; q < 8 && ext; q++) ext = val >= nxt[c + off[q]];
            ext = ext && val >= pre[c] && val >= nxt[c];
          } else {
            for (int q = 0; q < 8 && ext; q++) ext = val <= cur[c + off[q]];
            for (int q = 0; q < 8 && ext; q++) ext = val <= pre[c + off[q]];
            for (int q = 0; q < 8 && ext; q++) ext = val <= nxt[c + off[q]];
            ext = ext && val <= pre[c] && val <= nxt[c];
          }
          if (!ext) continue;
          int r1 = r, c1 = c, layer = i;
          KeyPoint kpt;
          if (!adjust_local_extrema(p.dog, kpt, o, layer, r1, c1)) continue;
          const float scl_octv = kpt.size * 0.5f / (float)(1 << o);
          const float omax = orientation_hist(
              p.gauss[(size_t)(o * (kLayers + 3) + layer)], c1, r1,
              (int)std::nearbyint(kOriRadius * scl_octv), kOriSigFctr * scl_octv, hist);
          const float mag_thr = omax * kOriPeakRatio;
          constexpr int n = kOriBins;
          for (int j = 0; j < n; j++) {
            const int l = j > 0 ? j - 1 : n - 1;
            const int r2 = j < n - 1 ? j + 1 : 0;
            if (hist[j] > hist[l] && hist[j] > hist[r2] && hist[j] >= mag_thr) {
              float bin = (float)j + 0.5f * (hist[l] - hist[r2]) /
                                         (fma_(-hist[j], 2.f, hist[l]) + hist[r2]);
              bin = bin < 0 ? n + bin : bin >= n ? bin - n : bin;
              kpt.angle = fma_(-(360.f / n), bin, 360.f);
              if (std::abs(kpt.angle - 360.f) < FLT_EPSILON) kpt.angle = 0.f;
              out.push_back(kpt);
            }
          }
        }
      }
    }
}

// KeyPointsFilter::removeDuplicatedSorted
void remove_duplicated_sorted(std::vector<KeyPoint>& kps) {
  const int n = (int)kps.size();
  if (n < 2) return;
  std::sort(kps.begin(), kps.end(), [](const KeyPoint& a, const KeyPoint& b) {
    if (a.x != b.x) return a.x < b.x;
    if (a.y != b.y) return a.y < b.y;
    if (a.size != b.size) return a.size > b.size;
    if (a.angle != b.angle) return a.angle < b.angle;
    if (a.response != b.response) return a.response > b.response;
    if (a.octave != b.octave) return a.octave > b.octave;
    return a.class_id > b.class_id;
  });
  int i = 0;
  for (int j = 1; j < n; ++j) {
    const KeyPoint& a = kps[(size_t)i];
    const KeyPoint& b = kps[(size_t)j];
    if (a.x != b.x || a.y != b.y || a.size != b.size || a.angle != b.angle) kps[(size_t)++i] = b;
  }
  kps.resize((size_t)i + 1);
}

// KeyPointsFilter::retainBest: libstdc++'s nth_element and partition, as
// OpenCV's build calls them, so that the order and the ties are cv2's.
void retain_best(std::vector<KeyPoint>& kps, int n_points) {
  if (n_points < 0 || kps.size() <= (size_t)n_points) return;
  if (n_points == 0) {
    kps.clear();
    return;
  }
  std::nth_element(kps.begin(), kps.begin() + n_points - 1, kps.end(),
                   [](const KeyPoint& a, const KeyPoint& b) { return a.response > b.response; });
  const float ambiguous = kps[(size_t)n_points - 1].response;
  auto new_end = std::partition(kps.begin() + n_points, kps.end(),
                                [ambiguous](const KeyPoint& k) { return k.response >= ambiguous; });
  kps.resize((size_t)(new_end - kps.begin()));
}

// calcSIFTDescriptor into dst[128].
void descriptor(const Img& img, float ptx, float pty, float ori, float scl, float* dst) {
  constexpr int d = kDescWidth, n = kDescBins;
  const int px = (int)std::nearbyint(ptx), py = (int)std::nearbyint(pty);
  float cos_t = cosf(ori * (float)(M_PI / 180));
  float sin_t = sinf(ori * (float)(M_PI / 180));
  const float bins_per_rad = n / 360.f;
  const float exp_scale = -1.f / (d * d * 0.5f);
  const float hist_width = kDescSclFctr * scl;
  int radius = (int)std::nearbyint(hist_width * 1.4142135623730951f * (d + 1) * 0.5f);
  radius = std::min(radius, (int)std::sqrt((double)img.cols * img.cols +
                                           (double)img.rows * img.rows));
  cos_t /= hist_width;
  sin_t /= hist_width;
  const size_t len0 = (size_t)(radius * 2 + 1) * (radius * 2 + 1);
  constexpr int histlen = (d + 2) * (d + 2) * (n + 2);
  static thread_local std::vector<float> buf;
  if (buf.size() < 6 * len0) buf.resize(6 * len0);
  float* X = buf.data();
  float* Y = X + len0;
  float* Ori = Y + len0;
  float* W = Ori + len0;
  float* RBin = W + len0;
  float* CBin = RBin + len0;
  float hist[histlen];
  float raw[kDescLen];
  for (int i = 0; i < histlen; i++) hist[i] = 0.f;
  int k = 0;
  const int rows = img.rows, cols = img.cols;
  for (int i = -radius; i <= radius; i++)
    for (int j = -radius; j <= radius; j++) {
      const float c_rot = fma_((float)j, cos_t, -((float)i * sin_t));
      const float r_rot = fma_((float)j, sin_t, (float)i * cos_t);
      const float rbin = (r_rot + d / 2) - 0.5f;
      const float cbin = (c_rot + d / 2) - 0.5f;
      const int r = py + i, c = px + j;
      if (rbin > -1 && rbin < d && cbin > -1 && cbin < d && r > 0 && r < rows - 1 && c > 0 &&
          c < cols - 1) {
        X[k] = img.at(r, c + 1) - img.at(r, c - 1);
        Y[k] = img.at(r - 1, c) - img.at(r + 1, c);
        RBin[k] = rbin;
        CBin[k] = cbin;
        W[k] = fma_(c_rot, c_rot, r_rot * r_rot) * exp_scale;
        k++;
      }
    }
  const int len = k;
  fast_atan2(Y, X, Ori, len);
  magnitude(X, Y, Y, len);
  exp32f(W, W, len);
  const float* Mag = Y;
  const int vec_end = len - len % kLanes;
  for (k = 0; k < len; k++) {
    float rbin = RBin[k], cbin = CBin[k];
    float obin = (Ori[k] - ori) * bins_per_rad;
    const float mag = Mag[k] * W[k];
    const int r0 = (int)std::floor(rbin);
    const int c0 = (int)std::floor(cbin);
    int o0 = (int)std::floor(obin);
    rbin -= (float)r0;
    cbin -= (float)c0;
    obin -= (float)o0;
    if (o0 < 0) o0 += n;
    if (o0 >= n) o0 -= n;
    const float v_r1 = mag * rbin, v_r0 = mag - v_r1;
    const float v_rc11 = v_r1 * cbin, v_rc10 = v_r1 - v_rc11;
    const float v_rc01 = v_r0 * cbin, v_rc00 = v_r0 - v_rc01;
    const int idx = ((r0 + 1) * (d + 2) + c0 + 1) * (n + 2) + o0;
    float* h = hist + idx;
    if (k < vec_end) {
      const float v_rco111 = v_rc11 * obin, v_rco110 = v_rc11 - v_rco111;
      const float v_rco101 = v_rc10 * obin, v_rco100 = v_rc10 - v_rco101;
      const float v_rco011 = v_rc01 * obin, v_rco010 = v_rc01 - v_rco011;
      const float v_rco001 = v_rc00 * obin, v_rco000 = v_rc00 - v_rco001;
      h[0] += v_rco000;
      h[1] += v_rco001;
      h[n + 2] += v_rco010;
      h[n + 3] += v_rco011;
      h[(d + 2) * (n + 2)] += v_rco100;
      h[(d + 2) * (n + 2) + 1] += v_rco101;
      h[(d + 3) * (n + 2)] += v_rco110;
      h[(d + 3) * (n + 2) + 1] += v_rco111;
    } else {   // the scalar tail as GCC contracts it
      h[0] += fma_(-v_rc00, obin, v_rc00);
      h[1] = fma_(v_rc00, obin, h[1]);
      h[n + 2] += fma_(-v_rc01, obin, v_rc01);
      h[n + 3] = fma_(v_rc01, obin, h[n + 3]);
      h[(d + 2) * (n + 2)] += fma_(-v_rc10, obin, v_rc10);
      h[(d + 2) * (n + 2) + 1] = fma_(v_rc10, obin, h[(d + 2) * (n + 2) + 1]);
      h[(d + 3) * (n + 2)] += fma_(-v_rc11, obin, v_rc11);
      h[(d + 3) * (n + 2) + 1] = fma_(v_rc11, obin, h[(d + 3) * (n + 2) + 1]);
    }
  }
  for (int i = 0; i < d; i++)
    for (int j = 0; j < d; j++) {
      const int idx = ((i + 1) * (d + 2) + (j + 1)) * (n + 2);
      hist[idx] += hist[idx + n];
      hist[idx + 1] += hist[idx + n + 1];
      for (k = 0; k < n; k++) raw[(i * d + j) * n + k] = hist[idx + k];
    }
  // the norm: 8 lanes of fma, then hadd, hadd, low + high
  float lane[kLanes] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (k = 0; k < kDescLen; k += kLanes)
    for (int q = 0; q < kLanes; q++) lane[q] = fma_(raw[k + q], raw[k + q], lane[q]);
  float nrm2 = ((lane[0] + lane[1]) + (lane[2] + lane[3])) +
               ((lane[4] + lane[5]) + (lane[6] + lane[7]));
  const float thr = std::sqrt(nrm2) * kDescMagThr;
  nrm2 = 0;
  for (int i = 0; i < kDescLen; i++) {   // 8-lane squares, summed in order
    const float val = std::min(raw[i], thr);
    raw[i] = val;
    nrm2 += val * val;
  }
  nrm2 = kIntDescFctr / std::max(std::sqrt(nrm2), FLT_EPSILON);
  for (k = 0; k < kDescLen; k++)
    dst[k] = std::min(std::max((float)(int)std::nearbyint(raw[k] * nrm2), 0.f), 255.f);
}

struct Result {
  std::vector<KeyPoint> kps;
  std::vector<float> desc;
};

void detect_and_compute(const uint8_t* img, int rows, int cols, const uint8_t* mask,
                        int nfeatures, Result& res) {
  constexpr int first_octave = -1;
  res.kps.clear();
  res.desc.clear();
  if (rows < 1 || cols < 1) return;
  Pyramid p;
  build_pyramid(img, rows, cols, p);
  std::vector<KeyPoint>& kps = res.kps;
  kps.clear();
  find_extrema(p, kps);
  p.dog.clear();
  remove_duplicated_sorted(kps);
  if (nfeatures > 0) retain_best(kps, nfeatures);
  for (KeyPoint& k : kps) {
    const float scale = 1.f / (float)(1 << -first_octave);
    k.octave = (k.octave & ~255) | ((k.octave + first_octave) & 255);
    k.x *= scale;
    k.y *= scale;
    k.size *= scale;
  }
  if (mask) {
    auto masked = [&](const KeyPoint& k) {
      return mask[(size_t)(int)(k.y + 0.5f) * cols + (int)(k.x + 0.5f)] == 0;
    };
    kps.erase(std::remove_if(kps.begin(), kps.end(), masked), kps.end());
  }
  res.desc.assign(kps.size() * kDescLen, 0.f);
  for (size_t i = 0; i < kps.size(); i++) {
    const KeyPoint& k = kps[i];
    int octave = k.octave & 255;
    const int layer = (k.octave >> 8) & 255;
    octave = octave < 128 ? octave : (-128 | octave);
    const float scale = octave >= 0 ? 1.f / (1 << octave) : (float)(1 << -octave);
    const float size = k.size * scale;
    const Img& g = p.gauss[(size_t)((octave - first_octave) * (kLayers + 3) + layer)];
    float angle = 360.f - k.angle;
    if (std::abs(angle - 360.f) < FLT_EPSILON) angle = 0.f;
    descriptor(g, k.x * scale, k.y * scale, angle, size * 0.5f, res.desc.data() + i * kDescLen);
  }
}

struct Batch {
  std::vector<Result> frames;
};

}  // namespace

extern "C" {

void* pv_sift_batch(const uint8_t* frames, int n, int rows, int cols, const uint8_t* mask,
                    int nfeatures, int threads) {
  auto* b = new Batch;
  b->frames.resize((size_t)std::max(n, 0));
  std::atomic<int> next{0};
  auto work = [&] {
    for (int i = next++; i < n; i = next++)
      detect_and_compute(frames + (size_t)i * rows * cols, rows, cols, mask, nfeatures,
                         b->frames[(size_t)i]);
  };
  const int t = std::max(1, std::min(threads, n));
  std::vector<std::thread> pool;
  for (int i = 1; i < t; i++) pool.emplace_back(work);
  work();
  for (auto& th : pool) th.join();
  return b;
}

int pv_sift_count(void* h, int i) {
  return (int)static_cast<Batch*>(h)->frames[(size_t)i].kps.size();
}

void pv_sift_fetch(void* h, int i, float* kp, int* octave, float* desc) {
  const Result& r = static_cast<Batch*>(h)->frames[(size_t)i];
  for (size_t k = 0; k < r.kps.size(); k++) {
    const KeyPoint& p = r.kps[k];
    kp[5 * k] = p.x;
    kp[5 * k + 1] = p.y;
    kp[5 * k + 2] = p.size;
    kp[5 * k + 3] = p.angle;
    kp[5 * k + 4] = p.response;
    octave[k] = p.octave;
  }
  std::memcpy(desc, r.desc.data(), r.desc.size() * sizeof(float));
}

void pv_sift_free(void* h) { delete static_cast<Batch*>(h); }

// which = 0: the base blur; 1-5: layer `which` of an octave.
void pv_sift_blur(const float* src, float* dst, int rows, int cols, int which) {
  Img s, d;
  s.create(rows, cols);
  std::memcpy(s.px.data(), src, s.px.size() * sizeof(float));
  gaussian_blur(s, d, kKernels[which]);
  std::memcpy(dst, d.px.data(), d.px.size() * sizeof(float));
}

void pv_sift_exp(const float* x, float* y, int n) { exp32f(x, y, n); }

void pv_sift_atan(const float* y, const float* x, float* out, int n) { fast_atan2(y, x, out, n); }

void pv_sift_magnitude(const float* x, const float* y, float* out, int n) {
  magnitude(x, y, out, n);
}

}  // extern "C"
