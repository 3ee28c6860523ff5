// Sun raster decoding with the bits of cv2.imread (OpenCV 5's
// SunRasterDecoder, grfmt_sunras.cpp):
//   * the 32-byte big-endian header; depths 1, 8, 24 and 32; rows padded
//     to 16 bits;
//   * only RT_OLD (0) and RT_STANDARD (1) are read: OpenCV's header check
//     tests RT_BYTE_ENCODED (2) and RT_FORMAT_RGB (3) against its image
//     type, which is never 2 or 3 there, so cv2.imread gives no image for
//     an RLE or an RGB-ordered file, and neither does this decoder;
//   * colour maps: RMT_NONE with a map length of 0 (1 and 8 bits read
//     through a gray ramp: 0 / 255, or the index), or RMT_EQUAL_RGB with 1
//     to 3 * 2^depth bytes at 1 or 8 bits (three planes R, G, B of
//     length / 3 entries; the others black);
//   * 24 bits as B, G, R; 32 bits as a dropped first byte, then B, G, R;
//   * the gray read: (1868 B + 9617 G + 4899 R + 8192) >> 14 of the
//     colours, through the map's gray for RMT_EQUAL_RGB; 1 and 8-bit files
//     without a map read as 0 there, as in OpenCV (its gray palette is
//     filled from the map only).
// A cut file (every row is read with its padding) gives an error where
// cv2.imread gives no image.
//
// C interface (ctypes), as bmp.cpp: pv_sunras_info(data, n, color, &h, &w,
// err, errlen), pv_sunras_decode(data, n, color, out, err, errlen).

#include <vector>

#include "imgcodecs.h"

namespace {

using namespace imgc;

enum { RT_OLD = 0, RT_STANDARD = 1, RMT_NONE = 0, RMT_EQUAL_RGB = 1 };

struct Sun {
  int width, height, bpp, maptype;
  int64_t offset;
  Pal pal[256];
};

Sun header(Stream& s) {
  Sun r{};
  s.pos = 4;
  r.width = s.dword_be();
  r.height = s.dword_be();
  r.bpp = s.dword_be();
  const int bpp = r.bpp, pal_size = bpp > 0 && bpp <= 8 ? (1 << bpp) * 3 : 0;
  s.pos += 4;
  int encoding = s.dword_be();
  r.maptype = s.dword_be();
  int maplength = s.dword_be();
  if (!(r.width > 0 && r.height > 0 && (bpp == 1 || bpp == 8 || bpp == 24 || bpp == 32) &&
        (encoding == RT_OLD || encoding == RT_STANDARD) &&
        ((r.maptype == RMT_NONE && maplength == 0) ||
         (r.maptype == RMT_EQUAL_RGB && maplength <= pal_size && maplength > 0 && bpp <= 8))))
    fail(REFUSED, "a kind of Sun raster cv2.imread gives no image for");
  if (maplength != 0) {
    uint8_t buf[256 * 3];
    s.bytes(buf, maplength);
    const int n = maplength / 3;
    for (int i = 0; i < n; i++) r.pal[i] = Pal{buf[i + 2 * n], buf[i + n], buf[i], 0};
  } else if (bpp <= 8) {
    for (int i = 0; i < 1 << bpp; i++) {   // FillGrayPalette
      uint8_t v = (uint8_t)(i * 255 / ((1 << bpp) - 1));
      r.pal[i] = Pal{v, v, v, 0};
    }
  }
  r.offset = s.pos;
  return r;
}

void decode(const uint8_t* data, long n, bool color, uint8_t* out) {
  Stream s{data, n};
  Sun r = header(s);
  const int W = r.width, nch = color ? 3 : 1;
  const int src_pitch = ((W * r.bpp + 7) / 8 + 1) & -2;
  uint8_t gray_pal[256] = {0};
  if (!color && r.maptype == RMT_EQUAL_RGB) palette_to_gray(r.pal, gray_pal, 1 << r.bpp);
  std::vector<uint8_t> src((size_t)src_pitch);
  s.pos = r.offset;
  for (int y = 0; y < r.height; y++, out += (int64_t)W * nch) {
    s.bytes(src.data(), src_pitch);
    const uint8_t* p = src.data();
    if (r.bpp == 1) {
      row1(out, p, W, r.pal, gray_pal, nch);
    } else if (r.bpp == 8) {
      row8(out, p, W, r.pal, gray_pal, nch);
    } else {
      uint8_t* o = out;
      const int k = r.bpp / 8;   // 32 bits: a dropped first byte, then B, G, R
      for (p += k - 3; p < src.data() + (int64_t)W * k; p += k)
        if (color) *o++ = p[0], *o++ = p[1], *o++ = p[2];
        else *o++ = gray(p[0], p[1], p[2]);
    }
  }
}

}  // namespace

extern "C" {

int pv_sunras_info(const uint8_t* data, long n, int color, int* h, int* w, char* err,
                   int errlen) {
  (void)color;
  return guarded([&] {
    Stream s{data, n};
    Sun r = header(s);
    *h = r.height;
    *w = r.width;
  }, err, errlen);
}

int pv_sunras_decode(const uint8_t* data, long n, int color, uint8_t* out, char* err,
                     int errlen) {
  return guarded([&] {
    decode(data, n, color != 0, out);
    if (color) {
      Stream s{data, n};
      Sun r = header(s);
      bgr_to_rgb(out, (int64_t)r.height * r.width);
    }
  }, err, errlen);
}

}  // extern "C"
