// BMP decoding with the bits of cv2.imread (OpenCV 5's BmpDecoder,
// grfmt_bmp.cpp), for masks and frames on a machine without cv2:
//   * headers: BITMAPCOREHEADER (OS/2, 12 bytes, 16-bit sizes, 3-byte
//     palette entries, always bottom-up) and the INFO header or any longer
//     one (V4, V5), of which the first 40 bytes are read; the palette, or
//     a 16-bit file's three BI_BITFIELDS masks, follow the header, whatever
//     a V4 or V5 header holds itself;
//   * 1, 4 and 8 bits through a palette of clrUsed entries (2^bpp when 0;
//     the others black); 16 bits as 555 (BI_RGB, or BI_BITFIELDS with the
//     555 masks) or 565 (BI_BITFIELDS with the 565 masks; other masks are
//     refused), each 5 or 6-bit field shifted up with zeros; 24 bits; 32
//     bits as B, G, R and a dropped fourth byte, unless the file is
//     BI_BITFIELDS with a header of 56 bytes or more whose R, G and B masks
//     are all nonzero: then each channel is its masked field scaled to
//     0-255 in float (truncated), and the gray read is
//     (int)(0.299 R + 0.587 G + 0.114 B) in float, as OpenCV 5 reads them;
//   * BI_RLE8 and BI_RLE4 as OpenCV decodes them: a run may not cross the
//     end of a row; escape 0 (end of line) fills the rest of the row with
//     palette entry 0, and in RLE8 escape 2 (delta) fills dx + dy * width
//     pixels in raster order and escape 1 (end of bitmap) the rest of the
//     image; in RLE4 a delta fills dx pixels (dy is read and dropped) and
//     the end of bitmap the rest of its row only, as OpenCV computes the
//     rows and does not use them; an end of line right after an RLE8 run
//     that filled its row is ignored; decoding stops when the last row is
//     full, and a file that ends before gives no image;
//   * bottom-up rows, or top-down ones for a negative height;
//   * the gray read (IMREAD_GRAYSCALE): the palette's gray through
//     icvCvt_BGR2Gray ((1868 B + 9617 G + 4899 R + 8192) >> 14), and that
//     formula on the 16, 24 and 32-bit colours (but for the masks above).
// A cut file (every row is read with its padding) or an unknown kind gives
// an error, where cv2.imread gives no image.
//
// C interface (ctypes): pv_bmp_info(data, n, color, &h, &w, err, errlen)
// reads the header; pv_bmp_decode(data, n, color, out, err, errlen) writes
// h * w bytes, or h * w * 3 in RGB order for a colour read. See
// imgcodecs.h for the return codes.

#include <cmath>
#include <cstdlib>
#include <vector>

#include "imgcodecs.h"

namespace {

using namespace imgc;

enum { BI_RGB = 0, BI_RLE8 = 1, BI_RLE4 = 2, BI_BITFIELDS = 3 };

struct Bmp {
  int width = 0, height = 0, bpp = 0, rle = 0;
  bool bottom_up = true, use_masks = false;
  int64_t offset = 0;
  Pal pal[256] = {};
  uint32_t masks[3] = {};   // R, G, B of a 32-bit BI_BITFIELDS file's header
};

Bmp header(Stream& s) {
  Bmp b;
  bool ok = false;
  s.pos = 10;
  b.offset = s.dword_le();
  int size = s.dword_le();
  if (size <= 0) fail(CORRUPT, "header size out of range");
  if (size >= 36) {
    b.width = s.dword_le();
    b.height = s.dword_le();
    b.bpp = s.dword_le() >> 16;
    b.rle = s.dword_le();
    if (b.rle < 0 || b.rle > BI_BITFIELDS) fail(CORRUPT, "unknown compression");
    s.pos += 12;
    int clrused = s.dword_le();
    if (size >= 56) {   // the V3 and later headers' R, G, B, A masks
      s.pos += 4;
      for (auto& m : b.masks) m = (uint32_t)s.dword_le();
      s.pos = 14 + (int64_t)size;
    } else {
      s.pos += size - 36;
    }
    int bpp = b.bpp, rle = b.rle;
    if (b.width > 0 && b.height != 0 &&
        (((bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32) && rle == BI_RGB) ||
         ((bpp == 16 || bpp == 32) && (rle == BI_RGB || rle == BI_BITFIELDS)) ||
         (bpp == 4 && rle == BI_RLE4) || (bpp == 8 && rle == BI_RLE8))) {
      ok = true;
      if (bpp <= 8) {
        if (clrused < 0 || clrused > 256) fail(CORRUPT, "palette size out of range");
        s.bytes(b.pal, (int64_t)(clrused == 0 ? 1 << bpp : clrused) * 4);
      } else if (bpp == 16 && rle == BI_BITFIELDS) {
        uint32_t r = (uint32_t)s.dword_le(), g = (uint32_t)s.dword_le(),
                 bl = (uint32_t)s.dword_le();
        if (bl == 0x1f && g == 0x3e0 && r == 0x7c00) b.bpp = 15;
        else if (!(bl == 0x1f && g == 0x7e0 && r == 0xf800)) ok = false;
      } else if (bpp == 16) {
        b.bpp = 15;
      } else if (bpp == 32 && rle == BI_BITFIELDS) {
        b.use_masks = b.masks[0] && b.masks[1] && b.masks[2];
      }
    }
  } else if (size == 12) {
    b.width = s.word_le();
    b.height = s.word_le();
    b.bpp = s.dword_le() >> 16;
    b.rle = BI_RGB;
    int bpp = b.bpp;
    if (b.width > 0 && b.height != 0 &&
        (bpp == 1 || bpp == 4 || bpp == 8 || bpp == 24 || bpp == 32)) {
      if (bpp <= 8) {
        uint8_t buf[256 * 3];
        s.bytes(buf, 3 << bpp);
        for (int j = 0; j < 1 << bpp; j++)
          b.pal[j] = Pal{buf[3 * j], buf[3 * j + 1], buf[3 * j + 2], 0};
      }
      ok = true;
    }
  }
  if (!ok) fail(REFUSED, "a kind of BMP cv2.imread gives no image for");
  b.bottom_up = b.height > 0;
  b.height = (int)std::abs((int64_t)b.height);
  return b;
}

// 16-bit 555 / 565 pixels as B, G, R (icvCvt_BGR5552BGR / BGR5652BGR)
inline void bgr16(int v, bool is555, int* c) {
  c[0] = v << 3 & 0xf8;
  c[1] = is555 ? v >> 2 & 0xf8 : v >> 3 & 0xfc;
  c[2] = is555 ? v >> 7 & 0xf8 : v >> 8 & 0xf8;
}

void decode(const uint8_t* data, long n, bool color, uint8_t* out) {
  Stream s{data, n};
  Bmp b = header(s);
  const int nch = color ? 3 : 1, width3 = b.width * nch, H = b.height, W = b.width;
  if ((uint64_t)H * (uint64_t)W * (uint64_t)nch >= (1ull << 30))
    fail(CORRUPT, "larger than the BMP reader takes");
  const int src_pitch = ((W * (b.bpp != 15 ? b.bpp : 16) + 7) / 8 + 3) & -4;
  // the offset of row 0 as the file stores it, and the step to the next
  int64_t at = b.bottom_up ? (int64_t)(H - 1) * width3 : 0;
  const int64_t step = b.bottom_up ? -(int64_t)width3 : width3;
  uint8_t gray_pal[256] = {0};
  if (!color && b.bpp <= 8) palette_to_gray(b.pal, gray_pal, 1 << b.bpp);
  std::vector<uint8_t> src((size_t)src_pitch + 32);
  if (b.offset < 0) fail(CORRUPT, "negative pixel offset");
  s.pos = b.offset;
  auto rows = [&](auto fn) {
    for (int y = 0; y < H; y++, at += step) {
      s.bytes(src.data(), src_pitch);
      fn(out + at, src.data());
    }
  };
  switch (b.bpp) {
    case 1:
      rows([&](uint8_t* o, const uint8_t* p) { row1(o, p, W, b.pal, gray_pal, nch); });
      return;
    case 4:
    case 8: {
      if (b.rle == BI_RGB) {
        rows([&](uint8_t* o, const uint8_t* p) {
          (b.bpp == 4 ? row4 : row8)(o, p, W, b.pal, gray_pal, nch);
        });
        return;
      }
      const bool rle8 = b.bpp == 8;
      int64_t line_end = at + width3;
      int y = 0, line_end_flag = 0;
      auto colour = [&](int i, uint8_t* c) {
        if (color) put(c, b.pal[i]);
        else c[0] = gray_pal[i];
      };
      uint8_t c0[3];
      colour(0, c0);
      for (;;) {
        int code = s.word_le();
        int len = code & 255;
        code >>= 8;
        if (len != 0) {   // encoded mode
          if (at + (int64_t)len * nch > line_end) fail(CORRUPT, "RLE run past a row's end");
          if (rle8) {
            int prev_y = y;
            uint8_t c[3];
            colour(code, c);
            at = fill_uni(out, at, line_end, step, width3, y, H, (int64_t)len * nch, c, nch);
            line_end_flag = y - prev_y;
            if (y >= H) break;
          } else {
            uint8_t c[2][3];
            colour(code >> 4, c[0]);
            colour(code & 15, c[1]);
            int64_t end = at + (int64_t)len * nch;
            int t = 0;
            do {
              std::memcpy(out + at, c[t], (size_t)nch);
              t ^= 1;
            } while ((at += nch) < end);
          }
        } else if (code > 2) {   // absolute mode
          if (at + (int64_t)code * nch > line_end) fail(CORRUPT, "RLE run past a row's end");
          int sz = rle8 ? (code + 1) & ~1 : (((code + 1) >> 1) + 1) & ~1;
          s.bytes(src.data(), sz);
          (rle8 ? row8 : row4)(out + at, src.data(), code, b.pal, gray_pal, nch);
          at += (int64_t)code * nch;
          line_end_flag = 0;
        } else {   // end of line (0), of bitmap (1), delta (2)
          int64_t x_shift3 = line_end - at;
          int64_t y_shift = H - y;
          if (!rle8 || code || !line_end_flag || x_shift3 < width3) {
            if (code == 2) {
              x_shift3 = (int64_t)s.byte() * nch;
              y_shift = s.byte();
            }
            // RLE4 fills dx pixels for a delta and the rest of the row for
            // the end of bitmap: OpenCV drops dy and the rows below there
            if (code != 0 && rle8) x_shift3 += y_shift * width3;
            at = fill_uni(out, at, line_end, step, width3, y, H, x_shift3, c0, nch);
            if (y >= H) break;
          }
          line_end_flag = 0;
        }
      }
      return;
    }
    case 15:
    case 16:
      rows([&](uint8_t* o, const uint8_t* p) {
        for (int x = 0; x < W; x++) {
          int c[3];
          bgr16(p[2 * x] | p[2 * x + 1] << 8, b.bpp == 15, c);
          if (!color) o[x] = gray(c[0], c[1], c[2]);
          else
            for (int k = 0; k < 3; k++) o[3 * x + k] = (uint8_t)c[k];
        }
      });
      return;
    case 32:
      if (b.use_masks) {
        // each field (v & mask) >> its lowest bit, times 255 / its largest
        // value, in float and truncated; the gray of those in float too
        int shift[3];
        float scale[3];
        for (int c = 0; c < 3; c++) {
          shift[c] = __builtin_ctz(b.masks[c]);
          scale[c] = 255.0f / (float)(b.masks[c] >> shift[c]);
        }
        rows([&](uint8_t* o, const uint8_t* p) {
          for (int x = 0; x < W; x++, p += 4) {
            uint32_t v = p[0] | p[1] << 8 | p[2] << 16 | (uint32_t)p[3] << 24;
            float rgb[3];
            for (int c = 0; c < 3; c++)
              rgb[c] = std::floor((float)((v & b.masks[c]) >> shift[c]) * scale[c]);
            if (!color) o[x] = (uint8_t)(0.299f * rgb[0] + 0.587f * rgb[1] + 0.114f * rgb[2]);
            else
              for (int k = 0; k < 3; k++) o[3 * x + k] = (uint8_t)rgb[2 - k];
          }
        });
        return;
      }
      [[fallthrough]];
    case 24: {
      const int k = b.bpp / 8;
      rows([&](uint8_t* o, const uint8_t* p) {
        for (int x = 0; x < W; x++, p += k)
          if (color) o[3 * x] = p[0], o[3 * x + 1] = p[1], o[3 * x + 2] = p[2];
          else o[x] = gray(p[0], p[1], p[2]);
      });
      return;
    }
  }
  fail(REFUSED, "unsupported bit depth");
}

}  // namespace

extern "C" {

int pv_bmp_info(const uint8_t* data, long n, int color, int* h, int* w, char* err, int errlen) {
  (void)color;
  return guarded([&] {
    Stream s{data, n};
    Bmp b = header(s);
    *h = b.height;
    *w = b.width;
  }, err, errlen);
}

int pv_bmp_decode(const uint8_t* data, long n, int color, uint8_t* out, char* err, int errlen) {
  return guarded([&] {
    decode(data, n, color != 0, out);
    if (color) {
      Stream s{data, n};
      Bmp b = header(s);
      bgr_to_rgb(out, (int64_t)b.height * b.width);
    }
  }, err, errlen);
}

}  // extern "C"
