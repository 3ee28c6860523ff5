// What bmp.cpp, pxm.cpp and sunras.cpp share: OpenCV imgcodecs' byte
// stream (bitstrm.cpp: a read past the end throws, and cv2.imread then
// gives no image) and its pixel helpers (utils.cpp: the fixed-point gray
// conversion, palette rows, uniform runs). Each decoder writes cv2's BGR
// rows and turns them into RGB at the end (`bgr_to_rgb`); a gray read
// writes one byte a pixel.
//
// Every entry point returns 0 ok, 1 a kind of file cv2 gives no image for,
// 2 a cut or corrupt file (cv2 gives no image either), 3 no memory, with
// the reason in err. No global state: frames decode on threads.

#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>

namespace imgc {

enum { OK = 0, REFUSED = 1, CORRUPT = 2, NOMEM = 3 };

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] inline void fail(int code, const std::string& msg) { throw Error{code, msg}; }

// RLByteStream / RMByteStream over the file's bytes
struct Stream {
  const uint8_t* d;
  int64_t n;
  int64_t pos = 0;
  void need(int64_t k) const {
    if (k < 0 || pos < 0 || pos + k > n) fail(CORRUPT, "unexpected end of input stream");
  }
  int byte() {
    need(1);
    return d[pos++];
  }
  void bytes(void* dst, int64_t k) {
    need(k);
    std::memcpy(dst, d + pos, (size_t)k);
    pos += k;
  }
  int word_le() {
    int v = byte();
    return v | byte() << 8;
  }
  int dword_le() {
    uint32_t v = (uint32_t)word_le();
    return (int)(v | (uint32_t)word_le() << 16);
  }
  int dword_be() {
    uint32_t v = 0;
    for (int k = 0; k < 4; k++) v = v << 8 | (uint32_t)byte();
    return (int)v;
  }
};

struct Pal {
  uint8_t b, g, r, a;
};

// icvCvt_BGR2Gray_8u_C3C1R: 0.299 / 0.587 / 0.114 in 14-bit fixed point, rounded
inline uint8_t gray(int b, int g, int r) {
  return (uint8_t)((b * 1868 + g * 9617 + r * 4899 + 8192) >> 14);
}

inline void palette_to_gray(const Pal* pal, uint8_t* gray_pal, int n) {
  for (int i = 0; i < n; i++) gray_pal[i] = gray(pal[i].b, pal[i].g, pal[i].r);
}

inline void put(uint8_t* p, const Pal& c) {
  p[0] = c.b;
  p[1] = c.g;
  p[2] = c.r;
}

// FillColorRow8 / FillGrayRow8 / ...Row4 / ...Row1: len pixels of palette
// indices (one a byte, two a byte high nibble first, eight a byte high bit
// first) at out; nch 3 writes the palette's BGR, 1 its gray
inline void row8(uint8_t* out, const uint8_t* idx, int len, const Pal* pal,
                 const uint8_t* gray_pal, int nch) {
  for (int i = 0; i < len; i++)
    if (nch == 3) put(out + 3 * i, pal[idx[i]]);
    else out[i] = gray_pal[idx[i]];
}

inline void row4(uint8_t* out, const uint8_t* idx, int len, const Pal* pal,
                 const uint8_t* gray_pal, int nch) {
  for (int i = 0; i < len; i++) {
    int v = i & 1 ? idx[i >> 1] & 15 : idx[i >> 1] >> 4;
    if (nch == 3) put(out + 3 * i, pal[v]);
    else out[i] = gray_pal[v];
  }
}

inline void row1(uint8_t* out, const uint8_t* idx, int len, const Pal* pal,
                 const uint8_t* gray_pal, int nch) {
  for (int i = 0; i < len; i++) {
    int v = idx[i >> 3] >> (7 - (i & 7)) & 1;
    if (nch == 3) put(out + 3 * i, pal[v]);
    else out[i] = gray_pal[v];
  }
}

// FillUniColor / FillUniGray: count bytes of the colour clr (nch bytes a
// pixel) from offset `at` on, in raster order: at the end of a row the
// next row starts (line_end moves by step, negative for bottom-up rows)
// and y counts up; stops when y reaches height. Returns the new offset.
inline int64_t fill_uni(uint8_t* buf, int64_t at, int64_t& line_end, int64_t step, int width3,
                        int& y, int height, int64_t count, const uint8_t* clr, int nch) {
  do {
    int64_t end = at + count;
    if (end > line_end) end = line_end;
    count -= end - at;
    for (; at < end; at += nch) std::memcpy(buf + at, clr, (size_t)nch);
    if (at >= line_end) {
      line_end += step;
      at = line_end - width3;
      if (++y >= height) break;
    }
  } while (count > 0);
  return at;
}

inline void bgr_to_rgb(uint8_t* p, int64_t pixels) {
  for (int64_t i = 0; i < pixels; i++, p += 3) {
    uint8_t t = p[0];
    p[0] = p[2];
    p[2] = t;
  }
}

// Runs f, turning its Error (or bad_alloc) into the return code and err.
template <class F>
int guarded(F f, char* err, int errlen) {
  try {
    f();
    return OK;
  } catch (const Error& e) {
    snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
    return e.code;
  } catch (const std::bad_alloc&) {
    snprintf(err, (size_t)errlen, "out of memory");
    return NOMEM;
  }
}

}  // namespace imgc
