// PBM / PGM / PPM, PAM and PFM decoding with the bits of cv2.imread
// (OpenCV 5's PxMDecoder, PAMDecoder and PFMDecoder: grfmt_pxm.cpp,
// grfmt_pam.cpp, grfmt_pfm.cpp):
//   * PxM (P1-P6): numbers after any whitespace and '#' comments, each
//     ended by one byte that is consumed (so a '#' right after a number
//     ends it, and the last ASCII sample needs a byte after it, except in
//     P1, whose samples are single digits); maxval 1-65535. ASCII samples
//     above maxval are clipped to it; 8-bit ASCII samples are scaled by
//     i * 255 / maxval (integer division) while binary ones are kept as
//     they are; every 16-bit sample keeps its high byte, unscaled. P1 / P4
//     bits are 1 black, 0 white. The gray read of a P3 / P6 file is
//     (1868 B + 9617 G + 4899 R + 8192) >> 14;
//   * PAM (P7 and a line break): the header lines HEIGHT, WIDTH, DEPTH,
//     MAXVAL (each once, an integer with an optional minus sign and
//     nothing after it), TUPLTYPE and ENDHDR, comments and blank lines;
//     an unknown field, a value of another form or a missing field gives
//     no image. A TUPLTYPE fixes DEPTH (BLACKANDWHITE, GRAYSCALE 1,
//     GRAYSCALE_ALPHA 2, RGB 3, RGB_ALPHA 4); without one DEPTH 1 or 3 and
//     MAXVAL below 256 are taken. Samples are never scaled (16-bit keep the
//     high byte). MAXVAL 1 reads each row's bytes as packed bits, high bit
//     first, as OpenCV's bit mode does. A read with the file's own channel
//     count copies the samples as they are (a colour read of an RGB file
//     keeps R where cv2 puts B); GRAYSCALE -> colour replicates; RGB ->
//     gray is the formula above with R and B swapped (R weighs 4899);
//     GRAYSCALE_ALPHA and RGB_ALPHA go through OpenCV's basic_conversion,
//     which walks only the first ceil(W / DEPTH) pixels of each row and
//     writes three bytes for each even into a gray row: the bytes it never
//     writes are 0 here (cv2 leaves them as they were in memory);
//   * PFM: "Pf" (one channel) or "PF" (three, RGB) and a line feed, then
//     width, height and scale, each up to the next whitespace byte (atoi /
//     atof, no whitespace skipped), then bottom-up rows of floats, little
//     endian for a negative scale; each float times (float)(1 / |scale|) in
//     float, then rounded half to even and saturated to 0-255 (NaN and
//     values past the int32 range give 0). A scale of 0 or NaN, and a read
//     with another channel count than the file's (a gray read of "PF", a
//     colour read of "Pf"), give no image.
// A cut file gives an error where cv2.imread gives no image.
//
// C interface (ctypes), as bmp.cpp: pv_pxm_info(data, n, color, &h, &w,
// err, errlen), pv_pxm_decode(data, n, color, out, err, errlen).

#include <cctype>
#include <climits>
#include <cmath>
#include <cstdlib>
#include <vector>

#include "imgcodecs.h"

namespace {

using namespace imgc;

// ---------------------------------------------------------------------------
// PxM
// ---------------------------------------------------------------------------

int read_number(Stream& s, int maxdigits = 0) {
  int code = s.byte();
  while (!isdigit(code)) {
    if (code == '#') {
      do code = s.byte();
      while (code != '\n' && code != '\r');
      code = s.byte();
    } else if (isspace(code)) {
      while (isspace(code)) code = s.byte();
    } else {
      fail(CORRUPT, "unexpected byte in a number");
    }
  }
  int64_t val = 0;
  int digits = 0;
  do {
    val = val * 10 + (code - '0');
    if (val > INT_MAX) fail(CORRUPT, "number too large");
    if (maxdigits != 0 && ++digits >= maxdigits) break;
    code = s.byte();
  } while (isdigit(code));
  return (int)val;
}

struct Pxm {
  int width, height, bpp, maxval;
  bool binary, deep;
  int64_t offset;
};

Pxm pxm_header(Stream& s) {
  Pxm p{};
  s.pos = 1;
  int code = s.byte();
  p.bpp = code == '1' || code == '4' ? 1 : code == '2' || code == '5' ? 8 : 24;
  p.binary = code >= '4';
  p.width = read_number(s);
  p.height = read_number(s);
  p.maxval = p.bpp > 1 ? read_number(s) : 1;
  if (p.maxval > 65535) fail(CORRUPT, "maxval above 65535");
  p.deep = p.maxval > 255;
  if (!(p.width > 0 && p.height > 0 && p.maxval > 0))
    fail(CORRUPT, "zero size or maxval");
  p.offset = s.pos;
  return p;
}

void pxm_decode(Stream& s, const Pxm& p, bool color, uint8_t* out) {
  const int W = p.width, cn = p.bpp == 24 ? 3 : 1, width3 = W * cn;
  const int64_t row = (int64_t)W * (color ? 3 : 1);
  uint8_t gray_pal[256] = {0};
  Pal pal[256] = {};
  if (!p.deep) {
    for (int i = 0; i <= p.maxval; i++)
      gray_pal[i] = (uint8_t)((i * 255 / p.maxval) ^ (p.bpp == 1 ? 255 : 0));
    pal[0] = Pal{255, 255, 255, 0};   // FillGrayPalette(1 bit, negative)
  }
  s.pos = p.offset;
  if (p.bpp == 1) {
    std::vector<uint8_t> src((size_t)(p.binary ? (W + 7) / 8 : W));
    for (int y = 0; y < p.height; y++, out += row) {
      if (p.binary) s.bytes(src.data(), (int64_t)src.size());
      else
        for (int x = 0; x < W; x++) src[x] = read_number(s, 1) != 0;
      if (p.binary) row1(out, src.data(), W, pal, gray_pal, color ? 3 : 1);
      else row8(out, src.data(), W, pal, gray_pal, color ? 3 : 1);
    }
    return;
  }
  const int64_t pitch = (int64_t)width3 * (p.deep ? 2 : 1);
  std::vector<uint8_t> src((size_t)pitch);
  for (int y = 0; y < p.height; y++, out += row) {
    if (!p.binary) {
      for (int x = 0; x < width3; x++) {
        int code = read_number(s);
        if ((unsigned)code > (unsigned)p.maxval) code = p.maxval;
        src[x] = p.deep ? (uint8_t)(code >> 8) : gray_pal[code];
      }
    } else {
      s.bytes(src.data(), pitch);
      if (p.deep)
        for (int x = 0; x < width3; x++) src[x] = src[2 * x];   // the high byte
    }
    const uint8_t* q = src.data();
    for (int x = 0; x < W; x++, q += cn) {
      if (cn == 1) {
        if (color) out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = q[0];
        else out[x] = q[0];
      } else if (color) {
        out[3 * x] = q[2], out[3 * x + 1] = q[1], out[3 * x + 2] = q[0];
      } else {
        out[x] = gray(q[2], q[1], q[0]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// PAM
// ---------------------------------------------------------------------------

enum Field { NONE, COMMENT, ENDHDR, HEIGHT, WIDTH, DEPTH, MAXVAL, TUPLTYPE };
const int IDENT_LEN = 8, VALUE_LEN = 255;

// ReadPAMHeaderLine: false where OpenCV gives up on the header
bool header_line(Stream& s, Field& field, std::string& value) {
  static const struct { const char* name; Field f; } fields[] = {
      {"HEIGHT", HEIGHT}, {"WIDTH", WIDTH}, {"DEPTH", DEPTH}, {"MAXVAL", MAXVAL},
      {"TUPLTYPE", TUPLTYPE}, {"ENDHDR", ENDHDR}};
  int code;
  do code = s.byte();
  while (isspace(code));
  if (code == '#') {
    do code = s.byte();
    while (code != '\n' && code != '\r');
    field = COMMENT;
    return true;
  }
  std::string ident;
  for (int pos = 0; pos < IDENT_LEN && !isspace(code); pos++) {
    ident += (char)code;
    code = s.byte();
  }
  if (!isspace(code)) return false;
  ident = ident.c_str();   // OpenCV compares C strings: up to a NUL
  bool found = false;
  for (const auto& f : fields)
    if (ident == f.name) field = f.f, found = true;
  if (!found) return false;
  value.clear();
  if (code == '\n' || code == '\r') return true;
  do code = s.byte();
  while (isspace(code));
  for (int pos = 0; pos < VALUE_LEN && code != '\n' && code != '\r'; pos++) {
    value += (char)code;
    code = s.byte();
  }
  if (code != '\n' && code != '\r') return false;
  while (!value.empty() && isspace((unsigned char)value.back())) value.pop_back();
  value = value.c_str();
  return true;
}

// ParseInt: an optional '-', digits below INT_MAX, nothing after them
int parse_int(const std::string& v) {
  size_t pos = 0;
  bool neg = false;
  if (!v.empty() && v[0] == '-') {
    neg = true;
    if (v.size() < 2 || !isdigit((unsigned char)v[1])) fail(CORRUPT, "bad number in the header");
    pos = 1;
  }
  uint64_t num = 0;
  for (; pos < v.size() && isdigit((unsigned char)v[pos]); pos++) {
    num = num * 10 + (uint64_t)(v[pos] - '0');
    if (num >= INT_MAX) fail(CORRUPT, "number too large in the header");
  }
  if (pos < v.size()) fail(CORRUPT, "bad number in the header");
  return neg ? -(int)num : (int)num;
}

enum Tuple { T_NULL, T_BW, T_GRAY, T_GRAY_ALPHA, T_RGB, T_RGB_ALPHA };

struct Pam {
  int width = 0, height = 0, channels = 0, maxval = 0;
  Tuple fmt = T_NULL;
  bool deep = false, bit_mode = false;
  int64_t offset = 0;
};

Pam pam_header(Stream& s) {
  static const struct { const char* name; Tuple t; int channels; } tuples[] = {
      {"", T_NULL, 0}, {"BLACKANDWHITE", T_BW, 1}, {"GRAYSCALE", T_GRAY, 1},
      {"GRAYSCALE_ALPHA", T_GRAY_ALPHA, 2}, {"RGB", T_RGB, 3}, {"RGB_ALPHA", T_RGB_ALPHA, 4}};
  if (s.n < 3 || (s.d[2] != '\n' && s.d[2] != '\r'))
    fail(CORRUPT, "no PAM signature (P7 and a line break)");
  Pam p;
  bool has[8] = {};
  s.pos = 3;
  Field field = NONE;
  std::string value;
  while (header_line(s, field, value)) {
    if (field == COMMENT || field == NONE) continue;
    if (field == TUPLTYPE) {
      bool found = false;
      for (const auto& t : tuples)
        if (value == t.name) {
          p.fmt = t.t;
          found = true;
          break;
        }
      if (!found) fail(REFUSED, "a TUPLTYPE cv2 does not know");
      continue;
    }
    if (field == ENDHDR) {
      has[ENDHDR] = true;
      break;
    }
    if (has[field]) fail(CORRUPT, "a header field twice");
    has[field] = true;
    int v = parse_int(value);
    if (field == HEIGHT) p.height = v;
    else if (field == WIDTH) p.width = v;
    else if (field == DEPTH) p.channels = v;
    else {
      if (v > 65535) fail(CORRUPT, "maxval above 65535");
      p.maxval = v;
      p.deep = v > 255;
      p.bit_mode = v == 1;
    }
  }
  if (!(has[ENDHDR] && has[HEIGHT] && has[WIDTH] && has[DEPTH] && has[MAXVAL]))
    fail(CORRUPT, "a PAM header without its fields");
  if (p.fmt == T_NULL) {
    if (p.channels == 1 && p.maxval == 1) p.fmt = T_BW;
    else if (p.channels == 1 && p.maxval < 256) p.fmt = T_GRAY;
    else if (p.channels == 3 && p.maxval < 256) p.fmt = T_RGB;
    else fail(REFUSED, "no TUPLTYPE, and a DEPTH or MAXVAL cv2 does not guess from");
  } else if (p.channels != tuples[p.fmt].channels) {
    fail(REFUSED, "a DEPTH other than the TUPLTYPE's");
  }
  p.offset = s.pos;
  return p;
}

void pam_decode(Stream& s, const Pam& p, bool color, uint8_t* out) {
  const int W = p.width, ch = p.channels, target = color ? 3 : 1;
  const int64_t row = (int64_t)W * target, stride = (int64_t)W * ch * (p.deep ? 2 : 1);
  std::vector<uint8_t> src((size_t)stride);
  // basic_conversion's walk: ceil(W / ch) pixels, three bytes each, from
  // the start of the row on (a gray row's writes run into the next row,
  // which overwrites them, and past the last row, which is dropped here)
  const int64_t walked = ((int64_t)W + ch - 1) / ch, bytes = std::min<int64_t>(3 * walked, row);
  s.pos = p.offset;
  s.need(stride * p.height);   // every row is read whole: a short file gives no image
  std::memset(out, 0, (size_t)(row * p.height));
  const Pal bw[2] = {{0, 0, 0, 0}, {255, 255, 255, 0}};
  const uint8_t gray_bw[2] = {0, 255};
  for (int y = 0; y < p.height; y++, out += row) {
    s.bytes(src.data(), stride);
    if (p.bit_mode) {
      row1(out, src.data(), W, bw, gray_bw, target);
      continue;
    }
    if (p.deep)
      for (int64_t x = 0; x < (int64_t)W * ch; x++) src[x] = src[2 * x];
    const uint8_t* q = src.data();
    if (target == ch) {
      std::memcpy(out, q, (size_t)row);
    } else if (p.fmt == T_RGB) {   // rgb_convert to gray
      for (int x = 0; x < W; x++, q += 3) out[x] = gray(q[2], q[1], q[0]);
    } else if (p.fmt == T_RGB_ALPHA && color) {
      for (int64_t k = 0; 3 * k < bytes; k++, q += ch)
        out[3 * k] = q[2], out[3 * k + 1] = q[1], out[3 * k + 2] = q[0];
    } else {   // one channel (the gray one, the first) to every written byte
      for (int64_t k = 0; k < bytes; k++) out[k] = q[(k / 3) * ch];
    }
  }
}

// ---------------------------------------------------------------------------
// PFM
// ---------------------------------------------------------------------------

std::string pfm_token(Stream& s) {
  std::string t;
  for (int i = 0; i < 2048; i++) {
    int c = s.byte();
    if (c >= 128) fail(CORRUPT, "a non-ASCII byte in the PFM header");
    if (isspace(c)) break;
    t += (char)c;
  }
  return t;
}

struct Pfm {
  int width, height, channels;
  double scale;
  int64_t offset;
};

Pfm pfm_header(Stream& s) {
  Pfm p{};
  s.pos = 1;
  p.channels = s.byte() == 'F' ? 3 : 1;
  if (s.byte() != '\n') fail(CORRUPT, "no line feed after the PFM signature");
  p.width = (int)strtol(pfm_token(s).c_str(), nullptr, 10);
  p.height = (int)strtol(pfm_token(s).c_str(), nullptr, 10);
  p.scale = strtod(pfm_token(s).c_str(), nullptr);
  p.offset = s.pos;
  return p;
}

uint8_t saturate_round(float v) {
  // cvRound (cvtss2si: half to even, NaN and out-of-range to INT_MIN), then
  // saturate_cast<uchar>
  float r = std::nearbyint(v);
  if (!(r >= -2147483648.0f && r < 2147483648.0f)) return 0;
  long i = (long)r;
  return (uint8_t)(i < 0 ? 0 : i > 255 ? 255 : i);
}

void pfm_decode(Stream& s, const Pfm& p, bool color, uint8_t* out) {
  const int W = p.width, ch = p.channels;
  const int64_t row = (int64_t)W * ch;
  const bool swap = p.scale >= 0.0;   // big endian
  s.pos = p.offset;
  s.need(row * 4 * p.height);   // every row is read whole: a short file gives no image
  std::vector<float> buf((size_t)(row * p.height));
  for (int y = p.height - 1; y >= 0; y--) {
    float* r = buf.data() + y * row;
    s.bytes(r, row * 4);
    if (swap)
      for (int64_t i = 0; i < row; i++) {
        uint32_t u;
        std::memcpy(&u, r + i, 4);
        u = __builtin_bswap32(u);
        std::memcpy(r + i, &u, 4);
      }
  }
  if (!(std::fabs(p.scale) > 0.0)) fail(CORRUPT, "a PFM scale of 0");
  if ((ch == 3) != color)
    fail(REFUSED, "a PFM read with another channel count than its own (cv2.imread "
                  "gives no image)");
  const float a = (float)(1.0 / std::fabs(p.scale));
  for (int64_t i = 0; i < (int64_t)W * p.height; i++)   // RGB -> cv2's BGR
    for (int c = 0; c < ch; c++) out[i * ch + c] = saturate_round(buf[i * ch + ch - 1 - c] * a);
}

void decode(const uint8_t* data, long n, bool color, uint8_t* out, int* h, int* w) {
  Stream s{data, n};
  int kind = n > 1 ? data[1] : 0;
  if (kind == '7') {
    Pam p = pam_header(s);
    *h = p.height, *w = p.width;
    if (out) pam_decode(s, p, color, out);
  } else if (kind == 'f' || kind == 'F') {
    Pfm p = pfm_header(s);
    *h = p.height, *w = p.width;
    if (out) pfm_decode(s, p, color, out);
  } else if (kind >= '1' && kind <= '6') {
    Pxm p = pxm_header(s);
    *h = p.height, *w = p.width;
    if (out) pxm_decode(s, p, color, out);
  } else {
    fail(CORRUPT, "not a PxM, PAM or PFM file");
  }
}

}  // namespace

extern "C" {

int pv_pxm_info(const uint8_t* data, long n, int color, int* h, int* w, char* err, int errlen) {
  return guarded([&] { decode(data, n, color != 0, nullptr, h, w); }, err, errlen);
}

int pv_pxm_decode(const uint8_t* data, long n, int color, uint8_t* out, char* err, int errlen) {
  return guarded([&] {
    int h, w;
    decode(data, n, color != 0, out, &h, &w);
    if (color) bgr_to_rgb(out, (int64_t)h * w);
  }, err, errlen);
}

}  // extern "C"
