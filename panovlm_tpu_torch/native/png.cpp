// PNG decoding with the bits of cv2.imread (libpng 1.6 through OpenCV's
// PngDecoder): the image stages read panoramas and masks as PNG on a machine
// without cv2. The inflate step stays with the caller (Python's zlib, which
// releases the GIL); this file does the rest:
//   * the chunk walk of libpng: IHDR first and checked, CRC of every chunk
//     (a critical chunk with a bad CRC, an unknown critical chunk, a missing
//     PLTE or IEND are errors; an ancillary chunk with a bad CRC is dropped),
//     the image data of the first run of IDAT chunks;
//   * the five row filters and Adam7 de-interlacing (a pass that is empty at
//     a small width or height has no rows and no filter bytes);
//   * every colour type and bit depth, reduced as OpenCV asks libpng to:
//     png_set_strip_16 (16-bit samples keep their high byte),
//     png_set_strip_alpha (alpha and tRNS never change a colour),
//     png_set_palette_to_rgb (indices past the palette are black),
//     png_set_expand_gray_1_2_4_to_8 (1, 2, 4-bit gray times 255, 85, 17),
//     png_set_gray_to_rgb for a colour read, and for a gray read
//     png_set_rgb_to_gray(1, 0.299, 0.587): weights 9797, 19234, 3737 / 2^15,
//     r == g == b kept as is; truncated at 8 bits, rounded at 16 bits, where
//     libpng converts before it strips the low byte;
//   * the gamma of that gray conversion: a gAMA chunk (or an sRGB chunk,
//     which takes precedence, as 0.45455) before PLTE and IDAT whose gamma is
//     not within 5 % of 1 makes libpng convert through its gamma tables
//     (png_build_gamma_table: gamma_to_1, gamma_from_1 and, for r == g == b,
//     gamma_table; at 16 bits the shifted tables of png_build_16bit_table
//     and png_build_16to8_table, the shift from sBIT), in double precision
//     as libpng's floating-point build does. A colour read is never
//     gamma-corrected (OpenCV sets no screen gamma);
//   * the EXIF Orientation tag of the first eXIf chunk (before or after the
//     image data), returned to the caller, which turns the image as cv2's
//     imread does.
//
// C interface (ctypes): pv_png_info(data, n, color, idat, &h, &w, &ch,
// &orientation, &idat_len, &raw_len, err, errlen) checks the file, copies
// the IDAT payloads into idat (n bytes suffice) and gives the output size
// and the size of the inflated data; pv_png_decode(data, n, raw, raw_len,
// color, out, err, errlen) writes the h * w * ch bytes (RGB for a colour
// read). Each returns 0 ok, 1 unsupported, 2 corrupt, 3 no memory. No
// global state: frames decode on threads.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <new>
#include <string>
#include <vector>

namespace {

enum { OK = 0, UNSUPPORTED = 1, CORRUPT = 2, NOMEM = 3 };

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Error{code, msg}; }

// CRC-32 of ISO 3309, eight bytes a step (slicing-by-8)
struct Crc {
  uint32_t t[8][256];
  Crc() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (int k = 1; k < 8; k++)
      for (int i = 0; i < 256; i++) t[k][i] = t[0][t[k - 1][i] & 0xFF] ^ (t[k - 1][i] >> 8);
  }
  uint32_t operator()(const uint8_t* p, size_t n) const {
    uint32_t c = 0xFFFFFFFFu;
    for (; n >= 8; n -= 8, p += 8) {
      uint32_t lo = c ^ ((uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16 |
                         (uint32_t)p[3] << 24);
      c = t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF] ^ t[4][lo >> 24] ^
          t[3][p[4]] ^ t[2][p[5]] ^ t[1][p[6]] ^ t[0][p[7]];
    }
    for (; n; n--, p++) c = t[0][(c ^ *p) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
  }
};

inline uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
// Adam7: x0, y0, dx, dy of each pass
const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                          {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
constexpr uint32_t kMaxSide = 1000000;   // libpng's PNG_USER_WIDTH_MAX / HEIGHT_MAX

// cv2's ExifReader: a TIFF header at the start of the chunk; tag 0x0112 of
// IFD0 is the orientation (0 when absent)
int exif_orientation(const uint8_t* d, size_t len) {
  if (len < 8) return 0;
  bool le;
  if (d[0] == 'I' && d[1] == 'I') le = true;
  else if (d[0] == 'M' && d[1] == 'M') le = false;
  else return 0;
  auto g16 = [&](size_t o) -> int {
    if (o + 2 > len) return -1;
    return le ? d[o] | (d[o + 1] << 8) : (d[o] << 8) | d[o + 1];
  };
  auto g32 = [&](size_t o) -> int64_t {
    if (o + 4 > len) return -1;
    return le ? (int64_t)d[o] | ((int64_t)d[o + 1] << 8) | ((int64_t)d[o + 2] << 16) |
                    ((int64_t)d[o + 3] << 24)
              : ((int64_t)d[o] << 24) | ((int64_t)d[o + 1] << 16) | ((int64_t)d[o + 2] << 8) |
                    (int64_t)d[o + 3];
  };
  int64_t ifd = g32(4);
  if (ifd < 0) return 0;
  int count = g16((size_t)ifd);
  for (int i = 0; i < count; i++) {
    size_t e = (size_t)ifd + 2 + 12 * (size_t)i;
    int tag = g16(e);
    if (tag < 0) return 0;
    if (tag == 0x0112) {
      int v = g16(e + 8);
      return v >= 0 ? v : 0;
    }
  }
  return 0;
}

struct Png {
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = 0, interlace = 0;
  uint8_t palette[256][3] = {};   // zero past the entries: black, as libpng's
  int npal = 0;
  int64_t gamma = 0;              // file gamma, 1e5 units; 0: none
  int sbit[4] = {0, 0, 0, 0};     // 0: no valid sBIT
  int orientation = 0;
  size_t idat_len = 0;
  size_t raw_len = 0;

  int channels() const { return kChannels[ctype]; }
  int pixel_bits() const { return channels() * depth; }
  size_t rowbytes(uint32_t w) const { return ((size_t)w * pixel_bits() + 7) / 8; }
};

void check_ihdr(Png& p, const uint8_t* d) {
  p.width = be32(d);
  p.height = be32(d + 4);
  p.depth = d[8];
  p.ctype = d[9];
  int compression = d[10], filter = d[11];
  p.interlace = d[12];
  if (p.width == 0 || p.height == 0) fail(CORRUPT, "image width or height is zero in IHDR");
  if (p.width > kMaxSide || p.height > kMaxSide)
    fail(CORRUPT, "image width or height exceeds libpng's limit of 1000000");
  if ((uint64_t)p.width * p.height > ((uint64_t)1 << 30))
    fail(CORRUPT, "image larger than cv2 reads (2^30 pixels)");
  bool ok_depth;
  switch (p.ctype) {
    case 0: ok_depth = p.depth == 1 || p.depth == 2 || p.depth == 4 || p.depth == 8 || p.depth == 16; break;
    case 3: ok_depth = p.depth == 1 || p.depth == 2 || p.depth == 4 || p.depth == 8; break;
    case 2: case 4: case 6: ok_depth = p.depth == 8 || p.depth == 16; break;
    default: fail(CORRUPT, "invalid colour type in IHDR");
  }
  if (!ok_depth) fail(CORRUPT, "invalid bit depth for the colour type in IHDR");
  if (compression != 0) fail(CORRUPT, "unknown compression method in IHDR");
  if (filter != 0) fail(CORRUPT, "unknown filter method in IHDR");
  if (p.interlace > 1) fail(CORRUPT, "unknown interlace method in IHDR");
}

// The chunk walk; with idat != nullptr the IDAT payloads are copied there.
// check_crc: also check the CRCs of the IDAT chunks.
Png parse(const uint8_t* data, size_t n, bool check_crc, uint8_t* idat) {
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (n < 8 || memcmp(data, magic, 8) != 0) fail(CORRUPT, "not a PNG file");
  static const Crc crc;
  Png p;
  size_t pos = 8;
  bool have_ihdr = false, have_plte = false, in_idat = false, idat_done = false;
  bool have_srgb = false, have_gama = false, have_sbit = false, have_exif = false;
  int64_t gama = 0;
  for (;;) {
    if (pos + 8 > n) fail(CORRUPT, "truncated file (no IEND)");
    uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    if (len > 0x7FFFFFFFu || pos + 12 + (size_t)len > n) fail(CORRUPT, "truncated chunk");
    for (int k = 0; k < 4; k++)
      if (!((type[k] >= 'A' && type[k] <= 'Z') || (type[k] >= 'a' && type[k] <= 'z')))
        fail(CORRUPT, "invalid chunk type");
    const uint8_t* body = type + 4;
    bool critical = !(type[0] & 0x20);
    // without check_crc (the second walk, after pv_png_info) the IDAT
    // payloads go unchecked; the small chunks are checked on every walk,
    // since a bad CRC drops an ancillary one
    bool crc_ok = (!check_crc && memcmp(type, "IDAT", 4) == 0) ||
                  crc(type, (size_t)len + 4) == be32(body + len);
    pos += 12 + (size_t)len;
    if (!crc_ok) {
      if (critical) fail(CORRUPT, std::string((const char*)type, 4) + ": CRC error");
      continue;   // an ancillary chunk with a bad CRC is dropped
    }
    auto is = [&](const char* name) { return memcmp(type, name, 4) == 0; };
    if (!have_ihdr) {
      if (!is("IHDR") || len != 13) fail(CORRUPT, "missing IHDR");
      check_ihdr(p, body);
      have_ihdr = true;
      continue;
    }
    if (!is("IDAT") && in_idat) {
      in_idat = false;
      idat_done = true;
    }
    if (is("IEND")) break;
    if (is("IDAT")) {
      if (p.ctype == 3 && !have_plte) fail(CORRUPT, "missing PLTE before IDAT");
      if (idat_done) continue;   // a later run of IDAT: libpng reads no further
      in_idat = true;
      if (idat) memcpy(idat + p.idat_len, body, len);
      p.idat_len += len;
    } else if (is("PLTE")) {
      if (have_plte) fail(CORRUPT, "duplicate PLTE");
      if (in_idat || idat_done) {
        if (p.ctype == 3) fail(CORRUPT, "PLTE after IDAT");
        continue;
      }
      if (len == 0 || len > 768 || len % 3) {
        if (p.ctype == 3) fail(CORRUPT, "invalid PLTE");
        continue;
      }
      have_plte = true;
      int num = (int)(len / 3);
      int max = p.ctype == 3 ? 1 << p.depth : 256;
      p.npal = num < max ? num : max;
      for (int i = 0; i < p.npal; i++)
        for (int k = 0; k < 3; k++) p.palette[i][k] = body[3 * i + k];
    } else if (is("gAMA") || is("sRGB") || is("sBIT")) {
      if (have_plte || in_idat || idat_done) continue;   // out of place: ignored
      if (is("gAMA")) {
        uint32_t g = len == 4 ? be32(body) : 0;
        if (!have_gama && g != 0 && g <= 0x7FFFFFFFu) {
          have_gama = true;
          gama = g;
        }
      } else if (is("sRGB")) {
        if (len == 1 && body[0] < 4) have_srgb = true;
      } else if (!have_sbit) {
        int depth = p.ctype == 3 ? 8 : p.depth;
        size_t want = (p.ctype & 2 ? 3 : 1) + (p.ctype & 4 ? 1 : 0);
        bool ok = len == want;
        for (size_t k = 0; ok && k < want; k++) ok = body[k] > 0 && body[k] <= depth;
        if (ok) {
          have_sbit = true;
          for (size_t k = 0; k < want && k < 4; k++) p.sbit[k] = body[k];
        }
      }
    } else if (is("eXIf")) {
      if (!have_exif) {
        have_exif = true;
        p.orientation = exif_orientation(body, len);
      }
    } else if (critical) {
      fail(CORRUPT, std::string((const char*)type, 4) + ": unhandled critical chunk");
    }
  }
  if (p.idat_len == 0) fail(CORRUPT, "no image data");
  p.gamma = have_srgb ? 45455 : gama;
  for (int k = 0; k < 7; k++) {
    const int* a = kAdam7[k];
    uint64_t pw = p.interlace ? (p.width + a[2] - 1 - a[0]) / a[2] : p.width;
    uint64_t ph = p.interlace ? (p.height + a[3] - 1 - a[1]) / a[3] : p.height;
    if (p.width <= (uint32_t)a[0]) pw = 0;
    if (p.height <= (uint32_t)a[1]) ph = 0;
    if (pw && ph) p.raw_len += ph * (1 + p.rowbytes((uint32_t)pw));
    if (!p.interlace) break;
  }
  return p;
}

// --- libpng's gamma arithmetic (png.c, floating-point build) ----------------

int64_t reciprocal(int64_t a) {   // png_reciprocal
  if (a == 0) return 0;
  double r = std::floor(1e10 / (double)a + .5);
  return r <= 2147483647. && r >= -2147483648. ? (int64_t)r : 0;
}

int64_t reciprocal2(int64_t a, int64_t b) {   // png_reciprocal2
  if (a == 0 || b == 0) return 0;
  double r = 1e15 / (double)a;
  r /= (double)b;
  r = std::floor(r + .5);
  return r <= 2147483647. && r >= -2147483648. ? (int64_t)r : 0;
}

bool significant(int64_t g) { return g < 100000 - 5000 || g > 100000 + 5000; }

void table8(int64_t g, uint8_t* t) {   // png_build_8bit_table
  for (int i = 0; i < 256; i++) {
    if (significant(g) && i > 0 && i < 255)
      t[i] = (uint8_t)std::floor(255 * std::pow(i / 255., (double)g * .00001) + .5);
    else
      t[i] = (uint8_t)i;
  }
}

uint16_t correct16(unsigned v, int64_t g) {   // png_gamma_16bit_correct
  if (v > 0 && v < 65535)
    return (uint16_t)std::floor(65535. * std::pow((int)v / 65535., (double)g * .00001) + .5);
  return (uint16_t)v;
}

// png_build_16bit_table: entry [(v & 0xff) >> shift][v >> 8]
void table16(int64_t g, int shift, std::vector<uint16_t>& t) {
  unsigned num = 1u << (8 - shift);
  double fmax = 1.0 / (((int32_t)1 << (16 - shift)) - 1);
  unsigned max = (1u << (16 - shift)) - 1u, max_by_2 = 1u << (15 - shift);
  t.assign((size_t)num * 256, 0);
  for (unsigned i = 0; i < num; i++)
    for (unsigned j = 0; j < 256; j++) {
      uint32_t ig = (j << (8 - shift)) + i;
      if (significant(g)) {
        t[i * 256 + j] = (uint16_t)std::floor(65535. * std::pow(ig * fmax, (double)g * .00001) + .5);
      } else {
        if (shift) ig = (ig * 65535u + max_by_2) / max;
        t[i * 256 + j] = (uint16_t)ig;
      }
    }
}

// png_build_16to8_table
void table16to8(int64_t g, int shift, std::vector<uint16_t>& t) {
  unsigned num = 1u << (8 - shift);
  uint32_t max = (1u << (16 - shift)) - 1u;
  t.assign((size_t)num * 256, 0);
  auto at = [&](uint32_t last) -> uint16_t& {
    return t[(last & (0xFFu >> shift)) * 256 + (last >> (8 - shift))];
  };
  uint32_t last = 0;
  for (unsigned i = 0; i < 255; i++) {
    uint16_t out = (uint16_t)(i * 257u);
    uint32_t bound = correct16(out + 128u, g);
    bound = (bound * max + 32768u) / 65535u + 1u;
    while (last < bound) at(last++) = out;
  }
  while (last < (num << 8)) at(last++) = 65535u;
}

constexpr int RC = 9797, GC = 19234, BC = 3737;   // png_set_rgb_to_gray(1, 0.299, 0.587)

// The gray conversion of one RGB sample triple (8 or 16 bits) to 8 bits.
struct ToGray {
  bool gamma = false;
  int shift = 0;
  uint8_t g8[256], to1_8[256], from1_8[256];
  std::vector<uint16_t> g16, to1_16, from1_16;

  ToGray(const Png& p, int depth) {
    // png_init_gamma_values: no screen gamma, so it becomes 1 / file gamma
    int64_t file = p.gamma, screen = 0;
    if (file > 0) screen = reciprocal(file);
    else file = screen = 100000;
    gamma = significant(file) || significant(screen);
    if (!gamma) return;
    int64_t g_table = reciprocal2(file, screen), g_to1 = reciprocal(file);
    int64_t g_from1 = screen > 0 ? reciprocal(screen) : file;
    if (depth <= 8) {
      table8(g_table, g8);
      table8(g_to1, to1_8);
      table8(g_from1, from1_8);
      return;
    }
    int sig = p.sbit[0];
    if (p.ctype & 2) sig = std::max(p.sbit[0], std::max(p.sbit[1], p.sbit[2]));
    shift = sig > 0 && sig < 16 ? 16 - sig : 0;
    if (shift < 16 - 11) shift = 16 - 11;   // PNG_MAX_GAMMA_8 with strip_16
    if (shift > 8) shift = 8;
    table16to8(g_table, shift, g16);
    table16(g_to1, shift, to1_16);
    table16(g_from1, shift, from1_16);
  }
  uint16_t lut16(const std::vector<uint16_t>& t, unsigned v) const {
    return t[((v & 0xFF) >> shift) * 256 + (v >> 8)];
  }
  uint8_t operator()(unsigned r, unsigned g, unsigned b, int depth) const {
    if (depth <= 8) {
      if (r == g && r == b) return gamma ? g8[r] : (uint8_t)r;
      if (!gamma) return (uint8_t)((RC * r + GC * g + BC * b) >> 15);
      return from1_8[(RC * to1_8[r] + GC * to1_8[g] + BC * to1_8[b] + 16384) >> 15];
    }
    if (!gamma) return (uint8_t)(((RC * r + GC * g + BC * b + 16384) >> 15) >> 8);
    unsigned w;
    if (r == g && r == b) {
      w = lut16(g16, r);
    } else {
      unsigned gray = (RC * lut16(to1_16, r) + GC * lut16(to1_16, g) + BC * lut16(to1_16, b) +
                       16384) >> 15;
      w = lut16(from1_16, gray);
    }
    return (uint8_t)(w >> 8);
  }
};

inline int paeth(int a, int b, int c) {
  int pa = b - c, pb = a - c;
  int pc = pa + pb;
  pa = pa < 0 ? -pa : pa;
  pb = pb < 0 ? -pb : pb;
  pc = pc < 0 ? -pc : pc;
  int bc = pb <= pc ? b : c;
  return (pa <= pb && pa <= pc) ? a : bc;
}

// Paeth with the pixel size known at compile time, so that the bytes of
// one pixel run side by side
template <int BPP>
void unpaeth(uint8_t* cur, const uint8_t* prior, size_t n) {
  for (size_t i = 0; i < BPP && i < n; i++) cur[i] = (uint8_t)(cur[i] + prior[i]);
  for (size_t i = BPP; i + BPP <= n; i += BPP)
    for (int k = 0; k < BPP; k++)
      cur[i + k] = (uint8_t)(cur[i + k] + paeth(cur[i + k - BPP], prior[i + k], prior[i + k - BPP]));
}

void unfilter(int f, uint8_t* cur, const uint8_t* prior, size_t n, size_t bpp) {
  switch (f) {
    case 0: break;
    case 1:
      for (size_t i = bpp; i < n; i++) cur[i] = (uint8_t)(cur[i] + cur[i - bpp]);
      break;
    case 2:
      for (size_t i = 0; i < n; i++) cur[i] = (uint8_t)(cur[i] + prior[i]);
      break;
    case 3:
      for (size_t i = 0; i < bpp && i < n; i++) cur[i] = (uint8_t)(cur[i] + (prior[i] >> 1));
      for (size_t i = bpp; i < n; i++)
        cur[i] = (uint8_t)(cur[i] + ((cur[i - bpp] + prior[i]) >> 1));
      break;
    case 4:   // n is a whole number of pixels
      switch (bpp) {
        case 1: unpaeth<1>(cur, prior, n); break;
        case 2: unpaeth<2>(cur, prior, n); break;
        case 3: unpaeth<3>(cur, prior, n); break;
        case 4: unpaeth<4>(cur, prior, n); break;
        case 6: unpaeth<6>(cur, prior, n); break;
        default: unpaeth<8>(cur, prior, n); break;
      }
      break;
    default:
      fail(CORRUPT, "bad adaptive filter value");
  }
}

void decode(const uint8_t* data, size_t n, const uint8_t* raw, size_t raw_len, bool color,
            uint8_t* out) {
  Png p = parse(data, n, false, nullptr);
  if (raw_len < p.raw_len) fail(CORRUPT, "not enough image data");
  const int ch = p.channels(), depth = p.depth, ctype = p.ctype;
  const int oc = color ? 3 : 1;
  const size_t bpp = (size_t)(p.pixel_bits() + 7) / 8;
  const int rgb_depth = ctype == 3 ? 8 : depth;
  const bool to_gray = !color && (ctype & 2);
  ToGray gray(p, rgb_depth);
  const unsigned scale = depth == 1 ? 255 : depth == 2 ? 85 : depth == 4 ? 17 : 1;
  std::vector<uint8_t> prior, cur;
  std::vector<uint16_t> samp;
  size_t pos = 0;
  for (int k = 0; k < 7; k++) {
    const int* a = kAdam7[k];
    uint32_t x0 = 0, y0 = 0, dx = 1, dy = 1, pw = p.width, ph = p.height;
    if (p.interlace) {
      x0 = a[0], y0 = a[1], dx = a[2], dy = a[3];
      pw = p.width > x0 ? (p.width - x0 + dx - 1) / dx : 0;
      ph = p.height > y0 ? (p.height - y0 + dy - 1) / dy : 0;
    }
    if (pw && ph) {
      const size_t rb = p.rowbytes(pw);
      prior.assign(rb, 0);
      cur.resize(rb);
      samp.resize((size_t)pw * ch);
      for (uint32_t y = 0; y < ph; y++) {
        int f = raw[pos];
        memcpy(cur.data(), raw + pos + 1, rb);
        pos += 1 + rb;
        unfilter(f, cur.data(), prior.data(), rb, bpp);
        uint8_t* orow = out + ((size_t)(y0 + y * dy) * p.width + x0) * oc;
        const size_t ostep = (size_t)dx * oc;
        if (depth == 8 && (ctype == 0 || (ctype == 2 && color))) {   // the common rows
          if (dx == 1 && oc == ch) {
            memcpy(orow, cur.data(), rb);
          } else {
            for (uint32_t x = 0; x < pw; x++)
              for (int c = 0; c < oc; c++) orow[x * ostep + c] = cur[(size_t)x * ch + (ch == 1 ? 0 : c)];
          }
          prior.swap(cur);
          continue;
        }
        // unpack to samples at the file's depth
        const size_t ns = (size_t)pw * ch;
        if (depth == 8) {
          for (size_t i = 0; i < ns; i++) samp[i] = cur[i];
        } else if (depth == 16) {
          for (size_t i = 0; i < ns; i++) samp[i] = (uint16_t)((cur[2 * i] << 8) | cur[2 * i + 1]);
        } else {
          const int per = 8 / depth, mask = (1 << depth) - 1;
          for (size_t i = 0; i < ns; i++)
            samp[i] = (uint16_t)((cur[i / per] >> (8 - depth * (int)(i % per + 1))) & mask);
        }
        for (uint32_t x = 0; x < pw; x++) {
          const uint16_t* s = samp.data() + (size_t)x * ch;
          uint8_t* o = orow + x * ostep;
          unsigned r, g, b;
          if (ctype == 3) {
            const uint8_t* c = p.palette[s[0]];
            r = c[0], g = c[1], b = c[2];
          } else if (ctype & 2) {
            r = s[0], g = s[1], b = s[2];
          } else {
            unsigned v = depth == 16 ? s[0] >> 8 : s[0] * scale;
            if (color) o[0] = o[1] = o[2] = (uint8_t)v;
            else o[0] = (uint8_t)v;
            continue;
          }
          if (to_gray) {
            o[0] = gray(r, g, b, rgb_depth);
          } else if (rgb_depth == 16) {
            o[0] = (uint8_t)(r >> 8), o[1] = (uint8_t)(g >> 8), o[2] = (uint8_t)(b >> 8);
          } else {
            o[0] = (uint8_t)r, o[1] = (uint8_t)g, o[2] = (uint8_t)b;
          }
        }
        prior.swap(cur);
      }
    }
    if (!p.interlace) break;
  }
}

int report(const Error& e, char* err, int errlen) {
  snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// Checks the file (every CRC), copies the IDAT payloads into idat (which
// holds n bytes; may be null) and gives the output size (channels 3 for a
// colour read, else 1), the EXIF orientation (0 when absent), the IDAT
// bytes and the size of the inflated image data.
int pv_png_info(const uint8_t* data, long n, int color, uint8_t* idat, int* h, int* w, int* ch,
                int* orientation, long* idat_len, long* raw_len, char* err, int errlen) {
  try {
    Png p = parse(data, (size_t)n, true, idat);
    *h = (int)p.height;
    *w = (int)p.width;
    *ch = color ? 3 : 1;
    *orientation = p.orientation;
    *idat_len = (long)p.idat_len;
    *raw_len = (long)p.raw_len;
    return OK;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{NOMEM, "out of memory"}, err, errlen);
  }
}

// Decodes the inflated image data raw (at least raw_len bytes of
// pv_png_info) into out, h * w * ch bytes.
int pv_png_decode(const uint8_t* data, long n, const uint8_t* raw, long raw_len, int color,
                  uint8_t* out, char* err, int errlen) {
  try {
    decode(data, (size_t)n, raw, (size_t)raw_len, color != 0, out);
    return OK;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{NOMEM, "out of memory"}, err, errlen);
  }
}

}  // extern "C"
