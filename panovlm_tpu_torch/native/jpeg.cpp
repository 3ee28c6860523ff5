// Baseline JPEG decoder (ITU-T T.81, sequential Huffman, 8-bit) that gives
// the bits of cv2.imread on libjpeg-turbo: the image stages read the Room
// and Floor panoramas and their masks (JPEG) on a machine without cv2.
//
// Where a textbook decoder would give other bits, this one follows libjpeg
// at its defaults (the decompression parameters cv2 leaves alone):
//   * IDCT: jidctint.c's jpeg_idct_islow (JDCT_ISLOW: CONST_BITS 13,
//     PASS1_BITS 2), its output wrapped through the range-limit table;
//   * chroma upsampling: jdsample.c's fancy (triangle) filters for h2v1 and
//     h2v2 (when the component is wider than 2 samples) and h1v2, with their
//     alternating biases; other integral factors replicate. The context
//     rows above the first and below the last sample row repeat that row
//     (jdmainct.c), and the last column's neighbour is itself;
//   * YCbCr -> RGB: jdcolor.c's fixed-point tables (SCALEBITS 16);
//   * a gray read of a YCbCr file copies the (upsampled) Y plane, and
//     decodes no chroma block after the entropy step;
//   * FF/00 stuffing, FF fill bytes (FF FF 00 is one FF data byte), zero
//     bits past the end of a scan, restart intervals that reset the DC
//     predictors, tables redefined between segments.
// The EXIF Orientation tag of the first APP1 segment is returned to the
// caller, which applies it as cv2's imread does.
//
// Outside the scope, each reported as "unsupported": progressive,
// arithmetic, lossless and hierarchical frames, 12-bit samples, 2 or 4
// components, RGB-coded 3-component files (Adobe transform 0 or component
// ids 'R','G','B'), non-integral sampling ratios, and a frame whose
// components are split over several scans.
//
// C interface (ctypes): pv_jpeg_info(data, n, color, &h, &w, &ch,
// &orientation, err, errlen), then pv_jpeg_decode(data, n, color, out, err,
// errlen) into the caller's h * w * ch bytes; each returns 0 ok,
// 1 unsupported, 2 corrupt, 3 no memory. No global state: frames decode on
// threads.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
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

// zigzag position -> natural (row-major) index; 16 extra entries keep a
// corrupt run inside the block, as jpeg_natural_order does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t look_len[1 << kLookBits];   // 0: code longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t val[256];
};

// jpeg_make_d_derived_tbl (jdhuff.c)
void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals, bool dc) {
  if (dc)   // a DC symbol is a bit count of at most 15
    for (int i = 0; i < nvals; i++)
      if (vals[i] > 15) fail(CORRUPT, "bad DC Huffman table");
  int size[257], code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l - 1]; i++) size[p++] = l;
  size[p] = 0;
  int c = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1 << si)) fail(CORRUPT, "bad Huffman table");
    c <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      t.valoffset[l] = p - code[p];
      p += counts[l - 1];
      t.maxcode[l] = code[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0xFFFFF;
  memset(t.val, 0, sizeof t.val);
  memcpy(t.val, vals, nvals);
  memset(t.look_len, 0, sizeof t.look_len);
  p = 0;
  for (int l = 1; l <= kLookBits; l++)
    for (int i = 0; i < counts[l - 1]; i++, p++) {
      int lookbits = code[p] << (kLookBits - l);
      for (int k = 0; k < (1 << (kLookBits - l)); k++) {
        t.look_len[lookbits + k] = (uint8_t)l;
        t.look_sym[lookbits + k] = vals[p];
      }
    }
  t.defined = true;
}

// The entropy-coded segment as a bit stream (jdhuff.c jpeg_fill_bit_buffer):
// at a marker it stops and supplies zero bits.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;
  int marker = -1;   // the marker that ended the data, once seen

  void fill() {
    while (n <= 56) {
      int b = 0;
      if (marker < 0) {
        if (p >= end) {
          marker = 0xD9;   // truncated file: as at EOI
        } else {
          b = *p++;
          if (b == 0xFF) {
            int c;
            do {
              c = p < end ? *p++ : 0xD9;
            } while (c == 0xFF);
            if (c != 0) {
              marker = c;
              b = 0;
            }
          }
        }
      }
      buf |= (uint64_t)b << (56 - n);
      n += 8;
    }
  }
  int get(int k) {   // k in 1..16
    if (n < k) fill();
    int v = (int)(buf >> (64 - k));
    buf <<= k;
    n -= k;
    return v;
  }
  int decode(const Huffman& t) {
    if (n < 16) fill();
    int look = (int)(buf >> (64 - kLookBits));
    int l = t.look_len[look];
    if (l) {
      buf <<= l;
      n -= l;
      return t.look_sym[look];
    }
    int code = get(kLookBits);
    l = kLookBits;
    while (l < 16 && code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (code > t.maxcode[l]) return 0;   // bad code: libjpeg warns, gives 0
    return t.val[(code + t.valoffset[l]) & 0xFF];
  }
  // at a restart boundary: drop the bits left in the byte and the RSTn
  // marker (searching for it when the data did not end at a marker)
  void restart() {
    buf = 0;
    n = 0;
    if (marker < 0) {
      while (p + 1 < end) {
        if (p[0] == 0xFF && p[1] != 0 && p[1] != 0xFF) {
          marker = p[1];
          p += 2;
          break;
        }
        p++;
      }
    }
    if (marker >= 0xD0 && marker <= 0xD7) marker = -1;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// jidctint.c jpeg_idct_islow
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// The post-IDCT range limit (jdmaster.c prepare_range_limit_table): the
// index is masked to 10 bits, so far-out values wrap as libjpeg's do.
inline uint8_t idct_limit(int64_t x) {
  int i = (int)(x & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    // the zero-AC shortcut of the column pass gives the same values
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, sh);
    w[56] = (int)descale(tmp10 - tmp3, sh);
    w[8] = (int)descale(tmp11 + tmp2, sh);
    w[48] = (int)descale(tmp11 - tmp2, sh);
    w[16] = (int)descale(tmp12 + tmp1, sh);
    w[40] = (int)descale(tmp12 - tmp1, sh);
    w[24] = (int)descale(tmp13 + tmp0, sh);
    w[32] = (int)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;      // Huffman table slots of the scan
  int bw = 0, bh = 0;      // blocks per row and column of its plane
  int dw = 0, dh = 0;      // downsampled_width / _height: its real samples
  bool needed = true;
  std::vector<uint8_t> plane;   // bw*8 x bh*8 samples
};

struct Decoder {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  uint16_t qt[4][64] = {};   // natural order
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  int restart_interval = 0;
  int width = 0, height = 0;
  std::vector<Component> comps;
  int hmax = 1, vmax = 1;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int orientation = 0;
  bool saw_app1 = false;

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {}

  int u8() {
    if (pos >= n) fail(CORRUPT, "unexpected end of file");
    return data[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // the marker after the current position, skipping FF fill bytes (and, as
  // libjpeg's next_marker does, any garbage before them)
  int next_marker() {
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do c = u8(); while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void parse_exif(const uint8_t* d, size_t len) {
    // cv2 (grfmt_jpeg.cpp): the first APP1 segment, 6 bytes after its
    // length field, as a TIFF header; tag 0x0112 of IFD0 is the orientation
    if (len < 6) return;
    d += 6;
    len -= 6;
    if (len < 8) return;
    bool le;
    if (d[0] == 'I' && d[1] == 'I') le = true;
    else if (d[0] == 'M' && d[1] == 'M') le = false;
    else return;
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
    if (ifd < 0) return;
    int count = g16((size_t)ifd);
    for (int i = 0; i < count; i++) {
      size_t e = (size_t)ifd + 2 + 12 * (size_t)i;
      int tag = g16(e);
      if (tag < 0) return;
      if (tag == 0x0112) {
        int v = g16(e + 8);
        if (v >= 0) orientation = v;
        return;
      }
    }
  }

  void read_segments() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail(CORRUPT, "not a JPEG file (no SOI)");
    pos = 2;
    bool have_frame = false;
    for (;;) {
      int m = next_marker();
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;   // no payload
      if (m == 0xD9) fail(CORRUPT, "no scan before EOI");
      int len = u16();
      if (len < 2 || pos + len - 2 > n) fail(CORRUPT, "bad segment length");
      const uint8_t* seg = data + pos;
      size_t seg_len = (size_t)len - 2;
      size_t next = pos + seg_len;
      switch (m) {
        case 0xC0:
        case 0xC1: {
          if (have_frame) fail(CORRUPT, "two frame headers");
          int precision = u8();
          height = u16();
          width = u16();
          int nc = u8();
          if (precision != 8)
            fail(UNSUPPORTED, std::to_string(precision) + "-bit samples");
          if (height == 0) fail(UNSUPPORTED, "the height is set by a DNL marker");
          if (width == 0) fail(CORRUPT, "zero width");
          if (nc != 1 && nc != 3)
            fail(UNSUPPORTED, std::to_string(nc) + " components (CMYK/YCCK or other)");
          for (int i = 0; i < nc; i++) {
            Component c;
            c.id = u8();
            int hv = u8();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = u8();
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
              fail(CORRUPT, "bad component parameters");
            comps.push_back(c);
          }
          have_frame = true;
          break;
        }
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail(UNSUPPORTED, "progressive JPEG");
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail(UNSUPPORTED, "lossless JPEG");
        case 0xC5:
          fail(UNSUPPORTED, "hierarchical JPEG");
        case 0xC9:
        case 0xCD:
        case 0xCC:
          fail(UNSUPPORTED, "arithmetic coding");
        case 0xC4: {
          size_t o = 0;
          while (o < seg_len) {
            if (o + 17 > seg_len) fail(CORRUPT, "bad DHT segment");
            int tc = seg[o] >> 4, th = seg[o] & 15;
            const uint8_t* counts = seg + o + 1;
            int total = 0;
            for (int i = 0; i < 16; i++) total += counts[i];
            if (tc > 1 || th > 3 || total > 256 || o + 17 + total > seg_len)
              fail(CORRUPT, "bad DHT segment");
            build_huffman(tc ? ac[th] : dc[th], counts, seg + o + 17, total, tc == 0);
            o += 17 + (size_t)total;
          }
          break;
        }
        case 0xDB: {
          size_t o = 0;
          while (o < seg_len) {
            int pq = seg[o] >> 4, tq = seg[o] & 15;
            size_t sz = pq ? 128 : 64;
            if (pq > 1 || tq > 3 || o + 1 + sz > seg_len) fail(CORRUPT, "bad DQT segment");
            for (int k = 0; k < 64; k++)
              qt[tq][kNatural[k]] =
                  pq ? (uint16_t)((seg[o + 1 + 2 * k] << 8) | seg[o + 2 + 2 * k]) : seg[o + 1 + k];
            qt_defined[tq] = true;
            o += 1 + sz;
          }
          break;
        }
        case 0xDD:
          if (seg_len < 2) fail(CORRUPT, "bad DRI segment");
          restart_interval = (seg[0] << 8) | seg[1];
          break;
        case 0xE0:
          if (seg_len >= 14 && memcmp(seg, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xE1:
          if (!saw_app1) {
            saw_app1 = true;
            parse_exif(seg, seg_len);
          }
          break;
        case 0xEE:
          if (seg_len >= 12 && memcmp(seg, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = seg[11];
          }
          break;
        case 0xDC:
          fail(UNSUPPORTED, "DNL marker");
        case 0xDA:
          if (!have_frame) fail(CORRUPT, "scan before the frame header");
          pos -= 2;   // back to the length: decode_scan reads the header
          return;
        default:
          if (m >= 0xC8 && m <= 0xCF) fail(UNSUPPORTED, "arithmetic or extension frame");
          break;   // APPn, COM, DAC, ...: skipped
      }
      pos = next;
    }
  }

  void check_colour_space() {
    if (comps.size() != 3) return;
    bool rgb;
    if (saw_jfif) rgb = false;
    else if (saw_adobe) rgb = adobe_transform == 0;
    else rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
    if (rgb) fail(UNSUPPORTED, "RGB-coded colour (no YCbCr transform)");
  }

  void layout(bool color) {
    for (auto& c : comps) {
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v) fail(UNSUPPORTED, "non-integral sampling ratio");
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      if (!qt_defined[c.tq]) fail(CORRUPT, "undefined quantisation table");
    }
    // a gray read of a colour file needs the luma component only
    if (!color)
      for (size_t i = 1; i < comps.size(); i++) comps[i].needed = false;
  }

  void decode_scan() {
    u16();   // length
    int ns = u8();
    if (ns < 1 || ns > 4) fail(CORRUPT, "bad scan header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (auto& k : comps)
        if (k.id == id) c = &k;
      if (!c) fail(CORRUPT, "scan names an unknown component");
      c->td = t >> 4;
      c->ta = t & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
        fail(CORRUPT, "undefined Huffman table");
      sc.push_back(c);
    }
    int ss = u8(), se = u8(), ahl = u8();
    if (ss != 0 || se != 63 || ahl != 0) fail(UNSUPPORTED, "spectral selection in a sequential scan");
    if (sc.size() != comps.size())
      fail(UNSUPPORTED, "the components are split over several scans");

    int mcux, mcuy;
    if (sc.size() == 1) {   // non-interleaved: one block per MCU
      Component& c = *sc[0];
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      mcux = c.bw;
      mcuy = c.bh;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
      for (auto* c : sc) {
        c->bw = mcux * c->h;
        c->bh = mcuy * c->v;
      }
    }
    for (auto* c : sc)
      if (c->needed) c->plane.assign((size_t)c->bw * 8 * (size_t)c->bh * 8, 0);

    Bits bits{data + pos, data + n};
    int pred[4] = {0, 0, 0, 0};
    int16_t blk[64];
    const int64_t total = (int64_t)mcux * mcuy;
    int64_t left = restart_interval;
    for (int64_t m = 0; m < total; m++) {
      if (restart_interval) {
        if (left == 0) {
          bits.restart();
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          left = restart_interval;
        }
        left--;
      }
      int mx = (int)(m % mcux), my = (int)(m / mcux);
      for (size_t ci = 0; ci < sc.size(); ci++) {
        Component& c = *sc[ci];
        int nh = sc.size() == 1 ? 1 : c.h, nv = sc.size() == 1 ? 1 : c.v;
        for (int by = 0; by < nv; by++)
          for (int bx = 0; bx < nh; bx++) {
            memset(blk, 0, sizeof blk);
            int s = bits.decode(dc[c.td]);
            int diff = s ? extend(bits.get(s), s) : 0;
            pred[ci] += diff;
            blk[0] = (int16_t)pred[ci];
            const Huffman& at = ac[c.ta];
            for (int k = 1; k < 64; k++) {
              int rs = bits.decode(at);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[kNatural[k]] = (int16_t)extend(bits.get(s), s);
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
            if (!c.needed) continue;
            size_t stride = (size_t)c.bw * 8;
            size_t row = (size_t)(my * nv + by) * 8, col = (size_t)(mx * nh + bx) * 8;
            idct_islow(blk, qt[c.tq], c.plane.data() + row * stride + col, (int)stride);
          }
      }
    }
  }
};

// Row y of one component, upsampled to the output width (jdsample.c at its
// defaults). Returns a pointer into the plane or into `line`.
const uint8_t* upsample_row(const Component& c, int hmax, int vmax, int width, int y,
                            uint8_t* line) {
  const int hs = hmax / c.h, vs = vmax / c.v;
  const size_t stride = (size_t)c.bw * 8;
  const uint8_t* p = c.plane.data();
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int r) { return p + (size_t)(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * stride; };
  if (hs == 1 && vs == 1) return row(y);
  uint8_t* o = line;
  if (hs == 2 && vs == 1 && dw > 2) {            // h2v1_fancy_upsample
    const uint8_t* in = row(y);
    o[0] = in[0];
    o[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; x++) {
      int v = in[x] * 3;
      o[2 * x] = (uint8_t)((v + in[x - 1] + 1) >> 2);
      o[2 * x + 1] = (uint8_t)((v + in[x + 1] + 2) >> 2);
    }
    o[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
    o[2 * dw - 1] = in[dw - 1];
  } else if (hs == 1 && vs == 2) {               // h1v2_fancy_upsample
    int iy = y >> 1;
    const uint8_t* in0 = row(iy);
    const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
    int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < width; x++) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
  } else if (hs == 2 && vs == 2 && dw > 2) {     // h2v2_fancy_upsample
    int iy = y >> 1;
    const uint8_t* in0 = row(iy);
    const uint8_t* in1 = row((y & 1) ? iy + 1 : iy - 1);
    int thiscol = in0[0] * 3 + in1[0];
    int nextcol = in0[1] * 3 + in1[1];
    o[0] = (uint8_t)((thiscol * 4 + 8) >> 4);
    o[1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
    int lastcol = thiscol;
    thiscol = nextcol;
    for (int x = 2; x < dw; x++) {
      nextcol = in0[x] * 3 + in1[x];
      o[2 * x - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
      o[2 * x - 1] = (uint8_t)((thiscol * 3 + nextcol + 7) >> 4);
      lastcol = thiscol;
      thiscol = nextcol;
    }
    o[2 * dw - 2] = (uint8_t)((thiscol * 3 + lastcol + 8) >> 4);
    o[2 * dw - 1] = (uint8_t)((thiscol * 4 + 7) >> 4);
  } else {                                       // h2v1/h2v2 (narrow), int_upsample: replicate
    const uint8_t* in = p + (size_t)(y / vs) * stride;
    for (int x = 0; x < width; x++) o[x] = in[x / hs];
  }
  return o;
}

// jdcolor.c build_ycc_rgb_table
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};

inline uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

Decoder header(const uint8_t* data, size_t n, bool color) {
  Decoder d(data, n);
  d.read_segments();
  d.check_colour_space();
  d.layout(color);
  return d;
}

// decodes into out (h x w x ch, ch = 3 for colour, else 1)
void decode(const uint8_t* data, size_t n, bool color, uint8_t* out) {
  Decoder d = header(data, n, color);
  d.decode_scan();
  const int h = d.height, w = d.width;
  const size_t lw = (size_t)w + 32;   // upsampled rows reach 2 * dw >= w
  std::vector<uint8_t> lines(3 * lw);
  static const YccTables t;
  for (int y = 0; y < h; y++) {
    const uint8_t* yr = upsample_row(d.comps[0], d.hmax, d.vmax, w, y, lines.data());
    if (!color) {   // JCS_GRAYSCALE: the Y plane
      memcpy(out + (size_t)y * w, yr, (size_t)w);
      continue;
    }
    uint8_t* o = out + (size_t)y * w * 3;
    if (d.comps.size() == 1) {   // gray_rgb_convert
      for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = yr[x];
      continue;
    }
    const uint8_t* cbr = upsample_row(d.comps[1], d.hmax, d.vmax, w, y, lines.data() + lw);
    const uint8_t* crr = upsample_row(d.comps[2], d.hmax, d.vmax, w, y, lines.data() + 2 * lw);
    for (int x = 0; x < w; x++) {   // ycc_rgb_convert
      int yy = yr[x], cb = cbr[x], cr = crr[x];
      o[3 * x] = clamp255(yy + t.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
    }
  }
}

int report(const Error& e, char* err, int errlen) {
  snprintf(err, (size_t)errlen, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

// The output size of a decode: height, width, channels (3 for a colour read,
// else 1) and the EXIF orientation (0 when absent).
int pv_jpeg_info(const uint8_t* data, long n, int color, int* h, int* w, int* ch,
                 int* orientation, char* err, int errlen) {
  try {
    Decoder d = header(data, (size_t)n, color != 0);
    *h = d.height;
    *w = d.width;
    *ch = color ? 3 : 1;
    *orientation = d.orientation;
    return OK;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{NOMEM, "out of memory"}, err, errlen);
  }
}

// Decodes into out, which holds the h * w * ch bytes that pv_jpeg_info gave.
int pv_jpeg_decode(const uint8_t* data, long n, int color, uint8_t* out, char* err, int errlen) {
  try {
    decode(data, (size_t)n, color != 0, out);
    return OK;
  } catch (const Error& e) {
    return report(e, err, errlen);
  } catch (const std::bad_alloc&) {
    return report(Error{NOMEM, "out of memory"}, err, errlen);
  }
}

}  // extern "C"
