// JPEG decoder (ITU-T T.81, Huffman coding, 8-bit) that gives the bits of
// cv2.imread on libjpeg-turbo: the image stages read the Room and Floor
// panoramas and their masks (JPEG) on a machine without cv2.
//
// Read, as libjpeg-turbo 3.1 at its defaults (the decompression parameters
// cv2 leaves alone) and cv2's own colour handling:
//   * baseline and extended sequential frames (SOF0, SOF1) with one scan,
//     decoded block by block into the sample planes; and frames whose
//     components are split over several (non-interleaved) scans, which
//     walk each component's own blocks;
//   * progressive frames (SOF2): jdphuff.c's DC first, DC refine, AC first
//     (with EOB runs) and AC refine scans into a whole-image coefficient
//     buffer (jdcoefct.c), libjpeg's coef_bits bookkeeping per component
//     and coefficient, and after the last scan (or where the file ends, as
//     a download cut after its k-th scan leaves it) the block smoothing of
//     decompress_smooth_data when a scan left coefficient bits unsent; a
//     complete script leaves none, and its bits are those of a baseline
//     file with the same quantised coefficients;
//   * one component (gray), three (YCbCr; RGB when an Adobe APP14 has
//     transform 0 or, with no JFIF or Adobe marker, the component ids are
//     'R','G','B') and four (CMYK; YCCK when the Adobe transform is not 0),
//     a colour read converting CMYK as cv2's icvCvt_CMYK2BGR_8u_C4C3R
//     (c' = k - ((255 - c) k >> 8)) and a gray read as
//     icvCvt_CMYK2Gray_8u_C4C1R ((4899 c' + 9617 m' + 1868 y' + 8192) >> 14);
//     YCCK goes to CMYK through jdcolor.c's ycck_cmyk_convert first. A gray
//     read of YCbCr is the Y plane (no chroma block is transformed), of RGB
//     jdcolor.c's rgb_gray_convert (rounded tables);
//   * IDCT: jidctint.c's jpeg_idct_islow (JDCT_ISLOW: CONST_BITS 13,
//     PASS1_BITS 2), its output wrapped through the range-limit table;
//   * chroma upsampling: jdsample.c's fancy (triangle) filters for h2v1 and
//     h2v2 (when the component is wider than 2 samples) and h1v2, with their
//     alternating biases; other integral factors replicate. The context
//     rows above the first and below the last sample row repeat that row
//     (jdmainct.c), and the last column's neighbour is itself;
//   * YCbCr -> RGB: jdcolor.c's fixed-point tables (SCALEBITS 16);
//   * FF/00 stuffing, FF fill bytes (FF FF 00 is one FF data byte), zero
//     bits past the end of a scan and the rest of a restart interval left as
//     it stands once the data ran out (libjpeg's insufficient_data), restart
//     intervals that reset the DC predictors and the EOB run, tables
//     redefined between segments and scans, quantisation tables latched at
//     each component's first scan, the standard Huffman tables in slots 0
//     and 1 where a file defines none (jstdhuff.c).
// The EXIF Orientation tag of the first APP1 segment is returned to the
// caller, which applies it as cv2's imread does.
//
// Refused, each reported as "unsupported" with the codes below: arithmetic
// coding (SOF9-SOF15, which cv2 reads: queued in ROADMAP.md), lossless and
// hierarchical frames, 12-bit samples (cv2 reads neither), 2 components (cv2
// gives no image), non-integral sampling ratios in a component the read
// upsamples (libjpeg refuses them; a gray read of YCbCr needs Y only), a
// height set by a DNL marker.
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

// jstdhuff.c: the tables of T.81 Annex K.3 (code counts per length 1..16)
const uint8_t kDcLumaCounts[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaCounts[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaCounts[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcChromaCounts[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// The entropy-coded segment as a bit stream (jdhuff.c jpeg_fill_bit_buffer):
// at a marker it stops and supplies zero bits. Consuming one of those sets
// `insufficient`, after which libjpeg decodes no further MCU until the next
// restart marker.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;
  int fake = 0;             // zero bits supplied past the data, at the end of buf
  int marker = -1;          // the marker that ended the data, once seen
  bool insufficient = false;

  void fill() {
    while (n <= 56) {
      int b = 0;
      bool real = false;
      if (marker < 0) {
        if (p >= end) {
          marker = 0xD9;   // truncated file: as at EOI
        } else {
          b = *p++;
          real = true;
          if (b == 0xFF) {
            int c;
            do {
              c = p < end ? *p++ : 0xD9;
            } while (c == 0xFF);
            if (c != 0) {
              marker = c;
              b = 0;
              real = false;
            }
          }
        }
      }
      if (!real) fake += 8;
      buf |= (uint64_t)b << (56 - n);
      n += 8;
    }
  }
  void consume(int k) {
    buf <<= k;
    n -= k;
    if (n < fake) {
      insufficient = true;
      fake = n;
    }
  }
  int get(int k) {   // k in 1..16
    if (n < k) fill();
    int v = (int)(buf >> (64 - k));
    consume(k);
    return v;
  }
  int decode(const Huffman& t) {
    if (n < 16) fill();
    int look = (int)(buf >> (64 - kLookBits));
    int l = t.look_len[look];
    if (l) {
      consume(l);
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
  // marker (searching for it when the data did not end at a marker); the
  // data flows again unless another marker stands there
  void restart() {
    buf = 0;
    n = 0;
    fake = 0;
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
    if (marker >= 0xD0 && marker <= 0xD7) {
      marker = -1;
      insufficient = false;
    }
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

enum ColourSpace { GRAY, YCC, RGB, CMYK, YCCK };

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;      // Huffman table slots of the scan
  int bw = 0, bh = 0;      // width_in_blocks / height_in_blocks
  int pbw = 0, pbh = 0;    // rounded up to the sampling factors: the MCU grid
  int dw = 0, dh = 0;      // downsampled_width / _height: its real samples
  bool needed = true;
  bool latched = false;    // quantisation table latched at its first scan
  uint16_t q[64];
  int coef_bits[64], prev_coef_bits[64];   // jdphuff.c's bookkeeping (-1: no scan yet)
  std::vector<int16_t> coef;               // pbw x pbh blocks of 64, natural order
  std::vector<uint8_t> plane;              // pbw*8 x pbh*8 samples
  int16_t* block(int bx, int by) { return coef.data() + ((size_t)by * pbw + bx) * 64; }
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
  bool progressive = false;
  std::vector<Component> comps;
  int hmax = 1, vmax = 1;
  int mcux = 0, mcuy = 0;    // MCUs of an interleaved scan; mcuy = total_iMCU_rows
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  ColourSpace space = GRAY;
  int orientation = 0;
  bool saw_app1 = false;
  // the scan being read
  std::vector<Component*> sc;
  int Ss = 0, Se = 63, Ah = 0, Al = 0;
  int scans = 0;             // input_scan_number
  int last_good_row = 0;     // the last iMCU row whose decoding began with data left

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

  void read_frame(bool prog) {
    if (!comps.empty()) fail(CORRUPT, "two frame headers");
    progressive = prog;
    int precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (precision != 8) fail(UNSUPPORTED, std::to_string(precision) + "-bit samples");
    if (height == 0) fail(UNSUPPORTED, "the height is set by a DNL marker");
    if (width == 0) fail(CORRUPT, "zero width");
    // libjpeg's JPEG_MAX_DIMENSION, and cv2's limit of 2^30 pixels
    if (width > 65500 || height > 65500 || (int64_t)width * height > ((int64_t)1 << 30))
      fail(CORRUPT, "image larger than libjpeg or cv2 read");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(UNSUPPORTED, std::to_string(nc) + " components");
    for (int i = 0; i < nc; i++) {
      Component c;
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail(CORRUPT, "bad component parameters");
      for (int k = 0; k < 64; k++) c.coef_bits[k] = c.prev_coef_bits[k] = -1;
      memset(c.q, 0, sizeof c.q);
      comps.push_back(c);
    }
  }

  // One marker segment that may stand before or between scans (tables,
  // restart interval, APPn, COM); returns false for the others.
  bool table_segment(int m, const uint8_t* seg, size_t seg_len) {
    switch (m) {
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
        return true;
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
        return true;
      }
      case 0xDD:
        if (seg_len < 2) fail(CORRUPT, "bad DRI segment");
        restart_interval = (seg[0] << 8) | seg[1];
        return true;
      case 0xDC:   // DNL: libjpeg skips it
        return true;
      default:
        return (m >= 0xE0 && m <= 0xEF) || m == 0xFE;   // APPn, COM
    }
  }

  // Marker segments up to the first SOS: the frame, the tables, JFIF, EXIF
  // and Adobe markers. Leaves pos at the SOS segment's length.
  void read_segments() {
    if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) fail(CORRUPT, "not a JPEG file (no SOI)");
    pos = 2;
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
        case 0xC1:
        case 0xC2:
          read_frame(m == 0xC2);
          break;
        case 0xC3:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail(UNSUPPORTED, "lossless JPEG");
        case 0xC5:
        case 0xC6:
        case 0xCD:
        case 0xCE:
          fail(UNSUPPORTED, "hierarchical JPEG");
        case 0xC9:
        case 0xCA:
          fail(UNSUPPORTED, "arithmetic coding");
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
        case 0xDA:
          if (comps.empty()) fail(CORRUPT, "scan before the frame header");
          pos -= 2;   // back to the length: read_scan_header reads it
          return;
        default:
          if (m >= 0xC8 && m <= 0xCF) fail(UNSUPPORTED, "arithmetic coding");
          table_segment(m, seg, seg_len);   // anything else is skipped
          break;
      }
      pos = next;
    }
  }

  // jdapimin.c default_decompress_parms
  void check_colour_space() {
    if (comps.size() == 1) {
      space = GRAY;
    } else if (comps.size() == 3) {
      bool rgb;
      if (saw_jfif) rgb = false;
      else if (saw_adobe) rgb = adobe_transform == 0;
      else rgb = comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
      space = rgb ? RGB : YCC;
    } else {
      space = saw_adobe && adobe_transform == 0 ? CMYK : (saw_adobe ? YCCK : CMYK);
    }
  }

  void layout(bool color) {
    for (auto& c : comps) {
      hmax = c.h > hmax ? c.h : hmax;
      vmax = c.v > vmax ? c.v : vmax;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + 7) / 8;
      c.bh = (c.dh + 7) / 8;
      c.pbw = mcux * c.h;
      c.pbh = mcuy * c.v;
    }
    // a gray read of YCbCr (or gray) needs the luma component only
    if (!color && (space == YCC || space == GRAY))
      for (size_t i = 1; i < comps.size(); i++) comps[i].needed = false;
    // jdsample.c refuses a non-integral ratio in the components it upsamples
    for (auto& c : comps)
      if (c.needed && (hmax % c.h || vmax % c.v)) fail(UNSUPPORTED, "non-integral sampling ratio");
  }

  // jstdhuff.c: the standard tables where the file defined none by the
  // first scan
  void default_tables() {
    if (!dc[0].defined) build_huffman(dc[0], kDcLumaCounts, kDcVals, 12, true);
    if (!dc[1].defined) build_huffman(dc[1], kDcChromaCounts, kDcVals, 12, true);
    if (!ac[0].defined) build_huffman(ac[0], kAcLumaCounts, kAcLumaVals, 162, false);
    if (!ac[1].defined) build_huffman(ac[1], kAcChromaCounts, kAcChromaVals, 162, false);
  }

  // jdmarker.c get_sos, then the checks of jdinput.c and jdphuff.c
  void read_scan_header() {
    int len = u16();
    int ns = u8();
    if (len != ns * 2 + 6 || ns < 1 || ns > 4) fail(CORRUPT, "bad scan header");
    sc.clear();
    for (int i = 0; i < ns; i++) {
      int id = u8(), t = u8();
      Component* c = nullptr;
      for (auto& k : comps)
        if (k.id == id) c = &k;
      if (!c) fail(CORRUPT, "scan names an unknown component");
      for (auto* k : sc)
        if (k == c) fail(CORRUPT, "a component twice in a scan");
      c->td = t >> 4;
      c->ta = t & 15;
      sc.push_back(c);
    }
    Ss = u8();
    Se = u8();
    int a = u8();
    Ah = a >> 4;
    Al = a & 15;
    scans++;
    int blocks = 0;
    for (auto* c : sc) blocks += ns == 1 ? 1 : c->h * c->v;
    if (blocks > 10) fail(CORRUPT, "too many blocks in an MCU");
    for (auto* c : sc) {   // jdinput.c latch_quant_tables
      if (c->latched) continue;
      if (!qt_defined[c->tq]) fail(CORRUPT, "undefined quantisation table");
      memcpy(c->q, qt[c->tq], sizeof c->q);
      c->latched = true;
    }
    if (!progressive) {   // Ss, Se, Ah, Al are not checked: libjpeg only warns
      for (auto* c : sc)
        if (c->td > 3 || c->ta > 3 || !dc[c->td].defined || !ac[c->ta].defined)
          fail(CORRUPT, "undefined Huffman table");
      return;
    }
    bool dc_band = Ss == 0, bad = false;
    if (dc_band) bad = Se != 0;
    else bad = Ss > Se || Se > 63 || ns != 1;
    if (Ah != 0 && Al != Ah - 1) bad = true;
    if (Al > 13) bad = true;
    if (bad) fail(CORRUPT, "bad progression parameters");
    for (auto* c : sc) {
      if (dc_band ? (Ah == 0 && (c->td > 3 || !dc[c->td].defined))
                  : (c->ta > 3 || !ac[c->ta].defined))
        fail(CORRUPT, "undefined Huffman table");
      int lo = Ss < 1 ? Ss : 1, hi = Se > 9 ? Se : 9;
      for (int k = lo; k <= hi; k++) c->prev_coef_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
      for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
    }
  }

  // The MCUs of the current scan in order: calls mcu(mx, my) after the
  // restart bookkeeping; `direct` decodes regardless of insufficient data
  // (the caller then sees zero blocks).
  template <class F>
  void each_mcu(Bits& bits, F&& mcu, int* pred, int* eobrun) {
    int nx, ny;
    if (sc.size() == 1) {
      nx = sc[0]->bw;
      ny = sc[0]->bh;
    } else {
      nx = mcux;
      ny = mcuy;
    }
    const int rows_per_imcu = sc.size() == 1 ? sc[0]->v : 1;
    int64_t left = restart_interval;
    for (int my = 0; my < ny; my++)
      for (int mx = 0; mx < nx; mx++) {
        if (restart_interval) {
          if (left == 0) {
            bits.restart();
            for (int k = 0; k < 4; k++) pred[k] = 0;
            *eobrun = 0;
            left = restart_interval;
          }
          left--;
        }
        if (!bits.insufficient) last_good_row = my / rows_per_imcu;
        mcu(mx, my);
      }
  }

  // A sequential scan. direct: the frame's only scan, each block
  // transformed into its plane as it is decoded; else into the buffer.
  void sequential_scan(Bits& bits, bool direct) {
    int pred[4] = {0, 0, 0, 0}, eobrun = 0;
    int16_t blk[64];
    const bool one = sc.size() == 1;
    each_mcu(bits, [&](int mx, int my) {
      const bool skip = bits.insufficient;   // decided once per MCU, as libjpeg does
      for (size_t ci = 0; ci < sc.size(); ci++) {
        Component& c = *sc[ci];
        int nh = one ? 1 : c.h, nv = one ? 1 : c.v;
        for (int by = 0; by < nv; by++)
          for (int bx = 0; bx < nh; bx++) {
            int x = mx * nh + bx, y = my * nv + by;
            int16_t* b = direct ? blk : c.block(x, y);
            if (direct) memset(blk, 0, sizeof blk);
            if (!skip) {
              int s = bits.decode(dc[c.td]);
              int diff = s ? extend(bits.get(s), s) : 0;
              pred[ci] += diff;
              b[0] = (int16_t)pred[ci];
              const Huffman& at = ac[c.ta];
              for (int k = 1; k < 64; k++) {
                int rs = bits.decode(at);
                int r = rs >> 4;
                s = rs & 15;
                if (s) {
                  k += r;
                  b[kNatural[k]] = (int16_t)extend(bits.get(s), s);
                } else {
                  if (r != 15) break;
                  k += 15;
                }
              }
            }
            if (direct && c.needed) {
              size_t stride = (size_t)c.pbw * 8;
              idct_islow(blk, c.q, c.plane.data() + (size_t)y * 8 * stride + (size_t)x * 8,
                         (int)stride);
            }
          }
      }
    }, pred, &eobrun);
  }

  // jdphuff.c's four decoders
  void progressive_scan(Bits& bits) {
    int pred[4] = {0, 0, 0, 0}, eobrun = 0;
    const bool one = sc.size() == 1;
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    if (Ss == 0) {   // DC first / refine: interleaved or not
      each_mcu(bits, [&](int mx, int my) {
        if (bits.insufficient && Ah == 0) return;
        for (size_t ci = 0; ci < sc.size(); ci++) {
          Component& c = *sc[ci];
          int nh = one ? 1 : c.h, nv = one ? 1 : c.v;
          for (int by = 0; by < nv; by++)
            for (int bx = 0; bx < nh; bx++) {
              int16_t* b = c.block(mx * nh + bx, my * nv + by);
              if (Ah == 0) {
                int s = bits.decode(dc[c.td]);
                int diff = s ? extend(bits.get(s), s) : 0;
                pred[ci] += diff;
                b[0] = (int16_t)(int)((unsigned)pred[ci] << Al);
              } else if (bits.get(1)) {
                b[0] = (int16_t)(b[0] | p1);
              }
            }
        }
      }, pred, &eobrun);
      return;
    }
    Component& c = *sc[0];
    const Huffman& t = ac[c.ta];
    if (Ah == 0) {   // AC first
      each_mcu(bits, [&](int mx, int my) {
        if (bits.insufficient) return;
        if (eobrun > 0) {
          eobrun--;
          return;
        }
        int16_t* b = c.block(mx, my);
        for (int k = Ss; k <= Se; k++) {
          int rs = bits.decode(t);
          int r = rs >> 4, s = rs & 15;
          if (s) {
            k += r;
            b[kNatural[k]] = (int16_t)(int)((unsigned)extend(bits.get(s), s) << Al);
          } else if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += bits.get(r);
            eobrun--;
            break;
          }
        }
      }, pred, &eobrun);
      return;
    }
    // AC refine
    each_mcu(bits, [&](int mx, int my) {
      if (bits.insufficient) return;
      int16_t* b = c.block(mx, my);
      auto correct = [&](int16_t& coef) {
        if (bits.get(1) && (coef & p1) == 0) coef = (int16_t)(coef >= 0 ? coef + p1 : coef + m1);
      };
      int k = Ss;
      if (eobrun == 0) {
        for (; k <= Se; k++) {
          int rs = bits.decode(t);
          int r = rs >> 4, s = rs & 15;
          if (s) {   // a newly nonzero coefficient (s should be 1)
            s = bits.get(1) ? p1 : m1;
          } else if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += bits.get(r);
            break;
          }
          // skip the nonzero history (appending correction bits) and r zeros
          do {
            int16_t& coef = b[kNatural[k]];
            if (coef != 0) {
              correct(coef);
            } else {
              if (--r < 0) break;
            }
            k++;
          } while (k <= Se);
          if (s) b[kNatural[k]] = (int16_t)s;
        }
      }
      if (eobrun > 0) {
        for (; k <= Se; k++) {
          int16_t& coef = b[kNatural[k]];
          if (coef != 0) correct(coef);
        }
        eobrun--;
      }
    }, pred, &eobrun);
  }

  // After the entropy-coded data of a scan: the marker that ended it, then
  // the segments up to the next SOS (true) or EOI (false).
  bool next_scan(Bits& bits) {
    int m;
    if (bits.marker >= 0) {
      m = bits.marker;
      pos = (size_t)(bits.p - data);
    } else {
      pos = (size_t)(bits.p - data);
      m = next_marker_or_eoi();
    }
    for (;;) {
      if (m == 0xD9) return false;
      if (m == 0xDA) {
        read_scan_header();
        return true;
      }
      if (!((m >= 0xD0 && m <= 0xD7) || m == 0xD8 || m == 0x01)) {
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
          fail(CORRUPT, "a second frame header");
        if (pos + 2 > n) return false;
        int len = u16();
        if (len < 2 || pos + len - 2 > n) return false;   // cut: as at EOI
        table_segment(m, data + pos, (size_t)len - 2);
        pos += (size_t)len - 2;
      }
      if (pos >= n) return false;
      m = next_marker_or_eoi();
    }
  }
  int next_marker_or_eoi() {
    while (pos < n) {
      if (data[pos++] != 0xFF) continue;
      while (pos < n && data[pos] == 0xFF) pos++;
      if (pos >= n) break;
      int c = data[pos++];
      if (c != 0) return c;
    }
    return 0xD9;   // end of file: libjpeg inserts an EOI
  }
};

// jdcoefct.c smoothing_ok: every component latched, its first ten
// quantisation values nonzero and its DC known, and some coefficient of
// the first ten of some component not fully known. Fills the latches.
bool smoothing_ok(Decoder& d, std::vector<int>& latch, std::vector<int>& prev_latch) {
  if (!d.progressive) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  latch.assign(d.comps.size() * 10, 0);
  prev_latch.assign(d.comps.size() * 10, 0);
  for (size_t ci = 0; ci < d.comps.size(); ci++) {
    const Component& c = d.comps[ci];
    if (!c.latched) return false;
    for (int k = 0; k < 10; k++)
      if (c.q[kPos[k]] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    latch[ci * 10] = c.coef_bits[0];
    for (int k = 1; k < 10; k++) {
      prev_latch[ci * 10 + k] = d.scans > 1 ? c.prev_coef_bits[k] : -1;
      latch[ci * 10 + k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// One estimate of decompress_smooth_data: applied where the coefficient is
// still zero and not known to be exact; Al caps its magnitude
inline void estimate(int16_t& w, int al, int64_t q00, int64_t q, int64_t sum) {
  if (al == 0 || w != 0) return;
  int64_t num = q00 * sum;
  int pred;
  if (num >= 0) {
    pred = (int)(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = (int)(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  w = (int16_t)pred;
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1): the IDCT of one
// component with the low coefficients of each block estimated from the DC
// values of its 5 x 5 neighbourhood, as libjpeg walks the iMCU rows.
void smooth_component(Decoder& d, Component& c, const int* cur_bits, const int* prev_bits) {
  const int T = d.mcuy, v = c.v;
  const size_t stride = (size_t)c.pbw * 8;
  int16_t ws[64];
  const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16], Q11 = c.q[9],
                Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10], Q21 = c.q[17], Q30 = c.q[24];
  for (int oi = 0; oi < T; oi++) {
    const int block_rows = oi < T - 1 ? v : (c.bh % v ? c.bh % v : v);
    const int* cb = oi > d.last_good_row ? prev_bits : cur_bits;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && cb[k] == -1;
    const int image_block_rows = block_rows * T;
    for (int br = 0; br < block_rows; br++) {
      const int R = oi * v + br, ibr = oi * block_rows + br;
      const int prev = ibr > 0 ? R - 1 : R;
      const int pprev = ibr > 1 ? R - 2 : prev;
      const int next = ibr < image_block_rows - 1 ? R + 1 : R;
      const int nnext = ibr < image_block_rows - 2 ? R + 2 : next;
      const int rows[5] = {pprev, prev, R, next, nnext};
      for (int C = 0; C < c.bw; C++) {
        int DC[26];   // DC[1..25]: the 5 x 5 neighbourhood, row-major, DC[13] this block
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 5; j++) {
            int x = C + j - 2;
            x = x < 0 ? 0 : (x > c.bw - 1 ? c.bw - 1 : x);
            DC[1 + 5 * i + j] = c.block(x, rows[i])[0];
          }
        memcpy(ws, c.block(C, R), sizeof ws);
        if (change_dc) {
          estimate(ws[1], cb[1], Q00, Q01,
                   -DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] - 13 * DC[9] +
                       3 * DC[10] - 3 * DC[11] + 38 * DC[12] - 38 * DC[14] + 3 * DC[15] -
                       3 * DC[16] + 13 * DC[17] - 13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] +
                       DC[24] + DC[25]);
          estimate(ws[8], cb[2], Q00, Q10,
                   -DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] - DC[6] + 13 * DC[7] +
                       38 * DC[8] + 13 * DC[9] - DC[10] + DC[16] - 13 * DC[17] - 38 * DC[18] -
                       13 * DC[19] + DC[20] + DC[21] + 3 * DC[22] + 3 * DC[23] + 3 * DC[24] +
                       DC[25]);
          estimate(ws[16], cb[3], Q00, Q20,
                   DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] - 14 * DC[13] -
                       5 * DC[14] + 2 * DC[17] + 7 * DC[18] + 2 * DC[19] + DC[23]);
          estimate(ws[9], cb[4], Q00, Q11,
                   -DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] + 9 * DC[19] + DC[21] -
                       DC[25]);
          estimate(ws[2], cb[5], Q00, Q02,
                   2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] - 14 * DC[13] +
                       7 * DC[14] + DC[15] + 2 * DC[17] - 5 * DC[18] + 2 * DC[19]);
          estimate(ws[3], cb[6], Q00, Q03,
                   DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] - DC[19]);
          estimate(ws[10], cb[7], Q00, Q12,
                   DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] - DC[19]);
          estimate(ws[17], cb[8], Q00, Q21,
                   DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] - DC[19]);
          estimate(ws[24], cb[9], Q00, Q30,
                   DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] - DC[19]);
          // the DC itself, a weighted mean of the neighbourhood
          int64_t num = Q00 * (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] -
                               6 * DC[6] + 6 * DC[7] + 42 * DC[8] + 6 * DC[9] - 6 * DC[10] -
                               8 * DC[11] + 42 * DC[12] + 152 * DC[13] + 42 * DC[14] -
                               8 * DC[15] - 6 * DC[16] + 6 * DC[17] + 42 * DC[18] + 6 * DC[19] -
                               6 * DC[20] - 2 * DC[21] - 6 * DC[22] - 8 * DC[23] - 6 * DC[24] -
                               2 * DC[25]);
          int pred = num >= 0 ? (int)(((Q00 << 7) + num) / (Q00 << 8))
                              : -(int)(((Q00 << 7) - num) / (Q00 << 8));
          ws[0] = (int16_t)pred;
        } else {
          estimate(ws[1], cb[1], Q00, Q01, -7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15]);
          estimate(ws[8], cb[2], Q00, Q10, -7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23]);
          estimate(ws[16], cb[3], Q00, Q20,
                   -DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] - DC[23]);
          estimate(ws[9], cb[4], Q00, Q11,
                   DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] - DC[20] + DC[22] -
                       DC[24] + DC[4] - DC[6] + 10 * DC[7] - 10 * DC[9]);
          estimate(ws[2], cb[5], Q00, Q02,
                   -DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] - DC[15]);
        }
        idct_islow(ws, c.q, c.plane.data() + (size_t)R * 8 * stride + (size_t)C * 8,
                   (int)stride);
      }
    }
  }
}

// The IDCT of every needed component from the coefficient buffer
void transform(Decoder& d) {
  std::vector<int> latch, prev_latch;
  const bool smooth = smoothing_ok(d, latch, prev_latch);
  for (size_t ci = 0; ci < d.comps.size(); ci++) {
    Component& c = d.comps[ci];
    if (!c.needed) continue;
    if (smooth) {
      smooth_component(d, c, latch.data() + ci * 10, prev_latch.data() + ci * 10);
      continue;
    }
    const size_t stride = (size_t)c.pbw * 8;
    for (int R = 0; R < c.bh; R++)
      for (int C = 0; C < c.bw; C++)
        idct_islow(c.block(C, R), c.q, c.plane.data() + (size_t)R * 8 * stride + (size_t)C * 8,
                   (int)stride);
  }
}

// Row y of one component, upsampled to the output width (jdsample.c at its
// defaults). Returns a pointer into the plane or into `line`.
const uint8_t* upsample_row(const Component& c, int hmax, int vmax, int width, int y,
                            uint8_t* line) {
  const int hs = hmax / c.h, vs = vmax / c.v;
  const size_t stride = (size_t)c.pbw * 8;
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

// jdcolor.c build_rgb_y_table: Y = 0.299 R + 0.587 G + 0.114 B, rounded
struct RgbYTables {
  int64_t r[256], g[256], b[256];
  RgbYTables() {
    auto fix = [](double x) { return (int64_t)(x * (1L << 16) + 0.5); };
    for (int i = 0; i < 256; i++) {
      r[i] = fix(0.29900) * i;
      g[i] = fix(0.58700) * i;
      b[i] = fix(0.11400) * i + ((int64_t)1 << 15);
    }
  }
};

// cv2's CMYK handling (imgcodecs utils.cpp): each of C, M, Y scaled by K
inline int cmyk_channel(int v, int k) { return k - ((255 - v) * k >> 8); }

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
  d.default_tables();
  d.read_scan_header();
  for (auto& c : d.comps)
    if (c.needed) c.plane.assign((size_t)c.pbw * 8 * (size_t)c.pbh * 8, 0);
  if (!d.progressive && d.sc.size() == d.comps.size()) {   // one scan: no buffer
    Bits bits{d.data + d.pos, d.data + d.n};
    d.sequential_scan(bits, true);
  } else {
    for (auto& c : d.comps) c.coef.assign((size_t)c.pbw * c.pbh * 64, 0);
    for (;;) {
      Bits bits{d.data + d.pos, d.data + d.n};
      if (d.progressive) d.progressive_scan(bits);
      else d.sequential_scan(bits, false);
      if (!d.next_scan(bits)) break;
    }
    transform(d);
    for (auto& c : d.comps) std::vector<int16_t>().swap(c.coef);
  }
  const int h = d.height, w = d.width, nc = (int)d.comps.size();
  const size_t lw = (size_t)w + 32;   // upsampled rows reach 2 * dw >= w
  std::vector<uint8_t> lines(4 * lw);
  static const YccTables t;
  static const RgbYTables ty;
  const uint8_t* r[4];
  for (int y = 0; y < h; y++) {
    for (int k = 0; k < nc; k++)
      if (d.comps[k].needed)
        r[k] = upsample_row(d.comps[k], d.hmax, d.vmax, w, y, lines.data() + k * lw);
    uint8_t* o = out + (size_t)y * w * (color ? 3 : 1);
    switch (d.space) {
      case GRAY:
      case YCC:
        if (!color) {   // JCS_GRAYSCALE: the Y plane
          memcpy(o, r[0], (size_t)w);
        } else if (d.space == GRAY) {   // gray_rgb_convert
          for (int x = 0; x < w; x++) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r[0][x];
        } else {   // ycc_rgb_convert
          for (int x = 0; x < w; x++) {
            int yy = r[0][x], cb = r[1][x], cr = r[2][x];
            o[3 * x] = clamp255(yy + t.cr_r[cr]);
            o[3 * x + 1] = clamp255(yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16));
            o[3 * x + 2] = clamp255(yy + t.cb_b[cb]);
          }
        }
        break;
      case RGB:
        for (int x = 0; x < w; x++) {
          if (color) {   // rgb_rgb_convert
            o[3 * x] = r[0][x], o[3 * x + 1] = r[1][x], o[3 * x + 2] = r[2][x];
          } else {       // rgb_gray_convert
            o[x] = (uint8_t)((ty.r[r[0][x]] + ty.g[r[1][x]] + ty.b[r[2][x]]) >> 16);
          }
        }
        break;
      case CMYK:
      case YCCK:
        for (int x = 0; x < w; x++) {
          int c0 = r[0][x], c1 = r[1][x], c2 = r[2][x], k = r[3][x];
          if (d.space == YCCK) {   // ycck_cmyk_convert
            int yy = c0, cb = c1, cr = c2;
            c0 = clamp255(255 - (yy + t.cr_r[cr]));
            c1 = clamp255(255 - (yy + (int)((t.cb_g[cb] + t.cr_g[cr]) >> 16)));
            c2 = clamp255(255 - (yy + t.cb_b[cb]));
          }
          int cc = cmyk_channel(c0, k), mm = cmyk_channel(c1, k), yc = cmyk_channel(c2, k);
          if (color) {   // icvCvt_CMYK2BGR_8u_C4C3R, in RGB order
            o[3 * x] = (uint8_t)cc, o[3 * x + 1] = (uint8_t)mm, o[3 * x + 2] = (uint8_t)yc;
          } else {       // icvCvt_CMYK2Gray_8u_C4C1R
            o[x] = (uint8_t)((yc * 1868 + mm * 9617 + cc * 4899 + (1 << 13)) >> 14);
          }
        }
        break;
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
