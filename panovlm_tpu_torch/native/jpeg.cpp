// JPEG decoder (ITU-T T.81: Huffman and arithmetic coding, lossy and
// lossless) that gives the bits of cv2.imread on libjpeg-turbo: the image
// stages read the Room and Floor panoramas and their masks (JPEG) on a
// machine without cv2.
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
//   * arithmetic coding (jdarith.c, T.81 Annex D and F.1.4 / G.1.3),
//     sequential (SOF9) and progressive (SOF10): the QM decoder with the
//     jaricom.c state table, the DC and AC statistics areas of each table
//     slot (0-15) conditioned by DAC segments (defaults L = 0, U = 1,
//     Kx = 5), reset where a scan begins and at each restart. A bad code
//     (a spectral or magnitude overflow) leaves the rest of the restart
//     interval's coefficients as they stand; past a marker or the end of
//     the file the decoder reads zero bytes and goes on decoding, so a cut
//     file's later MCUs are decoded from zeros (and no row is "short" for
//     the block smoothing);
//   * lossless frames (SOF3: jdlhuff.c, jddiffct.c, jdlossls.c): 2- to
//     8-bit samples, predictors 1-7, point transform Pt, difference
//     categories 0-16 (16 is 32768 with no extra bits), sums modulo 2^16,
//     the first row of the scan and of each restart interval predicted from
//     the left with 2^(P - Pt - 1) first, the first column of the others
//     from above; an MCU is h x v samples, a restart interval a whole number
//     of MCU rows (libjpeg refuses any other); the output sample is the low
//     byte of the value << Pt. Upsampling replicates. libjpeg converts no
//     colour space in lossless mode unless the conversion is lossless, so
//     cv2 reads: a gray read of one component (its samples) or four (CMYK,
//     through cv2's arithmetic), a colour read of three components coded
//     RGB (a lossless file without JFIF or Adobe marker is RGB whatever its
//     component ids; Adobe transform 0) or four (CMYK); it gives no image
//     for the other reads, for YCbCr (JFIF, Adobe transform 1) and YCCK
//     files, and for precisions above 8;
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
//     it stands once the data ran out (libjpeg's insufficient_data; a
//     lossless scan's later MCU rows predict 2^(P-1)), restart
//     intervals that reset the DC predictors and the EOB run, tables
//     redefined between segments and scans, quantisation tables latched at
//     each component's first scan, the standard Huffman tables in slots 0
//     and 1 where a sequential Huffman-coded file defines none (jstdhuff.c;
//     a progressive or lossless frame needs its own), a Huffman table's
//     code checked when a scan starts with it, a segment that the data's
//     end cuts read through the source's fake EOI bytes (a table's counts
//     or index from them fail), a frame header or DRI of the wrong length
//     refused.
// The EXIF Orientation tag of the first APP1 segment is returned to the
// caller, which applies it as cv2's imread does.
//
// Refused, each with code REFUSED, as cv2.imread gives no image for any of
// them: hierarchical frames (SOF5-7, SOF13-15) and the JPG marker (0xC8),
// lossless arithmetic frames (SOF11: libjpeg-turbo does not decode them),
// lossy frames of other than 8-bit samples (12-bit: cv2 reads 8 bits
// only), lossless frames above 8 bits, 2 components, non-integral
// sampling ratios in a component the read upsamples (libjpeg refuses them;
// a gray read of YCbCr needs Y only), a height set by a DNL marker, and the
// lossless reads listed above.
//
// The TIFF decoder (tiff.cpp) decodes JPEG-in-TIFF strips and tiles with
// this decoder through pvjpeg::Session (jpeg.h): tables that persist from
// the JPEGTables stream and from strip to strip, libtiff's colour request
// (YCbCr to RGB, or no conversion: RAW), rows written at its stride.
//
// C interface (ctypes): pv_jpeg_info(data, n, color, &h, &w, &ch,
// &orientation, err, errlen), then pv_jpeg_decode(data, n, color, out, err,
// errlen) into the caller's h * w * ch bytes; each returns 0 ok,
// 1 refused (cv2 gives no image for this kind of file either), 2 corrupt,
// 3 no memory. No global state: frames decode on threads.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <string>
#include <vector>

#include "imgcodecs.h"
#include "jpeg.h"

namespace {

using imgc::CORRUPT;
using imgc::Error;
using imgc::fail;
using imgc::NOMEM;
using imgc::OK;
using imgc::REFUSED;

const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  bool bad = false;                   // not a Huffman code: an error once a scan uses it
  int maxval = 0;                     // the largest symbol (a DC table's is checked per scan)
  uint8_t look_len[1 << kLookBits];   // 0: code longer than kLookBits
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t val[256];
};

// jpeg_make_d_derived_tbl (jdhuff.c), made when the table is defined; its
// check that the counts are a Huffman code fails when a scan uses it, as
// libjpeg derives the tables a scan uses when it starts
void build_huffman(Huffman& t, const uint8_t* counts, const uint8_t* vals, int nvals) {
  t.defined = true;
  t.bad = false;
  t.maxval = 0;
  for (int i = 0; i < nvals; i++) t.maxval = vals[i] > t.maxval ? vals[i] : t.maxval;
  int size[257], code[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < counts[l - 1]; i++) size[p++] = l;
  size[p] = 0;
  int c = 0, si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1 << si)) {
      t.bad = true;
      return;
    }
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

// jdmarker.c next_marker on entropy-coded data: on to an FF, FF fill bytes
// swallowed, FF 00 skipped; where the file ends, the stdio source's EOI.
int scan_marker(const uint8_t*& p, const uint8_t* end) {
  for (;;) {
    while (p < end && *p != 0xFF) p++;
    while (p < end && *p == 0xFF) p++;
    if (p >= end) return 0xD9;
    int c = *p++;
    if (c != 0) return c;
  }
}

// jdmarker.c read_restart_marker and jpeg_resync_to_restart: at a restart
// boundary, the marker the coder stopped at (-1: the next one in the data)
// against the RSTn expected. Returns -1 where the coder goes on with the
// data after it, else the marker left unread (the coder then reads the
// interval as data that ran out).
int restart_marker(const uint8_t*& p, const uint8_t* end, int marker, int& next_rst) {
  const int want = next_rst;
  next_rst = (next_rst + 1) & 7;
  if (marker < 0) marker = scan_marker(p, end);
  if (marker == 0xD0 + want) return -1;
  for (;;) {   // resync: 1 discard the marker, 2 scan on to the next one, 3 leave it
    int action;
    if (marker < 0xC0) action = 2;
    else if (marker < 0xD0 || marker > 0xD7) action = 3;
    else if (marker == 0xD0 + ((want + 1) & 7) || marker == 0xD0 + ((want + 2) & 7)) action = 3;
    else if (marker == 0xD0 + ((want - 1) & 7) || marker == 0xD0 + ((want - 2) & 7)) action = 2;
    else action = 1;
    if (action == 1) return -1;
    if (action == 3) return marker;
    marker = scan_marker(p, end);
  }
}

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
  int next_rst = 0;         // the RSTn expected at the next restart
  int marker = -1;          // the marker that ended the data, once seen
  bool insufficient = false;

  void fill() {
    while (n <= 56) {
      int b = 0;
      bool real = false;
      if (marker < 0) {
        if (p >= end) {   // truncated file: as at EOI
          if ((p - end) % 2) {   // a scan header read the FF of the stdio source's FF D9
            b = 0xD9;
            p++;
            real = true;
          } else {
            marker = 0xD9;
          }
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
    while (code > t.maxcode[l]) {   // maxcode[17] stops it
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;   // a bad code (17 bits read): libjpeg warns, gives 0
    return t.val[(code + t.valoffset[l]) & 0xFF];
  }
  // at a restart boundary: drop the bits left in the byte and take the
  // RSTn marker; the data flows again unless a marker is left unread
  void restart() {
    buf = 0;
    n = 0;
    fake = 0;
    marker = restart_marker(p, end, marker, next_rst);
    if (marker < 0) insufficient = false;
  }
};

// The entropy-coded segment as jdarith.c's QM decoder reads it (T.81
// D.2): the C and A registers and the bit counter ct (-16 until two bytes
// are in). FF 00 is one FF data byte; at a marker, or where the file ends
// (libjpeg's stdio source inserts an EOI), it reads zero bytes from then on,
// which is legal in arithmetic coding: nothing is "insufficient".
struct Arith {
  // jaricom.c jpeg_aritab (T.81 Table D.2): Qe << 16 | Next_Index_MPS << 8 |
  // Switch_MPS << 7 | Next_Index_LPS; the last entry is the fixed 0.5
  // estimate of T.851
  static constexpr uint32_t kTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719, 0x006f081c,
    0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024,
    0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c,
    0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843,
    0x261f2944, 0x1f332a45, 0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d,
    0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b, 0x0bb64f4d, 0x0a40304d,
    0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a, 0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756,
    0x557059d8, 0x4ca95a5f, 0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b,
    0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171,
  };
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;
  int marker = -1;
  int next_rst = 0;
  bool error = false;               // jdarith's ct = -1: a bad code, until the next restart
  static constexpr bool insufficient = false;

  int byte() {
    if (marker >= 0) return 0;
    if (p >= end) {   // the stdio source's FF D9 (its D9 alone after a cut scan header)
      if ((p++ - end) % 2) return 0xD9;
      marker = 0xD9;
      return 0;
    }
    int d = *p++;
    if (d != 0xFF) return d;
    do d = p < end ? *p++ : 0xD9; while (d == 0xFF);
    if (d == 0) return 0xFF;
    marker = d;
    return 0;
  }
  // arith_decode: one binary decision on the statistics bin *st
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;   // the two initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kTab[sv & 0x7F];
    const int nl = (int)(qe & 0xFF), nm = (int)((qe >> 8) & 0xFF);
    qe >>= 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < (int64_t)qe) {   // conditional LPS exchange
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {   // conditional MPS exchange
      if (a < (int64_t)qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // process_restart: the RSTn marker, then the registers as at the scan's
  // start
  void restart() {
    c = 0;
    a = 0;
    ct = -16;
    error = false;
    marker = restart_marker(p, end, marker, next_rst);
  }
};

// The statistics areas of an arithmetic-coded scan (jdarith.c): 64 DC and
// 256 AC bins per table slot, the fixed 0.5 bin, and per component of the
// scan the DC prediction and its conditioning context
struct ArithStats {
  uint8_t dc[16][64];
  uint8_t ac[16][256];
  uint8_t fixed_bin = 113;
  int last_dc[4] = {0, 0, 0, 0};
  int dc_context[4] = {0, 0, 0, 0};
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// jidctint.c jpeg_idct_islow (JDCT_ISLOW: CONST_BITS 13, PASS1_BITS 2) as
// libjpeg-turbo's x86 SIMD version computes it (jidctint-avx2.asm, whose
// arithmetic the SSE2 one shares), which is what cv2's build runs: the
// dequantised coefficients and the sums in0 +- in4, in7 + in3 and
// in5 + in1 in 16 bits (wrapping), the products and the rest in 32 bits,
// each pass's output saturated to 16 bits, the samples to 8 bits (where
// jidctint.c wraps far-out values through its range-limit table), and a
// block whose rows 1-7 of coefficients are all zero done by the column
// pass's shortcut (16-bit DC << PASS1_BITS, wrapping). On the values real
// images give, this is jidctint.c's arithmetic exactly.
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433, F_0_765 = 6270, F_0_899 = 7373,
                  F_1_175 = 9633, F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                  F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int32_t w16(int32_t x) { return (int16_t)(uint16_t)(uint32_t)x; }
inline int32_t add32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a + (uint32_t)b); }
inline int32_t sub32(int32_t a, int32_t b) { return (int32_t)((uint32_t)a - (uint32_t)b); }
inline int32_t mad(int32_t a, int32_t ca, int32_t b, int32_t cb) {   // pmaddwd
  return add32(a * ca, b * cb);
}
inline int32_t sat16(int32_t x) { return x < -32768 ? -32768 : (x > 32767 ? 32767 : x); }

// One 8-point pass (dodct) over in[0], in[step], ..., in[7 step] (16-bit
// values); out[k] receives sample k before saturation, descaled by `shift`
void idct_pass(const int32_t* in, int step, int shift, int32_t* out) {
  const int32_t i0 = in[0], i1 = in[step], i2 = in[2 * step], i3 = in[3 * step],
                i4 = in[4 * step], i5 = in[5 * step], i6 = in[6 * step], i7 = in[7 * step];
  const int32_t tmp3e = mad(i2, F_0_541 + F_0_765, i6, F_0_541);
  const int32_t tmp2e = mad(i2, F_0_541, i6, F_0_541 - F_1_847);
  const int32_t tmp0e = w16(i0 + i4) * (1 << CONST_BITS);
  const int32_t tmp1e = w16(i0 - i4) * (1 << CONST_BITS);
  const int32_t tmp10 = add32(tmp0e, tmp3e), tmp13 = sub32(tmp0e, tmp3e);
  const int32_t tmp11 = add32(tmp1e, tmp2e), tmp12 = sub32(tmp1e, tmp2e);
  const int32_t z3 = w16(i7 + i3), z4 = w16(i5 + i1);
  const int32_t z3s = mad(z3, F_1_175 - F_1_961, z4, F_1_175);
  const int32_t z4s = mad(z3, F_1_175, z4, F_1_175 - F_0_390);
  const int32_t tmp0 = add32(mad(i7, F_0_298 - F_0_899, i1, -F_0_899), z3s);
  const int32_t tmp1 = add32(mad(i5, F_2_053 - F_2_562, i3, -F_2_562), z4s);
  const int32_t tmp2 = add32(mad(i5, -F_2_562, i3, F_3_072 - F_2_562), z3s);
  const int32_t tmp3 = add32(mad(i7, -F_0_899, i1, F_1_501 - F_0_899), z4s);
  const int32_t half = 1 << (shift - 1);
  auto d = [&](int32_t x) { return add32(x, half) >> shift; };
  out[0] = d(add32(tmp10, tmp3));
  out[7] = d(sub32(tmp10, tmp3));
  out[1] = d(add32(tmp11, tmp2));
  out[6] = d(sub32(tmp11, tmp2));
  out[2] = d(add32(tmp12, tmp1));
  out[5] = d(sub32(tmp12, tmp1));
  out[3] = d(add32(tmp13, tmp0));
  out[4] = d(sub32(tmp13, tmp0));
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int32_t in[64], ws[64], o[8];
  for (int k = 0; k < 64; k++) in[k] = w16((int32_t)coef[k] * (int16_t)q[k]);   // vpmullw
  bool ac_zero = true;
  for (int k = 8; k < 64 && ac_zero; k++) ac_zero = coef[k] == 0;
  for (int c = 0; c < 8; c++) {   // columns
    if (ac_zero) {
      for (int r = 0; r < 8; r++) ws[8 * r + c] = w16(in[c] * (1 << PASS1_BITS));
      continue;
    }
    idct_pass(in + c, 8, CONST_BITS - PASS1_BITS, o);
    for (int r = 0; r < 8; r++) ws[8 * r + c] = sat16(o[r]);
  }
  for (int r = 0; r < 8; r++) {   // rows
    idct_pass(ws + 8 * r, 1, CONST_BITS + PASS1_BITS + 3, o);
    uint8_t* p = out + (size_t)r * stride;
    for (int k = 0; k < 8; k++) {
      int32_t v = o[k];
      p[k] = (uint8_t)((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// RAW: libjpeg's null conversion of JCS_UNKNOWN, the components as coded
// (libtiff's request for every TIFF but contiguous YCbCr)
enum ColourSpace { GRAY, YCC, RGB, CMYK, YCCK, RAW };

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;      // Huffman table slots of the scan
  int bw = 0, bh = 0;      // width_in_blocks / height_in_blocks
  int pbw = 0, pbh = 0;    // rounded up to the sampling factors: the MCU grid
  int dw = 0, dh = 0;      // downsampled_width / _height: its real samples
  size_t stride = 0;       // of the plane: pbw * 8 samples (lossless: pbw)
  bool needed = true;
  bool latched = false;    // quantisation table latched at its first scan
  uint16_t q[64];
  int coef_bits[64], prev_coef_bits[64];   // jdphuff.c's bookkeeping (-1: no scan yet)
  std::vector<int16_t> coef;               // pbw x pbh blocks of 64, natural order
  std::vector<uint8_t> plane;              // pbw*8 x pbh*8 samples (lossless: pbw x pbh)
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
  bool progressive = false, arithmetic = false, lossless = false;
  int precision = 8;
  uint8_t dac_L[16], dac_U[16], dac_K[16];   // arithmetic conditioning (DAC)
  std::vector<bool> first_row;   // lossless: the component's next row is predicted as a first row
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

  Decoder(const uint8_t* d, size_t len) : data(d), n(len) {
    memset(dac_L, 0, sizeof dac_L);   // jdmarker.c get_soi's defaults
    memset(dac_U, 1, sizeof dac_U);
    memset(dac_K, 5, sizeof dac_K);
  }

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

  void read_frame(bool prog, bool arith, bool lossl, size_t seg_len) {
    if (!comps.empty()) fail(CORRUPT, "two frame headers");
    progressive = prog;
    arithmetic = arith;
    lossless = lossl;
    precision = u8();
    height = u16();
    width = u16();
    int nc = u8();
    if (lossless ? precision < 2 || precision > 8 : precision != 8)
      fail(REFUSED, std::to_string(precision) + "-bit samples" + (lossless ? " (lossless)" : ""));
    if (height == 0) fail(REFUSED, "the height is set by a DNL marker");
    if (width == 0) fail(CORRUPT, "zero width");
    // libjpeg's JPEG_MAX_DIMENSION, and cv2's limit of 2^30 pixels
    if (width > 65500 || height > 65500 || (int64_t)width * height > ((int64_t)1 << 30))
      fail(CORRUPT, "image larger than libjpeg or cv2 read");
    if (seg_len != 6 + 3 * (size_t)nc) fail(CORRUPT, "bad frame header length");
    if (nc != 1 && nc != 3 && nc != 4)
      fail(REFUSED, std::to_string(nc) + " components");
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
          build_huffman(tc ? ac[th] : dc[th], counts, seg + o + 17, total);
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
      case 0xCC:   // DAC (jdmarker.c get_dac): Tc << 4 | Tb, then L | U << 4 or Kx
        if (seg_len % 2) fail(CORRUPT, "bad DAC segment");
        for (size_t o = 0; o < seg_len; o += 2) {
          int index = seg[o], val = seg[o + 1];
          if (index >= 32) fail(CORRUPT, "bad DAC table index");
          if (index >= 16) {
            dac_K[index - 16] = (uint8_t)val;
          } else {
            dac_L[index] = (uint8_t)(val & 15);
            dac_U[index] = (uint8_t)(val >> 4);
            if (dac_L[index] > dac_U[index]) fail(CORRUPT, "bad DAC value");
          }
        }
        return true;
      case 0xDD:
        if (seg_len != 2) fail(CORRUPT, "bad DRI segment");
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
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;   // no payload
      if (m == 0xD8) fail(CORRUPT, "a second SOI");
      if (m == 0xD9) fail(CORRUPT, "no scan before EOI");
      if (m == 0xDA) {   // read_scan_header reads the segment (a cut one too)
        if (comps.empty()) fail(CORRUPT, "scan before the frame header");
        return;
      }
      int len = u16();
      if (len < 2 || pos + len - 2 > n) fail(CORRUPT, "bad segment length");
      const uint8_t* seg = data + pos;
      size_t seg_len = (size_t)len - 2;
      size_t next = pos + seg_len;
      switch (m) {
        case 0xC0:
        case 0xC1:
        case 0xC2:
        case 0xC3:
        case 0xC9:
        case 0xCA:
          read_frame(m == 0xC2 || m == 0xCA, m >= 0xC9, m == 0xC3, seg_len);
          break;
        case 0xCB:
          fail(REFUSED, "lossless arithmetic-coded JPEG (SOF11)");
        case 0xC5:
        case 0xC6:
        case 0xC7:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          fail(REFUSED, "hierarchical JPEG");
        case 0xC8:
          fail(REFUSED, "JPG extension marker");
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
        default:   // libjpeg refuses a marker it does not know (JERR_UNKNOWN_MARKER)
          if (!table_segment(m, seg, seg_len)) fail(CORRUPT, "unknown marker");
          break;
      }
      pos = next;
    }
  }

  // The data's byte i, or past its end the source's fake EOI (FF D9 FF D9
  // ...), which libjpeg's stdio source and libtiff's memory source supply
  uint8_t at(size_t i) const { return i < n ? data[i] : (i - n) % 2 ? 0xD9 : 0xFF; }

  // A marker segment (m, its length at pos) that the data's end cuts:
  // libjpeg reads the fake EOI into the length and the body of a table
  // segment (its checks then fail, or the table takes those bytes) and
  // skips an APPn or COM; EOI follows. False where the segment is whole.
  bool cut_segment(int m) {
    int len = at(pos) << 8 | at(pos + 1);
    if (pos + 2 <= n && (len < 2 || pos + len <= n)) return false;
    if (len >= 2 && (m == 0xC4 || m == 0xCC || m == 0xDB || m == 0xDD)) {
      std::vector<uint8_t> seg((size_t)len - 2);
      for (size_t i = 0; i < seg.size(); i++) seg[i] = at(pos + 2 + i);
      table_segment(m, seg.data(), seg.size());
    }
    return true;
  }

  // jpeg_read_header(FALSE) of a table-specification stream (a TIFF's
  // JPEGTables): true where it ends, at EOI or where the data ends (the
  // source's fake EOI), before any frame; false where libjpeg errs or finds
  // a frame or scan
  bool read_tables() {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return false;
    pos = 2;
    for (;;) {
      int m = next_marker_or_eoi();
      if (m == 0xD9) return true;
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (m != 0xC4 && m != 0xCC && m != 0xDB && m != 0xDC && m != 0xDD &&
          !(m >= 0xE0 && m <= 0xEF) && m != 0xFE)
        return false;
      if (cut_segment(m)) return true;
      int len = u16();
      if (len < 2) return false;
      table_segment(m, data + pos, (size_t)len - 2);
      pos += (size_t)len - 2;
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
      else rgb = lossless || (comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B');
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
    const int unit = lossless ? 1 : 8;   // samples per block side
    mcux = (width + unit * hmax - 1) / (unit * hmax);
    mcuy = (height + unit * vmax - 1) / (unit * vmax);
    for (auto& c : comps) {
      c.dw = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.dh = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = (c.dw + unit - 1) / unit;
      c.bh = (c.dh + unit - 1) / unit;
      c.pbw = mcux * c.h;
      c.pbh = mcuy * c.v;
      c.stride = (size_t)c.pbw * unit;
    }
    // jdcolor.c allows no lossy colour conversion in lossless mode: cv2's
    // colour read asks for BGR (CMYK of four components), its gray read for
    // gray (CMYK of four components)
    if (lossless && !(space == CMYK || space == RAW || (color ? space == RGB : space == GRAY)))
      fail(REFUSED, std::string("a ") + (color ? "colour" : "gray") + " read of a lossless " +
                        (space == GRAY ? "gray" : space == RGB ? "RGB" : space == YCCK ? "YCCK"
                                                                                   : "YCbCr") +
                        " JPEG (libjpeg converts no colour space losslessly)");
    // a gray read of YCbCr (or gray) needs the luma component only
    if (!color && (space == YCC || space == GRAY))
      for (size_t i = 1; i < comps.size(); i++) comps[i].needed = false;
    // jdsample.c refuses a non-integral ratio in the components it upsamples
    for (auto& c : comps)
      if (c.needed && (hmax % c.h || vmax % c.v)) fail(REFUSED, "non-integral sampling ratio");
  }

  // jstdhuff.c: the standard tables where the file defined none by the
  // first scan, which jdhuff.c's sequential decoder installs (the
  // progressive and lossless ones do not: a table no stream defined fails)
  void default_tables() {
    if (progressive || arithmetic || lossless) return;
    if (!dc[0].defined) build_huffman(dc[0], kDcLumaCounts, kDcVals, 12);
    if (!dc[1].defined) build_huffman(dc[1], kDcChromaCounts, kDcVals, 12);
    if (!ac[0].defined) build_huffman(ac[0], kAcLumaCounts, kAcLumaVals, 162);
    if (!ac[1].defined) build_huffman(ac[1], kAcChromaCounts, kAcChromaVals, 162);
  }

  // a DC table's symbols are bit counts: at most 15 (lossless: 16)
  void dc_table_ok(int td, int maxval) {
    if (td > 3 || !dc[td].defined) fail(CORRUPT, "undefined Huffman table");
    if (dc[td].bad || dc[td].maxval > maxval) fail(CORRUPT, "bad DC Huffman table");
  }

  void ac_table_ok(int ta) {
    if (ta > 3 || !ac[ta].defined) fail(CORRUPT, "undefined Huffman table");
    if (ac[ta].bad) fail(CORRUPT, "bad AC Huffman table");
  }

  // A byte of a scan header. Past the end of a cut file, libjpeg's stdio
  // source supplies EOI markers (FF D9 FF D9 ...), which get_sos reads as
  // the header's bytes.
  int sos_u8() { return pos < n ? data[pos++] : ((pos++ - n) % 2 ? 0xD9 : 0xFF); }

  // jdmarker.c get_sos, then the checks of jdinput.c and jdphuff.c
  void read_scan_header() {
    int len = sos_u8() << 8;
    len |= sos_u8();
    int ns = sos_u8();
    if (len != ns * 2 + 6 || ns < 1 || ns > 4) fail(CORRUPT, "bad scan header");
    sc.clear();
    for (int i = 0; i < ns; i++) {
      int id = sos_u8(), t = sos_u8();
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
    Ss = sos_u8();
    Se = sos_u8();
    int a = sos_u8();
    Ah = a >> 4;
    Al = a & 15;
    scans++;
    int blocks = 0;
    for (auto* c : sc) blocks += ns == 1 ? 1 : c->h * c->v;
    if (blocks > 10) fail(CORRUPT, "too many blocks in an MCU");
    if (lossless) {   // jdlossls.c start_pass_lossless; jdlhuff.c's tables (categories to 16)
      if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= precision)
        fail(CORRUPT, "bad lossless scan parameters");
      for (auto* c : sc) dc_table_ok(c->td, 16);
      return;
    }
    for (auto* c : sc) {   // jdinput.c latch_quant_tables
      if (c->latched) continue;
      if (!qt_defined[c->tq]) fail(CORRUPT, "undefined quantisation table");
      memcpy(c->q, qt[c->tq], sizeof c->q);
      c->latched = true;
    }
    if (!progressive) {   // Ss, Se, Ah, Al are not checked: libjpeg only warns
      if (!arithmetic)    // (an arithmetic table slot is any of 0-15)
        for (auto* c : sc) {
          dc_table_ok(c->td, 15);
          ac_table_ok(c->ta);
        }
      return;
    }
    bool dc_band = Ss == 0, bad = false;
    if (dc_band) bad = Se != 0;
    else bad = Ss > Se || Se > 63 || ns != 1;
    if (Ah != 0 && Al != Ah - 1) bad = true;
    if (Al > 13) bad = true;
    if (bad) fail(CORRUPT, "bad progression parameters");
    for (auto* c : sc) {
      if (!arithmetic) {
        if (!dc_band) {
          ac_table_ok(c->ta);
        } else if (Ah == 0) {
          dc_table_ok(c->td, 15);
        }
      }
      int lo = Ss < 1 ? Ss : 1, hi = Se > 9 ? Se : 9;
      for (int k = lo; k <= hi; k++) c->prev_coef_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
      for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
    }
  }

  // The MCUs of the current scan in order: calls mcu(mx, my) after the
  // restart bookkeeping (the coder's restart, then the caller's reset of
  // its predictions).
  template <class Coder, class Reset, class F>
  void each_mcu(Coder& coder, Reset&& reset, F&& mcu) {
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
            coder.restart();
            reset();
            left = restart_interval;
          }
          left--;
        }
        if (!coder.insufficient) last_good_row = my / rows_per_imcu;
        mcu(mx, my);
      }
  }

  // The blocks of a sequential scan in order: decode(ci, component, block,
  // first block of its MCU) fills each one. direct: the frame's only scan,
  // each block transformed into its plane as it is decoded; else into the
  // buffer.
  template <class Coder, class Reset, class Decode>
  void sequential_walk(Coder& coder, Reset&& reset, bool direct, Decode&& decode) {
    int16_t blk[64];
    const bool one = sc.size() == 1;
    each_mcu(coder, reset, [&](int mx, int my) {
      bool first = true;
      for (size_t ci = 0; ci < sc.size(); ci++) {
        Component& c = *sc[ci];
        int nh = one ? 1 : c.h, nv = one ? 1 : c.v;
        for (int by = 0; by < nv; by++)
          for (int bx = 0; bx < nh; bx++) {
            int x = mx * nh + bx, y = my * nv + by;
            int16_t* b = direct ? blk : c.block(x, y);
            if (direct) memset(blk, 0, sizeof blk);
            decode((int)ci, c, b, first);
            first = false;
            if (direct && c.needed)
              idct_islow(blk, c.q, c.plane.data() + (size_t)y * 8 * c.stride + (size_t)x * 8,
                         (int)c.stride);
          }
      }
    });
  }

  // jdhuff.c decode_mcu
  void sequential_scan(Bits& bits, bool direct) {
    int pred[4] = {0, 0, 0, 0};
    bool skip = false;
    auto reset = [&] {
      for (int& k : pred) k = 0;
    };
    sequential_walk(bits, reset, direct, [&](int ci, Component& c, int16_t* b, bool first) {
      if (first) skip = bits.insufficient;   // decided once per MCU, as libjpeg does
      if (skip) return;
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
    });
  }

  // jdphuff.c's four decoders
  void progressive_scan(Bits& bits) {
    int pred[4] = {0, 0, 0, 0}, eobrun = 0;
    auto reset = [&] {
      for (int& k : pred) k = 0;
      eobrun = 0;
    };
    const bool one = sc.size() == 1;
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    if (Ss == 0) {   // DC first / refine: interleaved or not
      each_mcu(bits, reset, [&](int mx, int my) {
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
      });
      return;
    }
    Component& c = *sc[0];
    const Huffman& t = ac[c.ta];
    if (Ah == 0) {   // AC first
      each_mcu(bits, reset, [&](int mx, int my) {
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
      });
      return;
    }
    // AC refine
    each_mcu(bits, reset, [&](int mx, int my) {
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
    });
  }

  // jdarith.c: zero the statistics areas the scan uses (where it begins and
  // at each restart) and the DC predictions and contexts
  void arith_reset(ArithStats& s) {
    for (size_t ci = 0; ci < sc.size(); ci++) {
      if (!progressive || (Ss == 0 && Ah == 0)) {
        memset(s.dc[sc[ci]->td], 0, sizeof s.dc[0]);
        s.last_dc[ci] = 0;
        s.dc_context[ci] = 0;
      }
      if (!progressive || Ss) memset(s.ac[sc[ci]->ta], 0, sizeof s.ac[0]);
    }
  }

  // Figures F.19-F.24: one DC difference of component ci (table slot tbl),
  // its context updated through the DAC's L and U; false on a magnitude
  // overflow
  bool arith_dc(Arith& ar, ArithStats& s, int ci, int tbl, int* diff) {
    uint8_t* st = s.dc[tbl] + s.dc_context[ci];
    if (ar.decode(st) == 0) {
      s.dc_context[ci] = 0;
      *diff = 0;
      return true;
    }
    const int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = s.dc[tbl] + 20;   // X1
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st++;
      }
    }
    if (m < ((1 << dac_L[tbl]) >> 1)) s.dc_context[ci] = 0;
    else if (m > ((1 << dac_U[tbl]) >> 1)) s.dc_context[ci] = 12 + sign * 4;
    else s.dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // Figure F.20: coefficients Ss..Se of one block (a sequential block's AC
  // is 1..63 at Al = 0), the magnitude contexts split at the DAC's Kx;
  // false on a spectral or magnitude overflow
  bool arith_ac(Arith& ar, ArithStats& s, int tbl, int16_t* b, int ss, int se, int al) {
    for (int k = ss; k <= se; k++) {
      uint8_t* st = s.ac[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;   // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      const int sign = ar.decode(&s.fixed_bin);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = s.ac[tbl] + (k <= dac_K[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st++;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      b[kNatural[k]] = (int16_t)(int)((unsigned)(sign ? -v : v) << al);
    }
    return true;
  }

  // Figure G.10 (decode_mcu_AC_refine): the next bit of the coefficients
  // already nonzero, and the ones that become nonzero; false on a
  // spectral overflow
  bool arith_ac_refine(Arith& ar, ArithStats& s, int tbl, int16_t* b) {
    const int p1 = 1 << Al, m1 = -1 * (1 << Al);
    int kex = Se;   // the previous stage's end of block
    while (kex > 0 && !b[kNatural[kex]]) kex--;
    for (int k = Ss; k <= Se; k++) {
      uint8_t* st = s.ac[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;   // EOB
      for (;;) {
        int16_t& coef = b[kNatural[k]];
        if (coef) {
          if (ar.decode(st + 2)) coef = (int16_t)(coef < 0 ? coef + m1 : coef + p1);
          break;
        }
        if (ar.decode(st + 1)) {
          coef = (int16_t)(ar.decode(&s.fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > Se) return false;
      }
    }
    return true;
  }

  // jdarith.c decode_mcu: a sequential arithmetic-coded scan
  void arith_sequential_scan(Arith& ar, bool direct) {
    ArithStats st;
    arith_reset(st);
    auto reset = [&] { arith_reset(st); };
    sequential_walk(ar, reset, direct, [&](int ci, Component& c, int16_t* b, bool) {
      if (ar.error) return;
      int diff;
      if (!arith_dc(ar, st, ci, c.td, &diff)) {
        ar.error = true;
        return;
      }
      st.last_dc[ci] = (st.last_dc[ci] + diff) & 0xFFFF;
      b[0] = (int16_t)st.last_dc[ci];
      if (!arith_ac(ar, st, c.ta, b, 1, 63, 0)) ar.error = true;
    });
  }

  // jdarith.c's four progressive decoders, into the coefficient buffer
  void arith_progressive_scan(Arith& ar) {
    ArithStats st;
    arith_reset(st);
    auto reset = [&] { arith_reset(st); };
    const bool one = sc.size() == 1;
    if (Ss == 0) {   // DC first / refine: interleaved or not
      each_mcu(ar, reset, [&](int mx, int my) {
        if (ar.error) return;
        for (size_t ci = 0; ci < sc.size(); ci++) {
          Component& c = *sc[ci];
          int nh = one ? 1 : c.h, nv = one ? 1 : c.v;
          for (int by = 0; by < nv; by++)
            for (int bx = 0; bx < nh; bx++) {
              int16_t* b = c.block(mx * nh + bx, my * nv + by);
              if (Ah) {
                if (ar.decode(&st.fixed_bin)) b[0] = (int16_t)(b[0] | (1 << Al));
                continue;
              }
              int diff;
              if (!arith_dc(ar, st, (int)ci, c.td, &diff)) {
                ar.error = true;
                return;
              }
              st.last_dc[ci] += diff;
              b[0] = (int16_t)(int)((unsigned)st.last_dc[ci] << Al);
            }
        }
      });
      return;
    }
    Component& c = *sc[0];
    each_mcu(ar, reset, [&](int mx, int my) {
      if (ar.error) return;
      int16_t* b = c.block(mx, my);
      if (!(Ah ? arith_ac_refine(ar, st, c.ta, b) : arith_ac(ar, st, c.ta, b, Ss, Se, Al)))
        ar.error = true;
    });
  }

  // jddiffct.c decompress_data with jdlhuff.c decode_mcus and jdlossls.c's
  // undifferencers: a lossless scan, each iMCU row decoded (restart checks
  // and insufficient data per MCU row), then undifferenced row by row into
  // the sample planes as the low byte of value << Pt
  void lossless_scan(Bits& bits) {
    const bool one = sc.size() == 1;
    const int per_row = one ? sc[0]->bw : mcux;   // MCUs per MCU row
    if (restart_interval % per_row)
      fail(CORRUPT, "restart interval not a multiple of the MCUs in a row");
    const int restart_rows = restart_interval / per_row;
    int rows_to_go = restart_rows;
    const size_t ns = sc.size();
    std::vector<int> width(ns), diff_w(ns);
    std::vector<std::vector<int>> diff(ns), prev(ns), cur(ns);
    for (size_t i = 0; i < ns; i++) {
      width[i] = sc[i]->bw;
      diff_w[i] = one ? sc[i]->bw : sc[i]->pbw;
      diff[i].assign((size_t)sc[i]->v * diff_w[i], 0);
      prev[i].assign(width[i], 0);
      cur[i].assign(width[i], 0);
    }
    first_row.assign(comps.size(), true);   // start_pass_lossless
    const int x0 = 1 << (precision - Al - 1);
    for (int i = 0; i < mcuy; i++) {
      auto rows = [&](const Component& c) {   // sample rows of c in iMCU row i
        return i < mcuy - 1 ? c.v : c.bh - (mcuy - 1) * c.v;
      };
      const int mcu_rows = one ? rows(*sc[0]) : 1;
      for (int y = 0; y < mcu_rows; y++) {
        if (restart_interval && rows_to_go == 0) {
          bits.restart();
          first_row.assign(comps.size(), true);
          rows_to_go = restart_rows;
        }
        if (bits.insufficient) {   // zero differences, predictors reset
          for (size_t k = 0; k < ns; k++) {
            int r0 = one ? y : 0, nr = one ? 1 : sc[k]->v;
            std::fill(diff[k].begin() + (size_t)r0 * diff_w[k],
                      diff[k].begin() + (size_t)(r0 + nr) * diff_w[k], 0);
          }
          first_row.assign(comps.size(), true);
        } else {
          for (int mx = 0; mx < per_row; mx++)
            for (size_t k = 0; k < ns; k++) {
              const Component& c = *sc[k];
              int nh = one ? 1 : c.h, nv = one ? 1 : c.v;
              for (int by = 0; by < nv; by++)
                for (int bx = 0; bx < nh; bx++) {
                  int s = bits.decode(dc[c.td]);
                  if (s == 16) s = 32768;
                  else if (s) s = extend(bits.get(s), s);
                  diff[k][(size_t)(one ? y : by) * diff_w[k] + (size_t)mx * nh + bx] = s;
                }
            }
        }
        if (restart_interval) rows_to_go--;
      }
      for (size_t k = 0; k < ns; k++) {
        Component& c = *sc[k];
        const int ci = (int)(&c - comps.data());
        for (int r = 0; r < rows(c); r++) {
          undifference(diff[k].data() + (size_t)r * diff_w[k], prev[k].data(), cur[k].data(),
                       width[k], first_row[ci] ? 0 : Ss, x0);
          first_row[ci] = false;
          uint8_t* out = c.plane.data() + (size_t)(i * c.v + r) * c.stride;
          for (int x = 0; x < width[k]; x++) out[x] = (uint8_t)(cur[k][x] << Al);
          std::swap(prev[k], cur[k]);
        }
      }
    }
  }

  // jdlossls.c: one row undifferenced modulo 2^16 by predictor psv (0:
  // the first row, predicted from the left with x0 first)
  static void undifference(const int* d, const int* prev, int* out, int w, int psv, int x0) {
    if (psv <= 1) {
      int ra = (d[0] + (psv ? prev[0] : x0)) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; x++) out[x] = ra = (d[x] + ra) & 0xFFFF;
      return;
    }
    int rb = prev[0];
    int ra = (d[0] + rb) & 0xFFFF;
    out[0] = ra;
    for (int x = 1; x < w; x++) {
      const int rc = rb;
      rb = prev[x];
      int p;
      switch (psv) {
        case 2: p = rb; break;
        case 3: p = rc; break;
        case 4: p = ra + rb - rc; break;
        case 5: p = ra + ((rb - rc) >> 1); break;
        case 6: p = rb + ((ra - rc) >> 1); break;
        default: p = (ra + rb) >> 1; break;
      }
      out[x] = ra = (d[x] + p) & 0xFFFF;
    }
  }

  // After the entropy-coded data of a scan: the marker that ended it (or
  // -1 where the coder stopped before one, at p), then the segments up to
  // the next SOS (true) or EOI (false).
  bool next_scan(int marker, const uint8_t* p) {
    int m;
    pos = (size_t)(p - data);
    if (marker >= 0) {
      m = marker;
    } else {
      m = next_marker_or_eoi();
    }
    for (;;) {
      if (m == 0xD9) return false;
      if (m == 0xDA) {
        read_scan_header();
        return true;
      }
      if (m == 0xD8) fail(CORRUPT, "a second SOI");
      if (!((m >= 0xD0 && m <= 0xD7) || m == 0x01)) {
        if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC)
          fail(CORRUPT, "a second frame header");
        if (!(m == 0xC4 || m == 0xCC || (m >= 0xDB && m <= 0xDD) || (m >= 0xE0 && m <= 0xEF) ||
              m == 0xFE))
          fail(CORRUPT, "unknown marker");   // jdmarker.c read_markers, before any length
        if (cut_segment(m)) return false;
        int len = u16();
        if (len < 2) return false;
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
  const size_t stride = c.stride;
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
    const size_t stride = c.stride;
    for (int R = 0; R < c.bh; R++)
      for (int C = 0; C < c.bw; C++)
        idct_islow(c.block(C, R), c.q, c.plane.data() + (size_t)R * 8 * stride + (size_t)C * 8,
                   (int)stride);
  }
}

// Row y of one component, upsampled to the output width (jdsample.c at its
// defaults; `fancy` is off for lossless frames, whose DCT_scaled_size is 1,
// so that every factor replicates). Returns a pointer into the plane or
// into `line`.
const uint8_t* upsample_row(const Component& c, int hmax, int vmax, int width, int y, bool fancy,
                            uint8_t* line) {
  const int hs = hmax / c.h, vs = vmax / c.v;
  const size_t stride = c.stride;
  const uint8_t* p = c.plane.data();
  const int dw = c.dw, dh = c.dh;
  auto row = [&](int r) { return p + (size_t)(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * stride; };
  if (hs == 1 && vs == 1) return row(y);
  uint8_t* o = line;
  if (!fancy) {                                  // h2v1/h2v2/int_upsample: replicate
    const uint8_t* in = p + (size_t)(y / vs) * stride;
    for (int x = 0; x < width; x++) o[x] = in[x / hs];
  } else if (hs == 2 && vs == 1 && dw > 2) {     // h2v1_fancy_upsample
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

// jpeg_start_decompress: the frame's scans into the planes of its needed
// components (the whole file for a progressive or multi-scan frame)
void decode_planes(Decoder& d) {
  d.default_tables();
  d.read_scan_header();
  const size_t rows_per_block = d.lossless ? 1 : 8;
  for (auto& c : d.comps)   // a lossless scan undifferences every component it carries
    if (c.needed || d.lossless) c.plane.assign(c.stride * (size_t)c.pbh * rows_per_block, 0);
  const uint8_t* end = d.data + d.n;
  if (d.lossless) {
    for (;;) {
      Bits bits{d.data + d.pos, end};
      d.lossless_scan(bits);
      if (!d.next_scan(bits.marker, bits.p)) break;
    }
  } else if (!d.progressive && d.sc.size() == d.comps.size()) {   // one scan: no buffer
    if (d.arithmetic) {
      Arith ar{d.data + d.pos, end};
      d.arith_sequential_scan(ar, true);
    } else {
      Bits bits{d.data + d.pos, end};
      d.sequential_scan(bits, true);
    }
  } else {
    for (auto& c : d.comps) c.coef.assign((size_t)c.pbw * c.pbh * 64, 0);
    for (;;) {
      bool more;
      if (d.arithmetic) {
        Arith ar{d.data + d.pos, end};
        if (d.progressive) d.arith_progressive_scan(ar);
        else d.arith_sequential_scan(ar, false);
        more = d.next_scan(ar.marker, ar.p);
      } else {
        Bits bits{d.data + d.pos, end};
        if (d.progressive) d.progressive_scan(bits);
        else d.sequential_scan(bits, false);
        more = d.next_scan(bits.marker, bits.p);
      }
      if (!more) break;
    }
    transform(d);
    for (auto& c : d.comps) std::vector<int16_t>().swap(c.coef);
  }
}

// Output row y (jpeg_read_scanlines): the components upsampled and
// converted for the read, w * 3 bytes for a colour read, w for a gray one
// (RAW: w * components, the components as coded); `lines` holds 4 * lw
// bytes of upsampling room
void output_row(const Decoder& d, int y, bool color, uint8_t* lines, size_t lw, uint8_t* o) {
  static const YccTables t;
  static const RgbYTables ty;
  const int w = d.width, nc = (int)d.comps.size();
  const uint8_t* r[4];
  for (int k = 0; k < nc; k++)
    if (d.comps[k].needed)
      r[k] = upsample_row(d.comps[k], d.hmax, d.vmax, w, y, !d.lossless, lines + k * lw);
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
    case RAW:   // null_convert
      for (int x = 0; x < w; x++)
        for (int k = 0; k < nc; k++) o[x * nc + k] = r[k][x];
      break;
  }
}

// decodes into out (h x w x ch, ch = 3 for colour, else 1)
void decode(const uint8_t* data, size_t n, bool color, uint8_t* out) {
  Decoder d = header(data, n, color);
  decode_planes(d);
  const size_t lw = (size_t)d.width + 32;   // upsampled rows reach 2 * dw >= w
  std::vector<uint8_t> lines(4 * lw);
  for (int y = 0; y < d.height; y++)
    output_row(d, y, color, lines.data(), lw, out + (size_t)y * d.width * (color ? 3 : 1));
}

}  // namespace

namespace pvjpeg {

namespace {

// the slots a stream's DQT and DHT segments fill, which libjpeg keeps in
// the decompressor from one stream to the next
void copy_tables(const Decoder& from, Decoder& to) {
  memcpy(to.qt, from.qt, sizeof to.qt);
  memcpy(to.qt_defined, from.qt_defined, sizeof to.qt_defined);
  for (int k = 0; k < 4; k++) {
    to.dc[k] = from.dc[k];
    to.ac[k] = from.ac[k];
  }
}

}  // namespace

struct Session::State {
  Decoder tables{nullptr, 0};
  std::unique_ptr<Decoder> d;   // the strip or tile being read
};

Session::Session() : s_(new State) {}
Session::~Session() = default;

bool Session::tables(const uint8_t* data, size_t n) {
  Decoder t(data, n);
  try {
    if (!t.read_tables()) return false;
  } catch (const Error& e) {
    if (e.code == NOMEM) throw;
    return false;
  }
  copy_tables(t, s_->tables);
  return true;
}

Frame Session::header(const uint8_t* data, size_t n) {
  s_->d.reset(new Decoder(data, n));
  Decoder& d = *s_->d;
  copy_tables(s_->tables, d);
  d.read_segments();
  Frame f;
  f.width = d.width;
  f.height = d.height;
  f.components = (int)d.comps.size();
  f.precision = d.precision;
  for (int k = 0; k < f.components && k < 4; k++) {
    f.h[k] = d.comps[k].h;
    f.v[k] = d.comps[k].v;
  }
  return f;
}

void Session::start(bool ycc) {
  Decoder& d = *s_->d;
  if (ycc && d.comps.size() != 3) fail(CORRUPT, "YCbCr of other than 3 components");
  d.space = ycc ? YCC : RAW;
  d.layout(true);
  decode_planes(d);
  copy_tables(d, s_->tables);
}

void Session::rows(uint8_t* out, size_t stride, int rows) {
  const Decoder& d = *s_->d;
  const size_t lw = (size_t)d.width + 32;
  std::vector<uint8_t> lines(4 * lw);
  for (int y = 0; y < rows; y++)
    output_row(d, y, true, lines.data(), lw, out + (size_t)y * stride);
}

}  // namespace pvjpeg

extern "C" {

// The output size of a decode: height, width, channels (3 for a colour read,
// else 1) and the EXIF orientation (0 when absent).
int pv_jpeg_info(const uint8_t* data, long n, int color, int* h, int* w, int* ch,
                 int* orientation, char* err, int errlen) {
  return imgc::guarded([&] {
    Decoder d = header(data, (size_t)n, color != 0);
    *h = d.height;
    *w = d.width;
    *ch = color ? 3 : 1;
    *orientation = d.orientation;
  }, err, errlen);
}

// Decodes into out, which holds the h * w * ch bytes that pv_jpeg_info gave.
int pv_jpeg_decode(const uint8_t* data, long n, int color, uint8_t* out, char* err, int errlen) {
  return imgc::guarded([&] { decode(data, (size_t)n, color != 0, out); }, err, errlen);
}

}  // extern "C"
