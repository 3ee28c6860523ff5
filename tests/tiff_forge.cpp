// TIFF and GIF coders for tests/image_forge.py's tiff_bytes and gif_bytes,
// sharing nothing with the port's decoders:
//   * LZW on large inputs (the full-size frames of chip_smoke.py phase 16
//     (h)): the same codes as image_forge.tiff_lzw writes in Python, a
//     clear code first, codes of 9 to 12 bits whose width follows the
//     decoder's table (libtiff's new-style codes, MSB first, or with compat
//     the old bit-reversed ones, LSB first), a clear code when the table is
//     full, the end-of-information code; GIF's LZW is the LSB-first coder
//     with another minimum code size (2 to 11 bits: the literals below
//     2^min, codes from min + 1 bits), a clear code when 4096 entries are
//     taken, or none (a deferred clear);
//   * CCITT fax coding of bilevel rows (T.4 and T.6, written MSB first):
//     Modified Huffman rows padded to a byte (CCITT RLE) or to 16 bits
//     (RLE/W); Group 3 rows each after an EOL (with fill bits that end the
//     EOL on a byte boundary), 1-D or 2-D with a tag bit after each EOL and
//     every k-th row 1-D, an RTC of six EOLs at the end; Group 4 rows coded
//     against the row above (white above the first), an EOFB at the end.
//     Runs of 2560 or more repeat the 2560 make-up code.
//
// C interface (ctypes): pv_lzw_code(src, n, compat, out, cap),
// pv_gif_lzw(src, n, min_bits, deferred, out, cap) and
// pv_fax_code(px, h, w, mode, k, fill, eol_end, out, cap) (px: h * w bytes,
// nonzero for black; mode 2 RLE, 32771 RLE/W, 3 Group 3, 4 Group 4; k: the
// 2-D rows per 1-D one plus one, 0 for 1-D Group 3; eol_end: the RTC or
// EOFB) return the coded length (-1 when cap is too small).

#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

struct Bits {
  uint8_t* out;
  long cap, len = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool compat, full = false;
  void put(int code, int nbits) {
    if (compat) {
      acc |= (uint64_t)code << nacc;
      nacc += nbits;
      while (nacc >= 8) {
        byte((uint8_t)(acc & 255));
        acc >>= 8;
        nacc -= 8;
      }
    } else {
      acc = acc << nbits | (uint64_t)code;
      nacc += nbits;
      while (nacc >= 8) {
        nacc -= 8;
        byte((uint8_t)(acc >> nacc & 255));
      }
      acc &= (1ull << nacc) - 1;
    }
  }
  void byte(uint8_t b) {
    if (len >= cap) full = true;
    else out[len++] = b;
  }
};

// T.4's code words: {value, length}, MSB first
struct Code {
  uint16_t v;
  uint8_t n;
};
const Code kWhite[64] = {
    {0x35, 8}, {0x7, 6},   {0x7, 4},   {0x8, 4},   {0xB, 4},   {0xC, 4},   {0xE, 4},   {0xF, 4},
    {0x13, 5}, {0x14, 5},  {0x7, 5},   {0x8, 5},   {0x8, 6},   {0x3, 6},   {0x34, 6},  {0x35, 6},
    {0x2A, 6}, {0x2B, 6},  {0x27, 7},  {0xC, 7},   {0x8, 7},   {0x17, 7},  {0x3, 7},   {0x4, 7},
    {0x28, 7}, {0x2B, 7},  {0x13, 7},  {0x24, 7},  {0x18, 7},  {0x2, 8},   {0x3, 8},   {0x1A, 8},
    {0x1B, 8}, {0x12, 8},  {0x13, 8},  {0x14, 8},  {0x15, 8},  {0x16, 8},  {0x17, 8},  {0x28, 8},
    {0x29, 8}, {0x2A, 8},  {0x2B, 8},  {0x2C, 8},  {0x2D, 8},  {0x4, 8},   {0x5, 8},   {0xA, 8},
    {0xB, 8},  {0x52, 8},  {0x53, 8},  {0x54, 8},  {0x55, 8},  {0x24, 8},  {0x25, 8},  {0x58, 8},
    {0x59, 8}, {0x5A, 8},  {0x5B, 8},  {0x4A, 8},  {0x4B, 8},  {0x32, 8},  {0x33, 8},  {0x34, 8}};
const Code kBlack[64] = {
    {0x37, 10}, {0x2, 3},   {0x3, 2},   {0x2, 2},   {0x3, 3},   {0x3, 4},   {0x2, 4},
    {0x3, 5},   {0x5, 6},   {0x4, 6},   {0x4, 7},   {0x5, 7},   {0x7, 7},   {0x4, 8},
    {0x7, 8},   {0x18, 9},  {0x17, 10}, {0x18, 10}, {0x8, 10},  {0x67, 11}, {0x68, 11},
    {0x6C, 11}, {0x37, 11}, {0x28, 11}, {0x17, 11}, {0x18, 11}, {0xCA, 12}, {0xCB, 12},
    {0xCC, 12}, {0xCD, 12}, {0x68, 12}, {0x69, 12}, {0x6A, 12}, {0x6B, 12}, {0xD2, 12},
    {0xD3, 12}, {0xD4, 12}, {0xD5, 12}, {0xD6, 12}, {0xD7, 12}, {0x6C, 12}, {0x6D, 12},
    {0xDA, 12}, {0xDB, 12}, {0x54, 12}, {0x55, 12}, {0x56, 12}, {0x57, 12}, {0x64, 12},
    {0x65, 12}, {0x52, 12}, {0x53, 12}, {0x24, 12}, {0x37, 12}, {0x38, 12}, {0x27, 12},
    {0x28, 12}, {0x58, 12}, {0x59, 12}, {0x2B, 12}, {0x2C, 12}, {0x5A, 12}, {0x66, 12},
    {0x67, 12}};
// make-up codes of 64 * (i + 1), i < 27
const Code kWhiteMakeUp[27] = {
    {0x1B, 5}, {0x12, 5}, {0x17, 6}, {0x37, 7}, {0x36, 8}, {0x37, 8}, {0x64, 8},
    {0x65, 8}, {0x68, 8}, {0x67, 8}, {0xCC, 9}, {0xCD, 9}, {0xD2, 9}, {0xD3, 9},
    {0xD4, 9}, {0xD5, 9}, {0xD6, 9}, {0xD7, 9}, {0xD8, 9}, {0xD9, 9}, {0xDA, 9},
    {0xDB, 9}, {0x98, 9}, {0x99, 9}, {0x9A, 9}, {0x18, 6}, {0x9B, 9}};
const Code kBlackMakeUp[27] = {
    {0xF, 10},  {0xC8, 12}, {0xC9, 12}, {0x5B, 12}, {0x33, 12}, {0x34, 12}, {0x35, 12},
    {0x6C, 13}, {0x6D, 13}, {0x4A, 13}, {0x4B, 13}, {0x4C, 13}, {0x4D, 13}, {0x72, 13},
    {0x73, 13}, {0x74, 13}, {0x75, 13}, {0x76, 13}, {0x77, 13}, {0x52, 13}, {0x53, 13},
    {0x54, 13}, {0x55, 13}, {0x5A, 13}, {0x5B, 13}, {0x64, 13}, {0x65, 13}};
// 1792 + 64 * i, i < 13, for both colours
const Code kExtMakeUp[13] = {{0x8, 11},  {0xC, 11},  {0xD, 11},  {0x12, 12}, {0x13, 12},
                             {0x14, 12}, {0x15, 12}, {0x16, 12}, {0x17, 12}, {0x1C, 12},
                             {0x1D, 12}, {0x1E, 12}, {0x1F, 12}};
const Code kEol = {0x1, 12}, kPass = {0x1, 4}, kHoriz = {0x1, 3};
const Code kVert[7] = {{0x2, 7}, {0x2, 6}, {0x2, 3}, {0x1, 1}, {0x3, 3}, {0x3, 6}, {0x3, 7}};

struct FaxBits {
  Bits b;
  long nbits = 0;   // written so far
  void put(Code c) {
    b.put(c.v, c.n);
    nbits += c.n;
  }
  void zeros(int n) {
    for (; n > 0; n--) put({0, 1});
  }
  void align(int to) { zeros((int)((to - nbits % to) % to)); }
  void run(long r, bool black) {
    while (r >= 2560) {
      put(kExtMakeUp[12]);
      r -= 2560;
    }
    if (r >= 1792) put(kExtMakeUp[(r - 1792) / 64]);
    else if (r >= 64) put((black ? kBlackMakeUp : kWhiteMakeUp)[r / 64 - 1]);
    put((black ? kBlack : kWhite)[r % 64]);
  }
};

// the changing elements of a row: positions where the colour differs from
// the one before (white before the row), then w, w
std::vector<long> changes(const uint8_t* row, long w) {
  std::vector<long> c;
  int colour = 0;
  for (long x = 0; x < w; x++)
    if ((row[x] != 0) != colour) {
      c.push_back(x);
      colour ^= 1;
    }
  c.push_back(w);
  c.push_back(w);
  return c;
}

void code_1d(FaxBits& o, const std::vector<long>& c, long w) {
  long a0 = 0;
  for (size_t i = 0; a0 < w || i == 0; i++) {
    long a1 = c[i];
    o.run(a1 - a0, i & 1);
    a0 = a1;
    if (a0 >= w) break;
  }
}

// T.4 4.2.1.3: the modes against the reference row's changes
void code_2d(FaxBits& o, const std::vector<long>& cur, const std::vector<long>& ref, long w) {
  long a0 = -1;
  int colour = 0;   // of the run that starts at a0
  size_t ia = 0;    // cur[ia]: a1, the first change past a0
  for (;;) {
    while (cur[ia] <= a0 && cur[ia] < w) ia++;
    long a1 = cur[ia];
    // b1: the first change on the reference row past a0 of the colour
    // opposite to a0's (changes to black sit at even indices)
    size_t ib = 0;
    while (ref[ib] <= a0 || (long)(ib & 1) != colour) {
      if (ref[ib] >= w) break;
      ib++;
    }
    long b1 = ref[ib], b2 = ref[ib] >= w ? w : ref[ib + 1];
    if (b2 < a1) {                          // pass
      o.put(kPass);
      a0 = b2;
    } else if (b1 - a1 <= 3 && a1 - b1 <= 3) {   // vertical
      o.put(kVert[a1 - b1 + 3]);
      a0 = a1;
      colour ^= 1;
      ia++;
    } else {                                // horizontal
      long a2 = cur[ia + 1];
      o.put(kHoriz);
      o.run(a1 - (a0 < 0 ? 0 : a0), colour);
      o.run(a2 - a1, !colour);
      a0 = a2;
      ia += 2;
    }
    if (a0 >= w) break;
  }
}

}  // namespace

// The LZW coder of pv_lzw_code and pv_gif_lzw: literals below
// clear = 2^min_bits, a clear code first, codes of min_bits + 1 to 12 bits
// whose width follows the decoder's table (the first free entry clear + 2),
// a clear code when the next free entry reaches full_at (never with 0: the
// table then stops growing at 4096 entries, a deferred clear), the
// end-of-information code.
static long lzw_code(const uint8_t* src, long n, bool compat, int min_bits, int full_at,
                     uint8_t* out, long cap) {
  Bits bits{out, cap};
  bits.compat = compat;
  const int clear = 1 << min_bits, first_free = clear + 2;
  int nbits = min_bits + 1;
  long codes = 0;
  // the table: child[code * 256 + byte] -> code, 0 for none
  std::vector<uint16_t> child(4096 * 256, 0);
  std::vector<size_t> used;
  auto emit = [&](int code) {
    bits.put(code, nbits);
    codes++;
    long free = first_free + codes - 1;   // entries the decoder holds after this code
    while (nbits < 12 && free > (1L << nbits) - (compat ? 1 : 2)) nbits++;
  };
  auto reset = [&]() {
    for (size_t k : used) child[k] = 0;
    used.clear();
  };
  bits.put(clear, nbits);
  int next = first_free, w = -1;
  for (long i = 0; i < n; i++) {
    int c = src[i];
    if (w < 0) {
      w = c;
      continue;
    }
    uint16_t k = child[(size_t)w * 256 + c];
    if (k) {
      w = k;
      continue;
    }
    emit(w);
    if (next < 4096) {
      child[(size_t)w * 256 + c] = (uint16_t)next++;
      used.push_back((size_t)w * 256 + c);
    }
    w = c;
    if (next == full_at) {
      bits.put(clear, nbits);
      nbits = min_bits + 1;
      codes = 0;
      reset();
      next = first_free;
    }
  }
  if (w >= 0) emit(w);
  bits.put(clear + 1, nbits);
  if (bits.nacc) bits.byte((uint8_t)((compat ? bits.acc : bits.acc << (8 - bits.nacc)) & 255));
  return bits.full ? -1 : bits.len;
}

extern "C" {

long pv_fax_code(const uint8_t* px, long h, long w, int mode, int k, int fill, int eol_end,
                 uint8_t* out, long cap) {
  FaxBits o{Bits{out, cap}};
  o.b.compat = false;
  std::vector<long> ref = {w, w}, cur;
  for (long y = 0; y < h; y++) {
    cur = changes(px + y * w, w);
    bool one_d = mode == 3 && (k == 0 || y % k == 0);
    if (mode == 3) {
      if (fill) o.zeros((int)((8 - (o.nbits + 12) % 8) % 8));
      o.put(kEol);
      if (k) o.put({(uint16_t)(one_d ? 1 : 0), 1});
    }
    if (mode == 2 || mode == 32771 || one_d) code_1d(o, cur, w);
    else code_2d(o, cur, ref, w);
    if (mode == 2) o.align(8);
    if (mode == 32771) o.align(16);
    ref = cur;
  }
  if (eol_end && mode == 3)
    for (int i = 0; i < 6; i++) {
      o.put(kEol);
      if (k) o.put({1, 1});
    }
  if (eol_end && mode == 4) o.put(kEol), o.put(kEol);
  o.align(8);
  return o.b.full ? -1 : o.b.len;
}

long pv_lzw_code(const uint8_t* src, long n, int compat, uint8_t* out, long cap) {
  return lzw_code(src, n, compat != 0, 8, 4094, out, cap);
}

long pv_gif_lzw(const uint8_t* src, long n, int min_bits, int deferred, uint8_t* out, long cap) {
  return lzw_code(src, n, true, min_bits, deferred ? 0 : 4096, out, cap);
}

}  // extern "C"
