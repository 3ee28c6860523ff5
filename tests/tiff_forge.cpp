// TIFF LZW coding for tests/image_forge.py's tiff_bytes on large inputs
// (the full-size frames of chip_smoke.py phase 16 (h)): the same codes as
// image_forge.tiff_lzw writes in Python, a clear code first, codes of 9 to
// 12 bits whose width follows the decoder's table (libtiff's new-style
// codes, MSB first, or with compat the old bit-reversed ones, LSB first), a
// clear code when the table is full, the end-of-information code. It
// shares nothing with the port's decoder.
//
// C interface (ctypes): pv_lzw_code(src, n, compat, out, cap) returns the
// coded length (-1 when cap is too small).

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

}  // namespace

extern "C" {

long pv_lzw_code(const uint8_t* src, long n, int compat, uint8_t* out, long cap) {
  Bits bits{out, cap};
  bits.compat = compat != 0;
  int nbits = 9;
  long codes = 0;
  // the table: child[code * 256 + byte] -> code, 0 for none
  std::vector<uint16_t> child(4096 * 256, 0);
  std::vector<size_t> used;
  auto emit = [&](int code) {
    bits.put(code, nbits);
    codes++;
    long free = 258 + codes - 1;   // entries the decoder holds after this code
    while (nbits < 12 && free > (1L << nbits) - (compat ? 1 : 2)) nbits++;
  };
  auto reset = [&]() {
    for (size_t k : used) child[k] = 0;
    used.clear();
  };
  bits.put(256, nbits);
  int next = 258, w = -1;
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
    child[(size_t)w * 256 + c] = (uint16_t)next++;
    used.push_back((size_t)w * 256 + c);
    w = c;
    if (next == 4094) {
      bits.put(256, nbits);
      nbits = 9;
      codes = 0;
      reset();
      next = 258;
    }
  }
  if (w >= 0) emit(w);
  bits.put(257, nbits);
  if (bits.nacc) bits.byte((uint8_t)((compat ? bits.acc : bits.acc << (8 - bits.nacc)) & 255));
  return bits.full ? -1 : bits.len;
}

}  // extern "C"
