// GIF decoding with the bits of cv2.imread (OpenCV 5.0's own GifDecoder,
// grfmt_gif.cpp, not giflib), for masks and frames on a machine without
// cv2. cv2.imread reads the first frame:
//   * the header: "GIF87a" or "GIF89a", the logical screen (both sides
//     above 0), the global palette when its flag is set (the background
//     index must be below its size; without one any index goes);
//   * the whole file is walked to its trailer before anything is decoded
//     (getFrameCount_): each block must be an extension (0x21), an image
//     (0x2C) or the trailer (0x3B), and a file cut anywhere before its
//     trailer gives no image; bytes after the trailer are not read. The
//     walk skips the sub-blocks of every extension, but in an application
//     extension it reads a sub-block of 11 bytes as its name, and skips
//     only 2 bytes of a 3-byte sub-block unless the name was NETSCAPE2.0
//     (then its first byte is read, and a loop count after a 1), so a
//     3-byte sub-block there shifts the walk onto its third byte;
//   * before the first image: the extensions (readExtensions). A graphic
//     control extension must open with a sub-block of 4 bytes, and a
//     disposal method above 3 gives no image; its transparency flag and
//     index hold for the first image (the last such extension wins);
//   * the image descriptor: the frame (both sides above 0) must lie inside
//     the screen; a local palette, or none (the global palette then, and
//     without either index 1 reads as white and any other index v as
//     (v, v, v));
//   * LZW (lzwDecode): LSB first, a minimum code size of 2 to 11, codes of
//     min + 1 bits growing to 12 when the next free entry reaches 2^bits;
//     clear and end-of-information codes reset the table, and decoding goes
//     on after an end-of-information code to the end of the data
//     sub-blocks; a literal code at or above 256 (minimum code sizes 9 to
//     11) is its low byte; a code above the next free entry gives no
//     image; once 4096 entries are taken the table stops growing and
//     codes go on from it (deferred clear). The frame must be filled
//     exactly: data that ends short gives no image, and so does a code
//     whose string runs past the frame's last pixel; a further code after
//     the last pixel is accepted only at the end of a data sub-block
//     followed by the block terminator;
//   * the canvas: the screen filled with the global palette's background
//     colour (black without a global palette); the frame's pixels drawn at
//     its offset, rows in interlace order (every 8th from 0, every 8th
//     from 4, every 4th from 2, every 2nd from 1) when its flag is set, the
//     transparent index left as the background, an index below the local
//     palette's size through it, else one below the global palette's size
//     through that, else no image;
//   * the gray read (IMREAD_GRAYSCALE): cvtColor's BGRA2GRAY of each canvas
//     pixel, (3735 B + 19235 G + 9798 R + 16384) >> 15 (not imgcodecs.h's
//     14-bit gray of the other decoders: the two differ on ~0.3 % of
//     colours).
// Every "no image" above is an error here (code 2; a minimum code size or
// a disposal method that cv2 refuses, 1).
//
// C interface (ctypes), as bmp.cpp: pv_gif_info(data, n, color, &h, &w,
// err, errlen) reads the header and walks the file; pv_gif_decode(data, n,
// color, out, err, errlen) writes h * w bytes, or h * w * 3 in RGB order
// for a colour read.

#include <vector>

#include "imgcodecs.h"

namespace {

using namespace imgc;

struct Gif {
  int width, height, bg, global_n;
  Pal global[256];
  int64_t blocks;   // where the blocks after the global palette start
};

// cvtColor's COLOR_BGR(A)2GRAY on 8-bit pixels
inline uint8_t cvt_gray(const Pal& c) {
  return (uint8_t)((c.b * 3735 + c.g * 19235 + c.r * 9798 + 16384) >> 15);
}

void skip_sub_blocks(Stream& s) {
  for (int len = s.byte(); len; len = s.byte()) s.pos += len;
}

// getFrameCount_: the walk to the trailer, as cv2 makes it before it
// decodes anything
void walk(Stream& s) {
  for (int type = s.byte(); type != 0x3B; type = s.byte()) {
    if (type == 0x21) {
      if (s.byte() != 0xFF) {
        skip_sub_blocks(s);
        continue;
      }
      bool netscape = false;
      for (int len = s.byte(); len; len = s.byte()) {
        if (len == 11) {
          char name[11];
          s.bytes(name, 11);
          netscape = std::memcmp(name, "NETSCAPE2.0", 11) == 0;
        } else if (len == 3) {
          if (netscape && s.byte() == 1) s.word_le();   // the loop count
          else s.pos += 2;
        } else {
          s.pos += len;
        }
      }
    } else if (type == 0x2C) {
      s.pos += 8;
      int flags = s.byte();
      if (flags & 0x80) s.pos += 3 << ((flags & 7) + 1);
      s.pos += 1;   // the minimum code size
      skip_sub_blocks(s);
    } else {
      fail(CORRUPT, "a block that is no extension, image or trailer");
    }
  }
}

Gif header(Stream& s) {
  Gif g{};
  char sig[6];
  s.bytes(sig, 6);
  if (std::memcmp(sig, "GIF87a", 6) != 0 && std::memcmp(sig, "GIF89a", 6) != 0)
    fail(REFUSED, "no GIF signature");
  g.width = s.word_le();
  g.height = s.word_le();
  if (!(g.width > 0 && g.height > 0)) fail(CORRUPT, "a logical screen of 0 pixels");
  int flags = s.byte();
  g.bg = s.byte();
  s.pos += 1;   // the aspect ratio
  if (flags & 0x80) {
    g.global_n = 1 << ((flags & 7) + 1);
    for (int i = 0; i < g.global_n; i++) {
      uint8_t rgb[3];
      s.bytes(rgb, 3);
      g.global[i] = Pal{rgb[2], rgb[1], rgb[0], 0};
    }
    if (g.bg >= g.global_n) fail(CORRUPT, "a background index past the global palette");
  }
  g.blocks = s.pos;
  walk(s);
  return g;
}

// lzwDecode into px (total indices): true when the codes fill it exactly
bool lzw(Stream& s, uint8_t* px, int64_t total) {
  const int min = s.byte();
  if (min < 2 || min > 11) fail(REFUSED, "a minimum code size cv2 refuses");
  const int clear = 1 << min, eoi = clear + 1;
  // entry e: its string is that of code prev[e] (a literal below clear)
  // and then suffix[e]; first[e] its first byte, len[e] its length
  std::vector<uint16_t> prev(4097);
  std::vector<uint8_t> suffix(4097), first(4097);
  std::vector<int> len(4097);
  int bits = min + 1, next = eoi;   // next: the entry the next code completes
  int64_t idx = 0;
  uint32_t src = 0;
  int held = 0;
  int block = s.byte();
  while (block) {
    if (held < bits) {
      src |= (uint32_t)s.byte() << held;
      block--;
      held += 8;
    }
    while (held >= bits) {
      const int code = (int)(src & ((1u << bits) - 1));
      src >>= bits;
      held -= bits;
      if (code == clear || code == eoi) {
        bits = min + 1;
        next = eoi;
        if (code == clear) continue;
        break;
      }
      if (idx >= total)   // a code after the last pixel
        return idx == total && block == 0 && s.byte() == 0;
      if (code < clear) {
        if (next < 4096) {
          suffix[next++] = (uint8_t)code;
          prev[next] = (uint16_t)code;
          first[next] = (uint8_t)code;
          len[next] = 2;
        }
        px[idx++] = (uint8_t)code;
      } else {
        if (next < 4096) {
          if (code > next) return false;
          suffix[next++] = first[code];
          prev[next] = (uint16_t)code;
          first[next] = first[code];
          len[next] = len[code] + 1;
        }
        if (idx + len[code] > total) fail(CORRUPT, "an LZW string past the frame's last pixel");
        int64_t at = idx + len[code];
        int e = code;
        for (; e >= clear; e = prev[e]) px[--at] = suffix[e];
        px[--at] = (uint8_t)e;
        idx += len[code];
      }
      if (next == 1 << bits && bits <= 11) bits++;
    }
    if (!block) block = s.byte();
  }
  return idx == total;
}

// readExtensions and readData of the first image
void decode(const uint8_t* data, int64_t n, bool color, uint8_t* out) {
  Stream s{data, n};
  const Gif g = header(s);
  s.pos = g.blocks;
  bool transparent = false;
  int key = 0;
  for (int b = s.byte(); b == 0x21; b = s.byte()) {
    if (s.byte() == 0xF9) {
      transparent = false;
      if (s.byte() != 4) fail(CORRUPT, "a graphic control extension of another length than 4");
      int flags = s.byte();
      if (flags & 0x10) fail(REFUSED, "a disposal method above 3");
      transparent = flags & 1;
      s.word_le();   // the delay
      key = s.byte();
    }
    skip_sub_blocks(s);
  }
  s.pos--;
  if (s.byte() != 0x2C) fail(CORRUPT, "no image descriptor after the extensions");
  const int left = s.word_le(), top = s.word_le(), fw = s.word_le(), fh = s.word_le();
  if (!(fw > 0 && fh > 0 && left + fw <= g.width && top + fh <= g.height))
    fail(CORRUPT, "a frame outside the logical screen");
  const int flags = s.byte();
  int local_n = 0;
  Pal local[256];
  if (flags & 0x80) {
    local_n = 1 << ((flags & 7) + 1);
    for (int i = 0; i < local_n; i++) {
      uint8_t rgb[3];
      s.bytes(rgb, 3);
      local[i] = Pal{rgb[2], rgb[1], rgb[0], 0};
    }
  }
  std::vector<uint8_t> px((size_t)fw * fh);
  if (!lzw(s, px.data(), (int64_t)fw * fh)) fail(CORRUPT, "LZW data that does not fill the frame");

  // what each index puts on the canvas (R, G, B, or the gray); has[c]
  // false where an index has no colour
  const int nch = color ? 3 : 1;
  auto value = [&](uint8_t* v, const Pal& c) {
    if (!color) {
      v[0] = cvt_gray(c);
      return;
    }
    v[0] = c.r;
    v[1] = c.g;
    v[2] = c.b;
  };
  uint8_t bgv[3], val[256][3];
  bool has[256];
  value(bgv, g.bg < g.global_n ? g.global[g.bg] : Pal{0, 0, 0, 0});
  for (int c = 0; c < 256; c++) {
    Pal pc{(uint8_t)c, (uint8_t)c, (uint8_t)c, 0};
    if (c == 1) pc = Pal{255, 255, 255, 0};
    has[c] = true;
    if (c < local_n) pc = local[c];
    else if (c < g.global_n) pc = g.global[c];
    else if (local_n || g.global_n) has[c] = false;
    value(val[c], pc);
  }
  const int64_t pixels = (int64_t)g.width * g.height;
  for (int64_t i = 0; i < pixels; i++) std::memcpy(out + i * nch, bgv, (size_t)nch);
  // code2pixel: the rows in their order in the data, (first row, step) of
  // each pass
  static const int kPlain[1][2] = {{0, 1}}, kInterlaced[4][2] = {{0, 8}, {4, 8}, {2, 4}, {1, 2}};
  const bool interlaced = flags & 0x40;
  const uint8_t* p = px.data();
  for (int pass = 0; pass < (interlaced ? 4 : 1); pass++) {
    const int* ps = interlaced ? kInterlaced[pass] : kPlain[0];
    for (int y = ps[0]; y < fh; y += ps[1]) {
      uint8_t* row = out + ((int64_t)(top + y) * g.width + left) * nch;
      for (int x = 0; x < fw; x++, p++) {
        if (transparent && *p == key) continue;
        if (!has[*p]) fail(CORRUPT, "an index past both palettes");
        std::memcpy(row + (int64_t)x * nch, val[*p], (size_t)nch);
      }
    }
  }
}

}  // namespace

extern "C" {

int pv_gif_info(const uint8_t* data, long n, int color, int* h, int* w, char* err, int errlen) {
  (void)color;
  return guarded([&] {
    Stream s{data, n};
    Gif g = header(s);
    *h = g.height;
    *w = g.width;
  }, err, errlen);
}

int pv_gif_decode(const uint8_t* data, long n, int color, uint8_t* out, char* err, int errlen) {
  return guarded([&] { decode(data, n, color != 0, out); }, err, errlen);
}

}  // extern "C"
