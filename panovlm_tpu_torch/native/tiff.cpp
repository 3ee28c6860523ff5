// TIFF decoding with the bits of cv2.imread (OpenCV 5's TiffDecoder over its
// libtiff 4.7), for masks and frames on a machine without cv2. cv2's 8-bit
// reads go through libtiff's TIFFRGBAImage (one TIFFReadRGBAStrip or
// TIFFReadRGBATile call per strip or tile), and this file replays that
// path:
//   * the container: classic and BigTIFF, either byte order, the first
//     IFD only (tif_dirread.c: duplicate tags ignored, the tags whose
//     errors end the read, codec tags only for their codec, strip arrays
//     padded with zeros, a missing or implausible StripByteCounts
//     estimated, non-colour samples made extra samples); strips and
//     tiles, PlanarConfiguration 1 and 2, FillOrder 2;
//   * the codecs none, PackBits, LZW (libtiff's new-style codes and the
//     old bit-reversed "compat" ones, chosen by the first strip read) and
//     Deflate (8 and 32946, through zlib's inflate as tif_zip.c calls
//     it), with horizontal differencing (Predictor 2) for 8 to 64-bit
//     samples; a compression number libtiff has no codec for decodes to
//     zeros. A strip that fails to decode keeps what was decoded before
//     the error (zeros after it; an LZW or PackBits strip that runs short
//     is zero-filled, a failed differencing step is skipped), as
//     TIFFReadRGBA* with stop_on_error 0 does; a strip or tile that cannot
//     be read at all (out of the file, a byte count of 0, an uncompressed
//     tile of the wrong size, a predictor the codec refuses) gives no
//     image;
//   * tif_getimage.c's conversions to RGBA: MinIsWhite / MinIsBlack at 1,
//     2, 4, 8 and 16 bits (16 bits through the high byte), palettes at 1,
//     2, 4 and 8 bits (a colormap whose entries are all below 256 read as
//     8-bit, else each >> 8), RGB at 8 and 16 bits ((v + 128) / 257),
//     8-bit CMYK, YCbCr 8-bit with 4:4, 4:2, 4:1, 2:2, 2:1, 1:2 and 1:1
//     subsampling through TIFFYCbCrToRGBInit's tables, CIE L*a*b* at 8 and
//     16 bits through tif_color.c's float steps, associated alpha
//     kept, unassociated alpha premultiplied ((v * a + 127) / 255), other
//     extra samples ignored; the put routines' pointer arithmetic is
//     replayed as written, its quirks on clipped edge tiles too;
//   * OpenCV's steps: readHeader's bit-depth and sample-format checks,
//     readData's tile-size asserts, the rows of each RGBA raster copied
//     bottom-up (icvCvt_BGRA2BGR, icvCvt_BGRA2Gray with the BGR weights of
//     imgcodecs.h), bands placed mirrored for orientations 3, 4, 7 and 8,
//     and orientations 5 to 8 transposed afterwards, which cv2.imread can
//     do only in place: a non-square image gives no image.
// What cv2 gives no image for is refused (REFUSED): the codecs its libtiff
// is built without (old JPEG, JBIG, PixarLog, LERC, LZMA, ZSTD, WebP),
// float and 32-bit samples, broken IFDs, files cut before their data, NeXT
// (its 2-bit samples fail OpenCV's header check). The codecs cv2 reads that
// this file does not (CCITT 2, 3, 4 and 32771, JPEG 7, ThunderScan,
// SGILog) return QUEUED (4), after the checks that make cv2 give no image
// for them (the first strip unreadable, a bit depth their setup refuses,
// a JPEG strip without its SOI marker).
//
// C interface (ctypes): pv_tiff_info(data, n, color, &h, &w, err, errlen)
// reads the directory as cv2's readHeader does; pv_tiff_decode(data, n,
// color, out, err, errlen) writes h * w bytes, or h * w * 3 in RGB order
// for a colour read. See imgcodecs.h for the return codes.

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <vector>

#include "imgcodecs.h"

namespace {

using namespace imgc;

enum : int { QUEUED = 4 };

// field types
enum : uint16_t {
  T_BYTE = 1, T_ASCII, T_SHORT, T_LONG, T_RATIONAL, T_SBYTE, T_UNDEFINED, T_SSHORT, T_SLONG,
  T_SRATIONAL, T_FLOAT, T_DOUBLE, T_IFD, T_LONG8 = 16, T_SLONG8, T_IFD8
};

int type_width(int t) {
  switch (t) {
    case 0: case T_BYTE: case T_ASCII: case T_SBYTE: case T_UNDEFINED: return 1;
    case T_SHORT: case T_SSHORT: return 2;
    case T_LONG: case T_SLONG: case T_FLOAT: case T_IFD: return 4;
    case T_RATIONAL: case T_SRATIONAL: case T_DOUBLE: case T_LONG8: case T_SLONG8: case T_IFD8:
      return 8;
  }
  return 0;
}

// tags
enum : uint16_t {
  TAG_OSUBFILETYPE = 255, TAG_WIDTH = 256, TAG_LENGTH = 257, TAG_BITS = 258, TAG_COMPRESSION = 259,
  TAG_PHOTOMETRIC = 262, TAG_FILLORDER = 266, TAG_STRIPOFFSETS = 273, TAG_ORIENTATION = 274,
  TAG_SPP = 277, TAG_ROWSPERSTRIP = 278, TAG_STRIPBYTECOUNTS = 279, TAG_MINSAMPLE = 280,
  TAG_MAXSAMPLE = 281, TAG_PLANAR = 284, TAG_TRANSFER = 301, TAG_PREDICTOR = 317,
  TAG_COLORMAP = 320, TAG_TILEWIDTH = 322, TAG_TILELENGTH = 323, TAG_TILEOFFSETS = 324,
  TAG_TILEBYTECOUNTS = 325, TAG_INKSET = 332, TAG_EXTRASAMPLES = 338, TAG_SAMPLEFORMAT = 339,
  TAG_SMINSAMPLE = 340, TAG_SMAXSAMPLE = 341, TAG_YCBCRCOEF = 529, TAG_YCBCRSUB = 530,
  TAG_REFBW = 532, TAG_WHITEPOINT = 318, TAG_DATATYPE = 32996, TAG_IMAGEDEPTH = 32997, TAG_TILEDEPTH = 32998
};

// compression schemes
enum : uint16_t {
  C_NONE = 1, C_CCITTRLE = 2, C_FAX3 = 3, C_FAX4 = 4, C_LZW = 5, C_OJPEG = 6, C_JPEG = 7,
  C_ADOBE_DEFLATE = 8, C_NEXT = 32766, C_CCITTRLEW = 32771, C_PACKBITS = 32773,
  C_THUNDER = 32809, C_PIXARLOG = 32909, C_DEFLATE = 32946, C_JBIG = 34661, C_SGILOG = 34676,
  C_SGILOG24 = 34677, C_LERC = 34887, C_LZMA = 34925, C_ZSTD = 50000, C_WEBP = 50001
};

// photometric interpretations
enum : uint16_t {
  P_MINISWHITE = 0, P_MINISBLACK = 1, P_RGB = 2, P_PALETTE = 3, P_MASK = 4, P_SEPARATED = 5,
  P_YCBCR = 6, P_CIELAB = 8, P_ICCLAB = 9, P_ITULAB = 10, P_LOGL = 32844, P_LOGLUV = 32845
};

enum { ALPHA_NONE = 0, ALPHA_ASSOC = 1, ALPHA_UNASS = 2 };

// the codecs cv2's libtiff is built without (TIFFRGBAImageOK refuses them)
bool codec_configured(uint16_t c) {
  switch (c) {
    case C_OJPEG: case C_JBIG: case C_PIXARLOG: case C_LZMA: case C_ZSTD: case C_WEBP: case C_LERC:
      return false;
  }
  return true;
}

bool codec_queued(uint16_t c) {
  switch (c) {
    case C_CCITTRLE: case C_CCITTRLEW: case C_FAX3: case C_FAX4: case C_JPEG: case C_THUNDER:
    case C_NEXT: case C_SGILOG: case C_SGILOG24:
      return true;
  }
  return false;
}

const char* codec_name(uint16_t c) {
  switch (c) {
    case C_CCITTRLE: return "CCITT RLE (2)";
    case C_CCITTRLEW: return "CCITT RLE/W (32771)";
    case C_FAX3: return "CCITT Group 3 (3)";
    case C_FAX4: return "CCITT Group 4 (4)";
    case C_JPEG: return "JPEG (7)";
    case C_THUNDER: return "ThunderScan (32809)";
    case C_NEXT: return "NeXT (32766)";
    case C_SGILOG: return "SGILog (34676)";
    case C_SGILOG24: return "SGILog24 (34677)";
  }
  return "?";
}

// ----------------------------------------------------------------------------
// the file (mapped, as TIFFOpen maps it)
// ----------------------------------------------------------------------------

struct File {
  const uint8_t* d;
  uint64_t n;
  bool swab = false, big = false;
  bool in(uint64_t off, uint64_t len) const { return len <= n && off <= n - len; }
  uint16_t u16(const uint8_t* p) const {
    return swab ? (uint16_t)(p[0] << 8 | p[1]) : (uint16_t)(p[0] | p[1] << 8);
  }
  uint32_t u32(const uint8_t* p) const {
    uint32_t v = 0;
    for (int k = 0; k < 4; k++) v |= (uint32_t)p[swab ? 3 - k : k] << 8 * k;
    return v;
  }
  uint64_t u64(const uint8_t* p) const {
    uint64_t v = 0;
    for (int k = 0; k < 8; k++) v |= (uint64_t)p[swab ? 7 - k : k] << 8 * k;
    return v;
  }
};

struct Entry {
  uint16_t tag, type;
  uint64_t count;
  uint8_t slot[8];
  bool ignore = false;
};

enum Err { E_OK, E_COUNT, E_TYPE, E_IO, E_RANGE, E_PSDIF, E_SIZESAN, E_ALLOC };

// TIFFReadDirEntryArrayWithLimit: the entry's values as raw bytes in file
// order, at most maxcount of them
Err entry_bytes(const File& f, const Entry& e, uint64_t maxcount, std::vector<uint8_t>& raw,
                uint32_t& count) {
  raw.clear();
  int ts = type_width(e.type);
  uint64_t target = std::min(e.count, maxcount);
  count = 0;
  if (target == 0 || ts == 0) return E_OK;
  int clamped = (int)std::min<uint64_t>(e.count, 10) * ts;
  const uint64_t MAX_TAG = 0x7FFFFFFF;   // MAX_SIZE_TAG_DATA
  if (MAX_TAG / ts < target || MAX_TAG / 8 < target) return E_SIZESAN;
  count = (uint32_t)target;
  uint64_t size = (uint64_t)count * ts;
  if (size > 100u * 1024 * 1024 && size > f.n) return E_ALLOC;
  if (size > f.n) return E_IO;
  uint64_t slot = f.big ? 8 : 4;
  if ((uint64_t)clamped <= slot && size <= slot) {
    raw.assign(e.slot, e.slot + size);
    return E_OK;
  }
  uint64_t off = f.big ? f.u64(e.slot) : f.u32(e.slot);
  if (!f.in(off, size)) return E_IO;
  raw.assign(f.d + off, f.d + off + size);
  return E_OK;
}

// one value of an integer type: neg for a negative signed one, v its bits
bool int_value(const File& f, int type, const uint8_t* p, bool& neg, uint64_t& v) {
  neg = false;
  switch (type) {
    case T_BYTE: v = p[0]; return true;
    case T_SHORT: v = f.u16(p); return true;
    case T_LONG: case T_IFD: v = f.u32(p); return true;
    case T_LONG8: case T_IFD8: v = f.u64(p); return true;
  }
  int64_t sv;
  switch (type) {
    case T_SBYTE: sv = (int8_t)p[0]; break;
    case T_SSHORT: sv = (int16_t)f.u16(p); break;
    case T_SLONG: sv = (int32_t)f.u32(p); break;
    case T_SLONG8: sv = (int64_t)f.u64(p); break;
    default: return false;
  }
  neg = sv < 0;
  v = (uint64_t)sv;
  return true;
}

// TIFFReadDirEntryShort / Long / Long8: one value, count 1, integer types
// (IFD types too for Long and Long8), range-checked into `bits`
Err read_uint(const File& f, const Entry& e, int bits, uint64_t& out) {
  if (e.count != 1) return E_COUNT;
  bool ifd_ok = bits >= 32;
  switch (e.type) {
    case T_BYTE: case T_SBYTE: case T_SHORT: case T_SSHORT: case T_LONG: case T_SLONG:
    case T_LONG8: case T_SLONG8:
      break;
    case T_IFD: case T_IFD8:
      if (ifd_ok) break;
      return E_TYPE;
    default:
      return E_TYPE;
  }
  uint8_t buf[8];
  if (type_width(e.type) == 8 && !f.big) {   // LONG8 in classic TIFF: out of line
    uint64_t off = f.u32(e.slot);
    if (!f.in(off, 8)) return E_IO;
    std::memcpy(buf, f.d + off, 8);
  } else {
    std::memcpy(buf, e.slot, 8);
  }
  bool neg;
  uint64_t v;
  int_value(f, e.type, buf, neg, v);
  if (neg) return E_RANGE;
  if (bits < 64 && v >> bits) return E_RANGE;
  out = v;
  return E_OK;
}

// TIFFReadDirEntryShortArray / Long8ArrayWithLimit: integer types only
Err read_uints(const File& f, const Entry& e, int bits, uint64_t maxcount,
               std::vector<uint64_t>& out) {
  out.clear();
  switch (e.type) {
    case T_BYTE: case T_SBYTE: case T_SHORT: case T_SSHORT: case T_LONG: case T_SLONG:
    case T_LONG8: case T_SLONG8:
      break;
    default:
      return E_TYPE;
  }
  std::vector<uint8_t> raw;
  uint32_t count;
  Err err = entry_bytes(f, e, maxcount, raw, count);
  if (err != E_OK) return err;
  int ts = type_width(e.type);
  out.resize(count);
  for (uint32_t i = 0; i < count; i++) {
    bool neg;
    uint64_t v;
    int_value(f, e.type, raw.data() + (size_t)i * ts, neg, v);
    if (neg || (bits < 64 && v >> bits)) {
      out.clear();
      return E_RANGE;
    }
    out[i] = v;
  }
  return E_OK;
}

// TIFFReadDirEntryFloatArray / DoubleArray: any numeric type
Err read_floats(const File& f, const Entry& e, std::vector<double>& out, bool as_float) {
  out.clear();
  switch (e.type) {
    case T_BYTE: case T_SBYTE: case T_SHORT: case T_SSHORT: case T_LONG: case T_SLONG:
    case T_LONG8: case T_SLONG8: case T_RATIONAL: case T_SRATIONAL: case T_FLOAT: case T_DOUBLE:
    case T_IFD: case T_IFD8:
      break;
    default:
      return E_TYPE;
  }
  std::vector<uint8_t> raw;
  uint32_t count;
  Err err = entry_bytes(f, e, UINT64_MAX, raw, count);
  if (err != E_OK) return err;
  int ts = type_width(e.type);
  out.resize(count);
  for (uint32_t i = 0; i < count; i++) {
    const uint8_t* p = raw.data() + (size_t)i * ts;
    double v;
    switch (e.type) {
      case T_RATIONAL: {
        uint32_t a = f.u32(p), b = f.u32(p + 4);
        v = b == 0 ? 0.0 : (as_float ? (double)((float)a / (float)b) : (double)a / (double)b);
        break;
      }
      case T_SRATIONAL: {
        int32_t a = (int32_t)f.u32(p), b = (int32_t)f.u32(p + 4);
        v = b == 0 ? 0.0 : (as_float ? (double)((float)a / (float)b) : (double)a / (double)b);
        break;
      }
      case T_FLOAT: {
        uint32_t bits = f.u32(p);
        float x;
        std::memcpy(&x, &bits, 4);
        v = x;
        break;
      }
      case T_DOUBLE: {
        uint64_t bits = f.u64(p);
        std::memcpy(&v, &bits, 8);
        break;
      }
      default: {
        bool neg;
        uint64_t u;
        int_value(f, e.type, p, neg, u);
        v = neg ? (double)(int64_t)u : (double)u;
        if (as_float) v = (float)v;
      }
    }
    out[i] = as_float ? (double)(float)v : v;
  }
  return E_OK;
}

// ----------------------------------------------------------------------------
// the directory (TIFFReadDirectory)
// ----------------------------------------------------------------------------

struct Dir {
  uint32_t width = 0, length = 0, depth = 1;
  uint16_t bits = 1, compression = C_NONE, photometric = 0, fillorder = 1, orientation = 1;
  uint16_t spp = 1, planar = 1, sampleformat = 1, predictor = 1, inkset = 1;
  bool has_photometric = false, has_orientation = false, has_rowsperstrip = false, has_spp = false;
  bool has_tiledims = false, has_offsets = false, has_counts = false, has_cmap = false;
  bool tiled = false;
  uint32_t rowsperstrip = 0xFFFFFFFFu, tilewidth = 0, tilelength = 0, tiledepth = 1;
  uint16_t extrasamples = 0;
  std::vector<uint16_t> sampleinfo;
  std::vector<uint16_t> cmap[3];
  uint16_t ycbcrsub[2] = {2, 2};
  float luma[3] = {0.299f, 0.587f, 0.114f};
  float refbw[6];
  // D50, as libtiff's TIFFVGetFieldDefaulted gives it
  float whitepoint[2] = {96.4250f / (96.4250f + 100.0f + 82.4680f),
                         100.0f / (96.4250f + 100.0f + 82.4680f)};
  bool has_refbw = false;
  uint32_t nstrips = 0, stripsperimage = 0;
  Entry offsets_entry{}, counts_entry{};
  std::vector<uint64_t> offsets, counts;
  uint64_t dircount = 0;
  std::vector<Entry> dir;
};

inline uint32_t howmany32(uint32_t x, uint32_t y) {
  return x < 0xFFFFFFFFu - (y - 1) ? (x + (y - 1)) / y : 0u;
}

inline uint64_t mul64(uint64_t a, uint64_t b) {
  if (a && b > UINT64_MAX / a) return 0;
  return a * b;
}

inline uint32_t mul32(uint32_t a, uint32_t b) {
  if (a && b > 0xFFFFFFFFu / a) return 0;
  return a * b;
}

bool ycbcr_packed(const Dir& d) { return d.planar == 1 && d.photometric == P_YCBCR; }

bool sub_ok(uint16_t s) { return s == 1 || s == 2 || s == 4; }

// TIFFScanlineSize64
uint64_t scanline_size(const Dir& d) {
  uint64_t size;
  if (d.planar == 1) {
    if (d.photometric == P_YCBCR && d.spp == 3) {
      if (!sub_ok(d.ycbcrsub[0]) || !sub_ok(d.ycbcrsub[1])) return 0;
      uint64_t block = (uint64_t)d.ycbcrsub[0] * d.ycbcrsub[1] + 2;
      uint64_t hor = howmany32(d.width, d.ycbcrsub[0]);
      uint64_t row = (mul64(mul64(hor, block), d.bits) + 7) / 8;
      size = row / d.ycbcrsub[1];
    } else {
      uint64_t samples = mul64(d.width, d.spp);
      size = (mul64(samples, d.bits) + 7) / 8;
    }
  } else {
    size = (mul64(d.width, d.bits) + 7) / 8;
  }
  return size;
}

// TIFFVStripSize64
uint64_t vstrip_size(const Dir& d, uint32_t nrows) {
  if (nrows == 0xFFFFFFFFu) nrows = d.length;
  if (ycbcr_packed(d)) {
    if (d.spp != 3 || !sub_ok(d.ycbcrsub[0]) || !sub_ok(d.ycbcrsub[1])) return 0;
    uint64_t block = (uint64_t)d.ycbcrsub[0] * d.ycbcrsub[1] + 2;
    uint64_t hor = howmany32(d.width, d.ycbcrsub[0]);
    uint64_t ver = howmany32(nrows, d.ycbcrsub[1]);
    uint64_t row = (mul64(mul64(hor, block), d.bits) + 7) / 8;
    return mul64(row, ver);
  }
  return mul64(nrows, scanline_size(d));
}

uint64_t strip_size(const Dir& d) {
  return vstrip_size(d, std::min(d.rowsperstrip, d.length));
}

// TIFFTileRowSize64
uint64_t tile_row_size(const Dir& d) {
  if (d.tilelength == 0 || d.tilewidth == 0) return 0;
  uint64_t row = mul64(d.bits, d.tilewidth);
  if (d.planar == 1) {
    if (d.spp == 0) return 0;
    row = mul64(row, d.spp);
  }
  return (row + 7) / 8;
}

// TIFFVTileSize64
uint64_t vtile_size(const Dir& d, uint32_t nrows) {
  if (d.tilelength == 0 || d.tilewidth == 0 || d.tiledepth == 0) return 0;
  if (d.planar == 1 && d.photometric == P_YCBCR && d.spp == 3) {
    if (!sub_ok(d.ycbcrsub[0]) || !sub_ok(d.ycbcrsub[1])) return 0;
    uint64_t block = (uint64_t)d.ycbcrsub[0] * d.ycbcrsub[1] + 2;
    uint64_t hor = howmany32(d.tilewidth, d.ycbcrsub[0]);
    uint64_t ver = howmany32(nrows, d.ycbcrsub[1]);
    uint64_t row = (mul64(mul64(hor, block), d.bits) + 7) / 8;
    return mul64(row, ver);
  }
  return mul64(nrows, tile_row_size(d));
}

uint64_t tile_size(const Dir& d) { return vtile_size(d, d.tilelength); }

int max_color_channels(uint16_t p) {
  switch (p) {
    case P_PALETTE: case P_MINISWHITE: case P_MINISBLACK: return 1;
    case P_YCBCR: case P_RGB: case P_CIELAB: case P_LOGLUV: case P_ITULAB: case P_ICCLAB: return 3;
    case P_SEPARATED: case P_MASK: return 4;
  }
  return 0;
}

// TIFFReadDirEntryPersampleShort: count >= spp, all of the first spp equal
Err read_persample_short(const File& f, const Entry& e, uint16_t spp, uint64_t& out) {
  if (e.count < spp) return E_COUNT;
  std::vector<uint64_t> v;
  Err err = read_uints(f, e, 16, UINT64_MAX, v);   // the whole array
  if (err != E_OK) return err;
  if (v.empty()) return E_COUNT;
  for (size_t i = 1; i < spp; i++)
    if (v[i] != v[0]) return E_PSDIF;
  out = v[0];
  return E_OK;
}

// TIFFReadDirEntryShort, then the per-sample form on a count error
Err read_short_or_persample(const File& f, const Entry& e, uint16_t spp, uint64_t& out) {
  Err err = read_uint(f, e, 16, out);
  if (err == E_COUNT) err = read_persample_short(f, e, spp, out);
  return err;
}

[[noreturn]] void bad(const char* why) { fail(REFUSED, std::string("cv2 gives no image: ") + why); }

// _TIFFVSetField of the fields that check their value; false: "Bad value"
bool set_u16(Dir& d, uint16_t tag, uint64_t v) {
  switch (tag) {
    case TAG_FILLORDER:
      if (v != 1 && v != 2) return false;
      d.fillorder = (uint16_t)v;
      return true;
    case TAG_ORIENTATION:
      if (v < 1 || v > 8) return false;
      d.orientation = (uint16_t)v;
      d.has_orientation = true;
      return true;
    case TAG_PHOTOMETRIC:
      d.photometric = (uint16_t)v;
      d.has_photometric = true;
      return true;
    case TAG_PREDICTOR:
      d.predictor = (uint16_t)v;
      return true;
    case TAG_INKSET:
      d.inkset = (uint16_t)v;
      return true;
    case TAG_PLANAR:
      if (v != 1 && v != 2) return false;
      d.planar = (uint16_t)v;
      return true;
  }
  return true;
}

// TIFFFetchNormalTag for the fields the decoder reads; `fatal` entries end
// the read on an error (the first pass), the others are dropped
bool fetch_normal(const File& f, Dir& d, const Entry& e) {
  uint64_t v = 0;
  switch (e.tag) {
    case TAG_WIDTH: case TAG_LENGTH: case TAG_IMAGEDEPTH: case TAG_TILEWIDTH:
    case TAG_TILELENGTH: case TAG_TILEDEPTH: case TAG_ROWSPERSTRIP:
      if (read_uint(f, e, 32, v) != E_OK) return false;
      switch (e.tag) {
        case TAG_WIDTH: d.width = (uint32_t)v; break;
        case TAG_LENGTH: d.length = (uint32_t)v; break;
        case TAG_IMAGEDEPTH: d.depth = (uint32_t)v; break;
        case TAG_TILEWIDTH: case TAG_TILELENGTH:
          (e.tag == TAG_TILEWIDTH ? d.tilewidth : d.tilelength) = (uint32_t)v;
          d.has_tiledims = d.tiled = true;
          break;
        case TAG_TILEDEPTH:
          if (v == 0) return false;
          d.tiledepth = (uint32_t)v;
          break;
        case TAG_ROWSPERSTRIP:
          if (v == 0) return false;
          d.rowsperstrip = (uint32_t)v;
          d.has_rowsperstrip = true;
          if (!d.has_tiledims) {
            d.tilelength = (uint32_t)v;
            d.tilewidth = d.width;
          }
          break;
      }
      return true;
    case TAG_SPP:
      if (read_uint(f, e, 16, v) != E_OK || v == 0) return false;
      d.spp = (uint16_t)v;
      d.has_spp = true;
      return true;
    case TAG_PLANAR: case TAG_PHOTOMETRIC: case TAG_FILLORDER: case TAG_ORIENTATION:
    case TAG_PREDICTOR: case TAG_INKSET:
      if (read_uint(f, e, 16, v) != E_OK) return false;
      return set_u16(d, e.tag, v);
    case TAG_EXTRASAMPLES: {
      if (e.count > 0xFFFF) return false;
      std::vector<uint64_t> vals;
      if (read_uints(f, e, 16, UINT64_MAX, vals) != E_OK) return false;
      uint16_t n = (uint16_t)e.count;
      if (n > d.spp) return false;
      std::vector<uint16_t> info(n);
      for (uint16_t i = 0; i < n; i++) {
        uint64_t s = i < vals.size() ? vals[i] : 0;
        if (s > 2) {
          if (s == 999) s = 2;   // Corel Draw's unassociated alpha
          else return false;
        }
        info[i] = (uint16_t)s;
      }
      d.extrasamples = n;
      d.sampleinfo = info;
      return true;
    }
    case TAG_YCBCRSUB: {
      if (e.count != 2) return false;
      std::vector<uint64_t> vals;
      if (read_uints(f, e, 16, UINT64_MAX, vals) != E_OK || vals.size() != 2) return false;
      d.ycbcrsub[0] = (uint16_t)vals[0];
      d.ycbcrsub[1] = (uint16_t)vals[1];
      return true;
    }
    case TAG_YCBCRCOEF: case TAG_REFBW: case TAG_WHITEPOINT: {
      uint64_t want = e.tag == TAG_REFBW ? 6 : e.tag == TAG_WHITEPOINT ? 2 : 3;
      if (e.count != want) return false;
      std::vector<double> vals;
      if (read_floats(f, e, vals, true) != E_OK || vals.size() != want) return false;
      float* dst = e.tag == TAG_REFBW ? d.refbw : e.tag == TAG_WHITEPOINT ? d.whitepoint : d.luma;
      for (uint64_t i = 0; i < want; i++) dst[i] = (float)vals[i];
      if (e.tag == TAG_REFBW) d.has_refbw = true;
      return true;
    }
  }
  return true;
}

// TIFFFetchDirectory and TIFFReadDirectory of the first IFD
Dir read_directory(const File& f0, File& f) {
  f = f0;
  if (f.n < 8) bad("cannot read the TIFF header");
  if (f.d[0] == 'M' && f.d[1] == 'M') f.swab = true;
  else if (!(f.d[0] == 'I' && f.d[1] == 'I')) bad("bad magic number");
  uint16_t version = f.u16(f.d + 2);
  uint64_t diroff;
  if (version == 42) {
    diroff = f.u32(f.d + 4);
  } else if (version == 43) {
    if (f.n < 16) bad("cannot read the BigTIFF header");
    if (f.u16(f.d + 4) != 8) bad("bad BigTIFF offset size");
    if (f.u16(f.d + 6) != 0) bad("bad BigTIFF header");
    diroff = f.u64(f.d + 8);
    f.big = true;
  } else {
    bad("bad version number");
  }
  // TIFFFetchDirectory
  Dir d;
  uint64_t count;
  int esize = f.big ? 20 : 12;
  if (!f.big) {
    if (!f.in(diroff, 2)) bad("cannot read the directory count");
    count = f.u16(f.d + diroff);
    diroff += 2;
  } else {
    if (!f.in(diroff, 8)) bad("cannot read the directory count");
    count = f.u64(f.d + diroff);
    diroff += 8;
  }
  if (count > 4096) bad("directory count fails its sanity check");
  if (count == 0) bad("a directory without entries");
  if (!f.in(diroff, count * esize)) bad("cannot read the directory");
  d.dircount = count;
  d.dir.resize(count);
  for (uint64_t i = 0; i < count; i++) {
    const uint8_t* p = f.d + diroff + i * esize;
    Entry& e = d.dir[i];
    e.tag = f.u16(p);
    e.type = f.u16(p + 2);
    std::memset(e.slot, 0, 8);
    if (f.big) {
      e.count = f.u64(p + 4);
      std::memcpy(e.slot, p + 12, 8);
    } else {
      e.count = f.u32(p + 4);
      std::memcpy(e.slot, p + 8, 4);
    }
  }
  // duplicates of a tag are ignored: the first one counts
  for (uint64_t i = 0; i < count; i++)
    for (uint64_t j = i + 1; j < count; j++)
      if (d.dir[j].tag == d.dir[i].tag) d.dir[j].ignore = true;
  auto find = [&](uint16_t tag) -> Entry* {
    for (auto& e : d.dir)
      if (e.tag == tag) return &e;   // the first, ignored or not
    return nullptr;
  };
  // SamplesPerPixel, then Compression (one value, or one per sample)
  if (Entry* e = find(TAG_SPP)) {
    if (!e->ignore) {
      if (!fetch_normal(f, d, *e)) bad("bad SamplesPerPixel");
      e->ignore = true;
    }
  }
  if (Entry* e = find(TAG_COMPRESSION)) {
    if (!e->ignore) {
      uint64_t v;
      if (read_short_or_persample(f, *e, d.spp, v) != E_OK) bad("bad Compression");
      d.compression = (uint16_t)v;
      e->ignore = true;
    }
  }
  // the first pass: the fields that size the data
  for (auto& e : d.dir) {
    if (e.ignore) continue;
    switch (e.tag) {
      case TAG_STRIPOFFSETS: case TAG_TILEOFFSETS: d.has_offsets = true; break;
      case TAG_STRIPBYTECOUNTS: case TAG_TILEBYTECOUNTS: d.has_counts = true; break;
      case TAG_WIDTH: case TAG_LENGTH: case TAG_IMAGEDEPTH: case TAG_TILELENGTH:
      case TAG_TILEWIDTH: case TAG_TILEDEPTH: case TAG_PLANAR: case TAG_ROWSPERSTRIP:
      case TAG_EXTRASAMPLES:
        if (!fetch_normal(f, d, e)) bad("a field that sizes the data is unreadable");
        e.ignore = true;
        break;
      case TAG_PREDICTOR:   // a codec tag: only LZW's and Deflate's
        if (!(d.compression == C_LZW || d.compression == C_DEFLATE ||
              d.compression == C_ADOBE_DEFLATE))
          e.ignore = true;
        break;
    }
  }
  bool have_dims = false;
  for (auto& e : d.dir)
    if ((e.tag == TAG_WIDTH || e.tag == TAG_LENGTH) && e.ignore) {
      have_dims = true;   // fetched in the first pass
    }
  if (!have_dims) bad("missing ImageLength");
  // strips or tiles
  if (!d.has_tiledims) {
    uint32_t ns = d.rowsperstrip == 0xFFFFFFFFu ? 1 : howmany32(d.length, d.rowsperstrip);
    if (d.planar == 2) ns = mul32(ns, d.spp);
    d.nstrips = ns;
    d.tilewidth = d.width;
    d.tilelength = d.rowsperstrip;
    d.tiledepth = d.depth;
    d.tiled = false;
  } else {
    uint32_t dx = d.tilewidth, dy = d.tilelength, dz = d.tiledepth;
    if (dx == 0xFFFFFFFFu) dx = d.width;
    if (dy == 0xFFFFFFFFu) dy = d.length;
    if (dz == 0xFFFFFFFFu) dz = d.depth;
    uint32_t nt = (dx == 0 || dy == 0 || dz == 0) ? 0 :
        mul32(mul32(howmany32(d.width, dx), howmany32(d.length, dy)), howmany32(d.depth, dz));
    if (d.planar == 2) nt = mul32(nt, d.spp);
    d.nstrips = nt;
    d.tiled = true;
  }
  if (d.nstrips == 0) bad("zero strips or tiles");
  d.stripsperimage = d.nstrips;
  if (d.planar == 2) d.stripsperimage /= d.spp;
  if (!d.has_offsets) bad("missing StripOffsets");
  // the second pass, in the directory's order
  bool bits_read = false;
  uint64_t datasize_read = 0;
  auto datasize_ok = [&](const Entry& e) {   // EvaluateIFDdatasizeReading
    uint64_t w = type_width(e.type);
    if (w != 0 && e.count > UINT64_MAX / w) return false;
    uint64_t len = e.count * w;
    if (len > (f.big ? 8u : 4u)) {
      if (datasize_read > UINT64_MAX - len) return false;
      datasize_read += len;
    }
    return true;
  };
  for (auto& e : d.dir) {
    if (e.ignore) continue;
    uint64_t v;
    switch (e.tag) {
      case TAG_MINSAMPLE: case TAG_MAXSAMPLE: case TAG_BITS: case TAG_DATATYPE:
      case TAG_SAMPLEFORMAT: case TAG_SMINSAMPLE: case TAG_SMAXSAMPLE: case TAG_STRIPOFFSETS:
      case TAG_TILEOFFSETS: case TAG_STRIPBYTECOUNTS: case TAG_TILEBYTECOUNTS:
        if (!datasize_ok(e)) bad("too large IFD data");
        break;
      case TAG_COLORMAP: case TAG_TRANSFER:
        if (bits_read && d.bits <= 24 && !datasize_ok(e)) bad("too large IFD data");
        break;
    }
    switch (e.tag) {
      case TAG_MINSAMPLE: case TAG_MAXSAMPLE: case TAG_BITS: case TAG_DATATYPE:
      case TAG_SAMPLEFORMAT: {
        if (read_short_or_persample(f, e, d.spp, v) != E_OK) bad("an unreadable sample field");
        if (e.tag == TAG_BITS) {
          d.bits = (uint16_t)v;
          bits_read = true;
        } else if (e.tag == TAG_SAMPLEFORMAT) {
          if (v < 1 || v > 6) bad("bad SampleFormat");
          d.sampleformat = (uint16_t)v;
        } else if (e.tag == TAG_DATATYPE) {
          static const uint16_t map[4] = {4, 2, 1, 3};
          if (v > 3) bad("bad DataType");
          d.sampleformat = map[v];
        }
        break;
      }
      case TAG_SMINSAMPLE: case TAG_SMAXSAMPLE: {
        std::vector<double> vals;
        if (e.count != d.spp || read_floats(f, e, vals, false) != E_OK)
          bad("an unreadable sample field");
        break;
      }
      case TAG_STRIPOFFSETS: case TAG_TILEOFFSETS:
        d.offsets_entry = e;
        break;
      case TAG_STRIPBYTECOUNTS: case TAG_TILEBYTECOUNTS:
        d.counts_entry = e;
        break;
      case TAG_COLORMAP: case TAG_TRANSFER: {
        if (!bits_read || d.bits > 24) break;
        uint64_t per = 1ull << d.bits;
        if (e.tag == TAG_TRANSFER) break;   // not used by the RGBA path
        if (e.count != 3 * per) break;
        std::vector<uint64_t> vals;
        if (read_uints(f, e, 16, UINT64_MAX, vals) != E_OK) break;
        for (int c = 0; c < 3; c++)
          d.cmap[c].assign(vals.begin() + c * per, vals.begin() + (c + 1) * per);
        d.has_cmap = true;
        break;
      }
      default:
        fetch_normal(f, d, e);   // errors dropped
    }
  }
  // non-colour samples are extra samples
  int cc = max_color_channels(d.photometric);
  if (cc && d.spp - d.extrasamples > cc) {
    uint16_t n = (uint16_t)(d.spp - cc);
    std::vector<uint16_t> info(n, 0);
    for (size_t i = 0; i < d.sampleinfo.size() && i < n; i++) info[i] = d.sampleinfo[i];
    d.extrasamples = n;
    d.sampleinfo = info;
  }
  if (d.photometric == P_PALETTE && !d.has_cmap) {
    if (d.bits >= 8 && d.spp == 3) d.photometric = P_RGB;
    else if (d.bits >= 8) d.photometric = P_MINISBLACK;
    else bad("a palette image without a Colormap");
  }
  // the strip arrays (TIFFFetchStripThing: padded with zeros, cut at nstrips)
  auto strip_thing = [&](const Entry& e, std::vector<uint64_t>& out) {
    std::vector<uint64_t> vals;
    if (read_uints(f, e, 64, d.nstrips, vals) != E_OK)
      bad("unreadable strip offsets or byte counts");
    if (e.count < d.nstrips) {
      if (d.nstrips > 1000000) bad("too many strips");
      if ((uint64_t)d.nstrips * 8 > 100u * 1024 * 1024 && (uint64_t)d.nstrips * 8 > f.n)
        bad("too many strips for the file");
    }
    vals.resize(d.nstrips, 0);
    out = vals;
  };
  strip_thing(d.offsets_entry, d.offsets);
  if (d.has_counts) strip_thing(d.counts_entry, d.counts);
  // StripByteCounts missing or implausible: estimated (EstimateStripByteCounts)
  auto estimate = [&]() {
    d.counts.assign(d.nstrips, 0);
    if (d.compression != C_NONE) {
      uint64_t space = f.big ? 16 + 8 + d.dircount * 20 + 8 : 8 + 2 + d.dircount * 12 + 4;
      for (auto& e : d.dir) {
        uint64_t w = type_width(e.type);
        if (w == 0) bad("a field of unknown type");
        if (e.count > UINT64_MAX / w) bad("a field too large");
        uint64_t size = w * e.count;
        if (size <= (f.big ? 8u : 4u)) size = 0;
        if (space > UINT64_MAX - size) bad("fields too large");
        space += size;
      }
      space = f.n < space ? f.n : f.n - space;
      if (d.planar == 2) space /= d.spp;
      for (auto& c : d.counts) c = space;
      uint32_t last = d.nstrips - 1;
      if (d.offsets[last] > UINT64_MAX - d.counts[last]) bad("strip offsets overflow");
      if (d.offsets[last] + d.counts[last] > f.n)
        d.counts[last] = d.offsets[last] >= f.n ? 0 : f.n - d.offsets[last];
    } else if (d.tiled) {
      uint64_t t = tile_size(d);
      for (auto& c : d.counts) c = t;
    } else {
      uint64_t row = scanline_size(d);
      uint32_t rps = d.length / d.stripsperimage;
      for (auto& c : d.counts) {
        if (row > 0 && rps > UINT64_MAX / row) bad("strip size overflow");
        c = row * rps;
      }
    }
    d.has_counts = true;
    if (!d.has_rowsperstrip) d.rowsperstrip = d.length;
  };
  if (!d.has_counts) {
    if ((d.planar == 1 && d.nstrips > 1) || (d.planar == 2 && d.nstrips != d.spp))
      bad("missing StripByteCounts");
    estimate();
  } else if (d.nstrips == 1 && !d.tiled) {
    // ByteCountLooksBad
    uint64_t bc = d.counts[0], off = d.offsets[0];
    bool looks_bad = false;
    if (off != 0) {
      if (bc == 0) looks_bad = true;
      else if (d.compression == C_NONE) {
        if (off <= f.n && bc > f.n - off) looks_bad = true;
        else {
          uint64_t row = scanline_size(d);
          if (d.length > 0 && row > UINT64_MAX / d.length) looks_bad = true;
          else if (bc < row * d.length) looks_bad = true;
        }
      }
    }
    if (looks_bad) estimate();
  } else if (d.planar == 1 && d.nstrips > 2 && d.compression == C_NONE &&
             d.counts[0] != d.counts[1] && d.counts[0] != 0 && d.counts[1] != 0) {
    estimate();
  }
  if (scanline_size(d) == 0 || scanline_size(d) > (uint64_t)INT64_MAX) bad("zero scanline size");
  if (d.tiled) {
    if (tile_size(d) == 0) bad("zero tile size");
  } else if (strip_size(d) == 0) {
    bad("zero strip size");
  }
  return d;
}

// OpenCV's TiffDecoder::readHeader: its checks of the bit depth and the
// sample format
// OpenCV's channel count: the SamplesPerPixel tag, or 1 (gray) / 3 without it
uint32_t opencv_channels(const Dir& d) {
  return d.has_spp ? d.spp
                   : (d.photometric == P_MINISWHITE || d.photometric == P_MINISBLACK) ? 1 : 3;
}

void opencv_header(const Dir& d) {
  if (!d.has_photometric) bad("no PhotometricInterpretation (OpenCV requires it)");
  uint32_t ncn = opencv_channels(d);
  if (ncn < 1 || ncn > 4) bad("more than 4 samples (OpenCV refuses)");
  bool sf_int = d.sampleformat == 1 || d.sampleformat == 2;
  switch (d.bits) {
    case 1: case 8: case 10: case 12: case 14: case 16:
      if (!sf_int) bad("a sample format OpenCV refuses");
      break;
    case 4:
      if (d.photometric != P_PALETTE) bad("4-bit samples outside a palette");
      if (!sf_int) bad("a sample format OpenCV refuses");
      break;
    case 32:
      if (!(d.sampleformat == 3 || d.sampleformat == 2)) bad("a sample format OpenCV refuses");
      break;
    case 64:
      if (d.sampleformat != 3) bad("a sample format OpenCV refuses");
      break;
    default:
      bad("a bit depth OpenCV refuses");
  }
}

// ----------------------------------------------------------------------------
// codecs
// ----------------------------------------------------------------------------

struct CodeEntry {
  int32_t next;   // index, -1 none
  uint16_t length;
  uint8_t value, firstchar;
};

const int CODE_CLEAR = 256, CODE_EOI = 257, CODE_FIRST = 258, BITS_MAX = 12;
const int CSIZE = (1 << BITS_MAX) - 1 + 1024;

struct Lzw {
  std::vector<CodeEntry> tab;
  Lzw() : tab(CSIZE) {
    for (int c = 0; c < 256; c++) tab[c] = {-1, 1, (uint8_t)c, (uint8_t)c};
    tab[256] = tab[257] = {-1, 0, 0, 0};
  }
  // writes the first `occ` (or all) bytes of code's string at op
  void emit(int code, uint8_t* op, int64_t len) const {
    int64_t full = tab[code].length;
    int c = code;
    for (int64_t k = full; k > len; k--) c = tab[c].next;
    for (int64_t k = len - 1; k >= 0 && c >= 0; k--) {
      op[k] = tab[c].value;
      c = tab[c].next;
    }
  }
};

// LZWDecode (new-style codes): 1 ok, 0 error
int lzw_decode(Lzw& z, const uint8_t* src, int64_t cc, uint8_t* op, int64_t occ) {
  int nbits = 9;
  int64_t nbitsmask = 511, maxcode = 510;   // the entry past which the width grows
  int64_t free_ent = -1;                    // before the first clear code nothing is defined
  int64_t oldcode = 0;
  uint64_t acc = 0;
  int accbits = 0;
  int64_t pos = 0;
  auto next = [&](int& code) -> bool {
    while (accbits < nbits) {
      if (pos >= cc) return false;
      acc = acc << 8 | src[pos++];
      accbits += 8;
    }
    accbits -= nbits;
    code = (int)((acc >> accbits) & (uint64_t)nbitsmask);
    acc &= (1ull << accbits) - 1;
    return true;
  };
  auto grow = [&]() {
    if (++free_ent > maxcode) {
      if (++nbits > BITS_MAX) nbits = BITS_MAX;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask - 1;
      if (free_ent >= CSIZE) free_ent = -1;
    }
  };
  while (occ > 0) {
    int code;
    if (!next(code)) {
      std::memset(op, 0, (size_t)occ);
      return 0;
    }
    if (code == CODE_EOI) break;
    if (code == CODE_CLEAR) {
      free_ent = CODE_FIRST;
      nbits = 9;
      nbitsmask = 511;
      maxcode = 510;
      do {
        if (!next(code)) {
          std::memset(op, 0, (size_t)occ);
          return 0;
        }
      } while (code == CODE_CLEAR);
      if (code == CODE_EOI) break;
      if (code > CODE_EOI) {
        std::memset(op, 0, (size_t)occ);
        return 0;
      }
      *op++ = (uint8_t)code;
      occ--;
      oldcode = code;
      continue;
    }
    if (code < 256) {
      if (code > free_ent) {
        std::memset(op, 0, (size_t)occ);
        return 0;
      }
      CodeEntry& ne = z.tab[free_ent];
      ne.next = (int32_t)oldcode;
      ne.firstchar = z.tab[oldcode].firstchar;
      ne.length = (uint16_t)(z.tab[oldcode].length + 1);
      ne.value = (uint8_t)code;
      grow();
      oldcode = code;
      *op++ = (uint8_t)code;
      occ--;
      continue;
    }
    // code >= 258
    if (code >= free_ent) {
      if (code != free_ent) {
        std::memset(op, 0, (size_t)occ);
        return 0;
      }
      z.tab[free_ent].value = z.tab[oldcode].firstchar;
    } else {
      z.tab[free_ent].value = z.tab[code].firstchar;
    }
    CodeEntry& ne = z.tab[free_ent];
    ne.next = (int32_t)oldcode;
    ne.firstchar = z.tab[oldcode].firstchar;
    ne.length = (uint16_t)(z.tab[oldcode].length + 1);
    grow();
    oldcode = code;
    int64_t len = z.tab[code].length;
    if (len > occ) {
      z.emit(code, op, occ);
      return 1;
    }
    z.emit(code, op, len);
    op += len;
    occ -= len;
  }
  return occ > 0 ? 0 : 1;
}

// LZWDecodeCompat (old-style, bit-reversed codes): 1 ok, 0 error
int lzw_decode_compat(Lzw& z, const uint8_t* src, int64_t cc, uint8_t* op, int64_t occ) {
  int nbits = 9;
  int64_t nbitsmask = 511, maxcode = 511;
  int64_t free_ent = -1, oldcode = 0;
  uint64_t acc = 0;
  int accbits = 0;
  int64_t pos = 0, bitsleft = cc * 8;
  auto next = [&]() -> int {
    if (bitsleft < nbits) return CODE_EOI;   // not terminated: taken as the end
    while (accbits < nbits) {
      acc |= (uint64_t)src[pos++] << accbits;
      accbits += 8;
    }
    int code = (int)(acc & (uint64_t)nbitsmask);
    acc >>= nbits;
    accbits -= nbits;
    bitsleft -= nbits;
    return code;
  };
  while (occ > 0) {
    int code = next();
    if (code == CODE_EOI) break;
    if (code == CODE_CLEAR) {
      do {
        free_ent = CODE_FIRST;
        for (int k = CODE_FIRST; k < CSIZE; k++) z.tab[k] = {-1, 0, 0, 0};
        nbits = 9;
        nbitsmask = 511;
        maxcode = 511;
        code = next();
      } while (code == CODE_CLEAR);
      if (code == CODE_EOI) break;
      if (code > CODE_CLEAR) return 0;
      *op++ = (uint8_t)code;
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= CSIZE) return 0;
    CodeEntry& ne = z.tab[free_ent];
    ne.next = (int32_t)oldcode;
    ne.firstchar = z.tab[oldcode].firstchar;
    ne.length = (uint16_t)(z.tab[oldcode].length + 1);
    ne.value = code < free_ent ? z.tab[code].firstchar : ne.firstchar;
    if (++free_ent > maxcode) {
      if (++nbits > BITS_MAX) nbits = BITS_MAX;
      nbitsmask = (1 << nbits) - 1;
      maxcode = nbitsmask;
    }
    oldcode = code;
    if (code >= 256) {
      int64_t len = z.tab[code].length;
      if (len == 0) return 0;
      if (len > occ) {
        z.emit(code, op, occ);
        occ = 0;
        break;
      }
      // the chain may end early in a corrupt table: the rest stays as it was
      int c = code;
      for (int64_t k = len - 1; k >= 0 && c >= 0; k--) {
        op[k] = z.tab[c].value;
        c = z.tab[c].next;
      }
      op += len;
      occ -= len;
    } else {
      *op++ = (uint8_t)code;
      occ--;
    }
  }
  return occ > 0 ? 0 : 1;
}

// PackBitsDecode: 1 ok, 0 error (the rest zero-filled)
int packbits_decode(const uint8_t* bp, int64_t cc, uint8_t* op, int64_t occ) {
  while (cc > 0 && occ > 0) {
    int n = (int8_t)*bp++;
    cc--;
    if (n < 0) {
      if (n == -128) continue;
      int64_t k = -n + 1;
      if (occ < k) k = occ;
      if (cc == 0) break;
      occ -= k;
      uint8_t b = *bp++;
      cc--;
      std::memset(op, b, (size_t)k);
      op += k;
    } else {
      int64_t k = n + 1;
      if (occ < k) k = occ;
      if (cc < k) break;
      std::memcpy(op, bp, (size_t)k);
      op += k;
      occ -= k;
      bp += k;
      cc -= k;
    }
  }
  if (occ > 0) {
    std::memset(op, 0, (size_t)occ);
    return 0;
  }
  return 1;
}

// ZIPDecode through zlib's inflate: 1 ok, 0 error (what was inflated stays)
int zip_decode(const uint8_t* src, int64_t cc, uint8_t* op, int64_t occ) {
  z_stream s;
  std::memset(&s, 0, sizeof(s));
  if (inflateInit(&s) != Z_OK) fail(NOMEM, "inflateInit failed");
  s.next_in = const_cast<Bytef*>(src);
  s.next_out = op;
  int64_t rawcc = cc;
  int rc = 1;
  do {
    uInt in_before = (uint64_t)rawcc <= 0xFFFFFFFFu ? (uInt)rawcc : 0xFFFFFFFFu;
    uInt out_before = (uint64_t)occ < 0xFFFFFFFFu ? (uInt)occ : 0xFFFFFFFFu;
    s.avail_in = in_before;
    s.avail_out = out_before;
    int state = inflate(&s, Z_PARTIAL_FLUSH);
    rawcc -= in_before - s.avail_in;
    occ -= out_before - s.avail_out;
    if (state == Z_STREAM_END) break;
    if (state != Z_OK) {
      rc = 0;
      break;
    }
  } while (occ > 0);
  if (rc && occ != 0) rc = 0;
  inflateEnd(&s);
  return rc;
}

// ----------------------------------------------------------------------------
// reading strips and tiles (tif_read.c, tif_predict.c)
// ----------------------------------------------------------------------------

struct Reader {
  const File& f;
  const Dir& d;
  bool coder_setup = false;
  int lzw_mode = -1;   // -1 undecided, 0 new-style, 1 compat: the first strip read decides
  uint64_t rawdatasize = 0;   // tif_rawdatasize: the chunk in the map, or the copy's buffer
  Lzw lzw;
  std::vector<uint8_t> rev;
  Reader(const File& f_, const Dir& d_) : f(f_), d(d_) {}

  bool uses_predictor() const {
    return d.compression == C_LZW || d.compression == C_DEFLATE ||
           d.compression == C_ADOBE_DEFLATE;
  }

  // PredictorSetup (and the codecs' own setup): false where it fails
  bool setup() {
    if (coder_setup) return true;
    // of the depths TIFFRGBAImage takes, differencing accepts 8 and 16 bits;
    // the floating-point predictor needs float samples, refused before
    if (uses_predictor() && d.predictor != 1 &&
        !(d.predictor == 2 && (d.bits == 8 || d.bits == 16)))
      return false;
    coder_setup = true;
    return true;
  }

  // TIFFFillStrip / TIFFFillTile and TIFFStartStrip: the chunk's raw bytes
  // (bits reversed for FillOrder 2), or null where it cannot be read
  const uint8_t* fill(uint32_t idx, int64_t& cc, bool is_tile) {
    uint64_t bc = d.counts[idx], off = d.offsets[idx];
    if (bc == 0 || bc > (uint64_t)INT64_MAX) return nullptr;
    if (bc > 1024 * 1024) {
      uint64_t size = is_tile ? tile_size(d) : strip_size(d);
      if (size != 0 && (bc - 4096) / 10 > size) bc = size * 10 + 4096;
    }
    if (bc > f.n || off > f.n - bc) return nullptr;
    if (!setup()) return nullptr;
    const uint8_t* raw = f.d + off;
    if (d.fillorder != 2) rawdatasize = bc;   // read in place
    else if (bc > rawdatasize) rawdatasize = (bc + 1023) / 1024 * 1024;   // a copy, grown
    if (d.fillorder == 2) {
      rev.resize(bc);
      for (uint64_t i = 0; i < bc; i++) {
        uint8_t b = raw[i];
        b = (uint8_t)((b * 0x0202020202ULL & 0x010884422010ULL) % 1023);
        rev[i] = b;
      }
      raw = rev.data();
    }
    cc = (int64_t)bc;
    if (d.compression == C_LZW && lzw_mode < 0)
      lzw_mode = (cc >= 2 && raw[0] == 0 && (raw[1] & 1)) ? 1 : 0;
    return raw;
  }

  // the codec on one chunk: 1 ok, 0 error
  int decode(const uint8_t* raw, int64_t cc, uint8_t* buf, int64_t size) {
    switch (d.compression) {
      case C_NONE:
        if (cc < size) return 0;
        std::memcpy(buf, raw, (size_t)size);
        return 1;
      case C_PACKBITS:
        return packbits_decode(raw, cc, buf, size);
      case C_LZW:
        return lzw_mode == 1 ? lzw_decode_compat(lzw, raw, cc, buf, size)
                             : lzw_decode(lzw, raw, cc, buf, size);
      case C_DEFLATE: case C_ADOBE_DEFLATE:
        return zip_decode(raw, cc, buf, size);
    }
    return 0;   // a scheme libtiff has no codec for: nothing decoded
  }

  // _TIFFSwab16BitData (the only deep samples the RGBA path takes)
  void swab(uint8_t* buf, int64_t size) const {
    if (!f.swab || d.bits != 16) return;
    for (int64_t i = 0; i + 2 <= size; i += 2) std::swap(buf[i], buf[i + 1]);
  }

  // horizontal accumulation of one row (horAcc8, swabHorAcc16 / horAcc16)
  bool accumulate(uint8_t* row, int64_t rowsize) const {
    int stride = d.planar == 1 ? d.spp : 1;
    if (d.bits == 8) {
      if (rowsize % stride != 0) return false;
      for (int64_t i = stride; i < rowsize; i++) row[i] = (uint8_t)(row[i] + row[i - stride]);
      return true;
    }
    if (rowsize % (2 * stride) != 0) return false;
    swab(row, rowsize);
    uint16_t* w = reinterpret_cast<uint16_t*>(row);
    for (int64_t i = stride; i < rowsize / 2; i++) w[i] = (uint16_t)(w[i] + w[i - stride]);
    return true;
  }

  // decode + predictor + post-decode swab: returns the decoder's status
  int decode_chunk(const uint8_t* raw, int64_t cc, uint8_t* buf, int64_t size) {
    if (!decode(raw, cc, buf, size)) return 0;
    if (uses_predictor() && d.predictor == 2) {
      int64_t rowsize = (int64_t)(d.tiled ? tile_row_size(d) : scanline_size(d));
      if (size % rowsize != 0) return 0;
      for (int64_t o = 0; o < size; o += rowsize)
        if (!accumulate(buf + o, rowsize)) return 0;
      return 1;
    }
    swab(buf, size);
    return 1;
  }

  // _TIFFReadEncodedStripAndAllocBuffer / _TIFFReadEncodedTileAndAllocBuffer:
  // false where the chunk cannot be read (no buffer: no image)
  bool read_first(uint32_t idx, std::vector<uint8_t>& buf, uint64_t bufsize, int64_t size,
                  bool is_tile) {
    if (idx >= d.nstrips) return false;
    int64_t cc;
    const uint8_t* raw = fill(idx, cc, is_tile);
    if (!raw) return false;
    if (is_tile) {   // the sanity checks of _TIFFReadEncodedTileAndAllocBuffer
      uint64_t ts = tile_size(d);
      if (d.compression == C_NONE && rawdatasize != ts) return false;
      if (d.compression != C_NONE && bufsize > 100000000 && rawdatasize < ts / 1000) return false;
    }
    buf.assign(bufsize + SLACK, 0);
    decode_chunk(raw, cc, buf.data(), size);
    return true;
  }

  // TIFFReadEncodedStrip / TIFFReadEncodedTile into an existing buffer
  void read_more(uint32_t idx, uint8_t* buf, int64_t size, bool is_tile) {
    if (idx >= d.nstrips) return;
    int64_t cc;
    const uint8_t* raw = fill(idx, cc, is_tile);
    if (!raw) {
      std::memset(buf, 0, (size_t)size);
      return;
    }
    decode_chunk(raw, cc, buf, size);
  }

  static const int SLACK = 64;   // reads past a buffer by quirky skews see zeros
};

// ----------------------------------------------------------------------------
// TIFFRGBAImage (tif_getimage.c)
// ----------------------------------------------------------------------------

inline uint32_t pack(uint32_t r, uint32_t g, uint32_t b, uint32_t a = 255) {
  return r | g << 8 | b << 16 | a << 24;
}

enum Put {
  PUT_NONE, PUT_BW1, PUT_BW2, PUT_BW4, PUT_GREY8, PUT_AGREY8, PUT_BW16, PUT_CMAP1, PUT_CMAP2,
  PUT_CMAP4, PUT_CMAP8, PUT_RGB8, PUT_RGBAA8, PUT_RGBUA8, PUT_RGB16, PUT_RGBAA16, PUT_RGBUA16,
  PUT_CMYK8, PUT_YCBCR, PUT_CIELAB,
  // separate planes
  PUT_SEP_RGB8, PUT_SEP_RGBAA8, PUT_SEP_RGBUA8, PUT_SEP_RGB16, PUT_SEP_RGBAA16, PUT_SEP_RGBUA16,
  PUT_SEP_CMYK8, PUT_SEP_YCBCR11
};

struct YCbCr {
  int32_t Cr_r[256], Cb_b[256], Cr_g[256], Cb_g[256], Y[256];
  void init(const float* luma, const float* rbw) {
    const int SHIFT = 16;
    auto FIX = [](float x) { return (int32_t)(x * (float)(1L << 16) + 0.5); };
    auto CLAMPF = [](float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; };
    const int32_t ONE_HALF = 1 << (SHIFT - 1);
    float f1 = 2 - 2 * luma[0];
    int32_t D1 = FIX(CLAMPF(f1, 0.0f, 2.0f));
    float f2 = luma[0] * f1 / luma[1];
    int32_t D2 = -FIX(CLAMPF(f2, 0.0f, 2.0f));
    float f3 = 2 - 2 * luma[2];
    int32_t D3 = FIX(CLAMPF(f3, 0.0f, 2.0f));
    float f4 = luma[2] * f3 / luma[1];
    int32_t D4 = -FIX(CLAMPF(f4, 0.0f, 2.0f));
    auto code2v = [](int c, float RB, float RW, float CR) {
      return ((float)(c - (int32_t)RB) * CR) / ((RW - RB) != 0 ? (RW - RB) : 1.0f);
    };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      int32_t Cr = (int32_t)CLAMPF(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127), -128.0f * 32,
                                   128.0f * 32);
      int32_t Cb = (int32_t)CLAMPF(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127), -128.0f * 32,
                                   128.0f * 32);
      Cr_r[i] = (int32_t)((D1 * Cr + ONE_HALF) >> SHIFT);
      Cb_b[i] = (int32_t)((D3 * Cb + ONE_HALF) >> SHIFT);
      Cr_g[i] = D2 * Cr;
      Cb_g[i] = D4 * Cb + ONE_HALF;
      Y[i] = (int32_t)CLAMPF(code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32, 128.0f * 32);
    }
  }
  uint32_t rgb(uint32_t y, int32_t cb, int32_t cr) const {
    if (y > 255) y = 255;
    cb = cb < 0 ? 0 : cb > 255 ? 255 : cb;
    cr = cr < 0 ? 0 : cr > 255 ? 255 : cr;
    auto clamp = [](int32_t v) { return (uint32_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    int32_t i = Y[y] + Cr_r[cr];
    uint32_t r = clamp(i);
    i = Y[y] + (int32_t)((Cb_g[cb] + Cr_g[cr]) >> 16);
    uint32_t g = clamp(i);
    i = Y[y] + Cb_b[cb];
    uint32_t b = clamp(i);
    return pack(r, g, b);
  }
};

// TIFFCIELabToRGBInit / TIFFCIELab16ToXYZ / TIFFXYZToRGB (tif_color.c)
// with tif_getimage.c's display_sRGB and the file's white point
struct CieLab {
  static constexpr int RANGE = 1500;
  float mat[3][3] = {{3.2410f, -1.5374f, -0.4986f}, {-0.9692f, 1.8760f, 0.0416f},
                     {0.0556f, -0.2040f, 1.0570f}};
  float Y0 = 1.0f, YC = 100.0f, step = 0.0f, X0w = 0, Y0w = 0, Z0w = 0;
  float table[RANGE + 1];
  struct Xyz {
    float X, Y, Z;
  };
  void init(const float* wp) {
    float ref1 = 100.0f;
    float ref0 = wp[0] / wp[1] * ref1;
    float ref2 = (1.0f - wp[0] - wp[1]) / wp[1] * ref1;
    double gamma = 1.0 / 2.4f;
    step = (YC - Y0) / RANGE;
    for (int i = 0; i <= RANGE; i++)
      table[i] = 255 * ((float)std::pow((double)i / RANGE, gamma));
    X0w = ref0;
    Y0w = ref1;
    Z0w = ref2;
  }
  Xyz xyz(uint32_t l, int32_t a, int32_t b) const {
    Xyz o;
    float L = (float)l * 100.0f / 65535.0f;
    float cby, tmp;
    if (L < 8.856f) {
      o.Y = (L * Y0w) / 903.292f;
      cby = 7.787f * (o.Y / Y0w) + 16.0f / 116.0f;
    } else {
      cby = (L + 16.0f) / 116.0f;
      o.Y = Y0w * cby * cby * cby;
    }
    tmp = (float)a / 256.0f / 500.0f + cby;
    o.X = tmp < 0.2069f ? X0w * (tmp - 0.13793f) / 7.787f : X0w * tmp * tmp * tmp;
    tmp = cby - (float)b / 256.0f / 200.0f;
    o.Z = tmp < 0.2069f ? Z0w * (tmp - 0.13793f) / 7.787f : Z0w * tmp * tmp * tmp;
    return o;
  }
  uint32_t rgb(const Xyz& c) const {
    uint32_t out[3];
    for (int k = 0; k < 3; k++) {
      float Yk = mat[k][0] * c.X + mat[k][1] * c.Y + mat[k][2] * c.Z;
      Yk = std::max(Yk, Y0);
      Yk = std::min(Yk, YC);
      size_t i = (size_t)((Yk - Y0) / step);
      i = std::min((size_t)RANGE, i);
      float t = table[i];
      uint32_t v = (uint32_t)(t > 0 ? (t + 0.5) : (t - 0.5));
      out[k] = std::min(v, 255u);
    }
    return out[0] | out[1] << 8 | out[2] << 16 | 255u << 24;
  }
};

struct Rgba {
  const Dir& d;
  uint16_t bits = 0, spp = 0, photometric = 0;
  int alpha = ALPHA_NONE;
  bool is_contig = true;
  Put put = PUT_NONE;
  uint16_t sub_h = 2, sub_v = 2;
  std::vector<uint8_t> map;          // Map (setupMap)
  std::vector<uint32_t> bw;          // BWmap / PALmap: (1 << bits) entries of 8 / bits pixels
  int per_byte = 1;
  uint8_t cm[3][256] = {};           // 8-bit colormap
  std::vector<uint8_t> ua;           // UaToAa
  std::vector<uint8_t> to8;          // Bitdepth16To8
  YCbCr ycc;
  CieLab lab;

  explicit Rgba(const Dir& d_) : d(d_) {}

  // TIFFRGBAImageOK
  static void ok(const Dir& d) {
    if (!codec_configured(d.compression))
      bad("a compression scheme cv2's libtiff is built without");
    switch (d.bits) {
      case 1: case 2: case 4: case 8: case 16: break;
      default: bad("a bit depth TIFFRGBAImage cannot handle");
    }
    if (d.sampleformat == 3) bad("floating-point samples");
    int colorchannels = d.spp - d.extrasamples;
    switch (d.photometric) {   // present: OpenCV's header check requires it
      case P_MINISWHITE: case P_MINISBLACK: case P_PALETTE:
        if (d.planar == 1 && d.spp != 1 && d.bits < 8) bad("packed samples below 8 bits");
        break;
      case P_YCBCR: break;
      case P_RGB:
        if (colorchannels < 3) bad("RGB with fewer than 3 colour channels");
        break;
      case P_SEPARATED:
        if (d.inkset != 1) bad("a separated image that is not CMYK");
        if (d.spp < 4) bad("a separated image with fewer than 4 samples");
        break;
      case P_LOGL:
        if (d.compression != C_SGILOG) bad("LogL data without SGILog compression");
        break;
      case P_LOGLUV:
        if (d.compression != C_SGILOG && d.compression != C_SGILOG24)
          bad("LogLuv data without SGILog compression");
        if (d.planar != 1) bad("planar LogLuv");
        if (d.spp != 3 || colorchannels != 3) bad("LogLuv with other than 3 samples");
        break;
      case P_CIELAB:
        if (d.spp != 3 || colorchannels != 3 || (d.bits != 8 && d.bits != 16))
          bad("a CIE L*a*b* image TIFFRGBAImage cannot handle");
        break;
      default:
        bad("a photometric interpretation TIFFRGBAImage cannot handle");
    }
  }

  // setupMap / makebwmap
  void setup_map() {
    int64_t range = (1L << bits) - 1;
    if (bits == 16) range = 255;
    map.resize(range + 1);
    for (int64_t x = 0; x <= range; x++)
      map[x] = (uint8_t)(photometric == P_MINISWHITE ? ((range - x) * 255) / range
                                                      : (x * 255) / range);
  }

  void make_bw_map() {
    int b = bits == 16 ? 8 : bits;
    per_byte = 8 / b;
    bw.assign(256 * per_byte, 0);
    for (int i = 0; i < 256; i++)
      for (int k = 0; k < per_byte; k++) {
        int v = b == 8 ? i : (i >> (8 - b * (k + 1))) & ((1 << b) - 1);
        uint8_t c = map[v];
        bw[i * per_byte + k] = pack(c, c, c);
      }
  }

  void make_cmap() {
    per_byte = 8 / bits;
    bw.assign(256 * per_byte, 0);
    for (int i = 0; i < 256; i++)
      for (int k = 0; k < per_byte; k++) {
        int v = bits == 8 ? i : (i >> (8 - bits * (k + 1))) & ((1 << bits) - 1);
        bw[i * per_byte + k] = pack(cm[0][v], cm[1][v], cm[2][v]);
      }
  }

  void ua_map() {
    ua.resize(65536);
    for (int a = 0; a < 256; a++)
      for (int v = 0; v < 256; v++) ua[a << 8 | v] = (uint8_t)((v * a + 127) / 255);
  }

  void to8_map() {
    to8.resize(65536);
    for (uint32_t v = 0; v < 65536; v++) to8[v] = (uint8_t)((v + 128) / 257);
  }

  bool init_ycbcr() {
    const float* luma = d.luma;
    if (std::isnan(luma[0]) || std::isnan(luma[1]) || std::isnan(luma[2]) ||
        std::fabs(luma[1]) < 1e-10f)
      return false;
    float rbw[6];
    if (d.has_refbw) std::memcpy(rbw, d.refbw, sizeof(rbw));
    else {
      rbw[0] = 0.0f;
      rbw[1] = rbw[3] = rbw[5] = 255.0f;
      rbw[2] = rbw[4] = 128.0f;
    }
    for (float v : rbw)
      if (!(v > (float)(-0x7FFFFFFF + 128) && v < (float)0x7FFFFFFF)) return false;
    ycc.init(luma, rbw);
    return true;
  }

  // TIFFRGBAImageBegin, after TIFFRGBAImageOK (whose checks it repeats):
  // the alpha kind and the put routine
  void begin() {
    bits = d.bits;
    spp = d.spp;
    photometric = d.photometric;
    if (d.extrasamples >= 1) {
      switch (d.sampleinfo[0]) {
        case 0: if (spp > 3) alpha = ALPHA_ASSOC; break;   // taken as alpha
        case 1: case 2: alpha = d.sampleinfo[0]; break;
      }
    }
    if (d.extrasamples == 0 && spp == 4 && photometric == P_RGB) alpha = ALPHA_ASSOC;
    is_contig = !(d.planar == 2 && spp > 1);
    if (is_contig) pick_contig();
    else pick_separate();
    if (put == PUT_NONE) bad("TIFFRGBAImage cannot handle this image");
  }

  // buildMap; false where it fails
  bool build_map() {
    switch (photometric) {
      case P_RGB: case P_YCBCR: case P_SEPARATED:
        if (bits == 8) return true;
        [[fallthrough]];
      case P_MINISBLACK: case P_MINISWHITE:
        setup_map();
        if (bits <= 16 && (photometric == P_MINISBLACK || photometric == P_MINISWHITE))
          make_bw_map();
        return true;
      case P_PALETTE: {
        size_t n = (size_t)1 << bits;
        bool is16 = false;
        for (size_t i = 0; i < n; i++)
          if (d.cmap[0][i] >= 256 || d.cmap[1][i] >= 256 || d.cmap[2][i] >= 256) is16 = true;
        if (bits <= 8) {
          for (int c = 0; c < 3; c++)
            for (size_t i = 0; i < n; i++)
              cm[c][i] = (uint8_t)(is16 ? d.cmap[c][i] >> 8 : d.cmap[c][i]);
          make_cmap();
        }
        return true;
      }
    }
    return true;
  }

  void pick_contig() {
    switch (photometric) {
      case P_RGB:
        if (bits == 8) {
          if (alpha == ALPHA_ASSOC && spp >= 4) put = PUT_RGBAA8;
          else if (alpha == ALPHA_UNASS && spp >= 4) { ua_map(); put = PUT_RGBUA8; }
          else if (spp >= 3) put = PUT_RGB8;
        } else if (bits == 16) {
          if (alpha == ALPHA_ASSOC && spp >= 4) { to8_map(); put = PUT_RGBAA16; }
          else if (alpha == ALPHA_UNASS && spp >= 4) { to8_map(); ua_map(); put = PUT_RGBUA16; }
          else if (spp >= 3) { to8_map(); put = PUT_RGB16; }
        }
        break;
      case P_SEPARATED:
        if (spp >= 4 && build_map() && bits == 8) put = PUT_CMYK8;
        break;
      case P_PALETTE:
        if (build_map()) {
          switch (bits) {
            case 8: put = PUT_CMAP8; break;
            case 4: put = PUT_CMAP4; break;
            case 2: put = PUT_CMAP2; break;
            case 1: put = PUT_CMAP1; break;
          }
        }
        break;
      case P_MINISWHITE: case P_MINISBLACK:
        if (build_map()) {
          switch (bits) {
            case 16: put = PUT_BW16; break;
            case 8: put = (alpha && spp == 2) ? PUT_AGREY8 : PUT_GREY8; break;
            case 4: put = PUT_BW4; break;
            case 2: put = PUT_BW2; break;
            case 1: put = PUT_BW1; break;
          }
        }
        break;
      case P_YCBCR:
        if (bits == 8 && spp == 3 && init_ycbcr()) {
          sub_h = d.ycbcrsub[0];
          sub_v = d.ycbcrsub[1];
          switch (sub_h << 4 | sub_v) {
            case 0x44: case 0x42: case 0x41: case 0x22: case 0x21: case 0x12: case 0x11:
              put = PUT_YCBCR;
          }
        }
        break;
      case P_CIELAB:
        if (spp == 3 && build_map() && (bits == 8 || bits == 16) && d.whitepoint[1] != 0.0f) {
          lab.init(d.whitepoint);
          put = PUT_CIELAB;
        }
        break;
    }
  }

  void pick_separate() {
    switch (photometric) {
      case P_MINISWHITE: case P_MINISBLACK: case P_RGB:
        if (bits == 8) {
          if (alpha == ALPHA_ASSOC) put = PUT_SEP_RGBAA8;
          else if (alpha == ALPHA_UNASS) { ua_map(); put = PUT_SEP_RGBUA8; }
          else put = PUT_SEP_RGB8;
        } else if (bits == 16) {
          to8_map();
          if (alpha == ALPHA_ASSOC) put = PUT_SEP_RGBAA16;
          else if (alpha == ALPHA_UNASS) { ua_map(); put = PUT_SEP_RGBUA16; }
          else put = PUT_SEP_RGB16;
        }
        break;
      case P_SEPARATED:
        if (bits == 8 && spp == 4) {
          alpha = 1;   // the fourth plane rides in the alpha slot
          put = PUT_SEP_CMYK8;
        }
        break;
      case P_YCBCR:
        if (bits == 8 && spp == 3 && init_ycbcr() && d.ycbcrsub[0] == 1 && d.ycbcrsub[1] == 1)
          put = PUT_SEP_YCBCR11;
        break;
    }
  }

  // ---- the put routines: cp indexes the raster, pp points into the buffer
  //      (w pixels a row, cp += toskew and pp += fromskew between rows)

  void contig(uint32_t* cp, uint32_t w, uint32_t h, int32_t fromskew, int32_t toskew,
              const uint8_t* pp) const {
    const int S = spp;
    switch (put) {
      case PUT_BW1: case PUT_BW2: case PUT_BW4: case PUT_CMAP1: case PUT_CMAP2: case PUT_CMAP4: {
        int ppb = per_byte;
        fromskew /= ppb;
        for (; h > 0; --h) {
          for (uint32_t x = w; x > 0;) {
            const uint32_t* e = &bw[(size_t)*pp++ * ppb];
            uint32_t k = x >= (uint32_t)ppb ? ppb : x;
            for (uint32_t j = 0; j < k; j++) *cp++ = e[j];
            x -= k;
          }
          cp += toskew;
          pp += fromskew;
        }
        return;
      }
      case PUT_GREY8: case PUT_CMAP8:
        for (; h > 0; --h) {
          for (uint32_t x = w; x > 0; --x) {
            *cp++ = bw[*pp];
            pp += S;
          }
          cp += toskew;
          pp += fromskew;
        }
        return;
      case PUT_AGREY8:
        for (; h > 0; --h) {
          for (uint32_t x = w; x > 0; --x) {
            *cp++ = bw[*pp] & ((uint32_t)pp[1] << 24 | 0x00FFFFFFu);
            pp += S;
          }
          cp += toskew;
          pp += fromskew;
        }
        return;
      case PUT_BW16:
        for (; h > 0; --h) {
          const uint8_t* wp = pp;
          for (uint32_t x = w; x > 0; --x) {
            uint16_t v;
            std::memcpy(&v, wp, 2);
            *cp++ = bw[v >> 8];
            pp += 2 * S;
            wp += 2 * S;
          }
          cp += toskew;
          pp += fromskew;
        }
        return;
      case PUT_RGB8: case PUT_RGBAA8: case PUT_RGBUA8: case PUT_CMYK8:
        fromskew *= S;
        for (; h > 0; --h) {
          for (uint32_t x = w; x > 0; --x) {
            if (put == PUT_RGB8) *cp++ = pack(pp[0], pp[1], pp[2]);
            else if (put == PUT_RGBAA8) *cp++ = pack(pp[0], pp[1], pp[2], pp[3]);
            else if (put == PUT_RGBUA8) {
              const uint8_t* m = &ua[(size_t)pp[3] << 8];
              *cp++ = pack(m[pp[0]], m[pp[1]], m[pp[2]], pp[3]);
            } else {
              uint32_t k = 255 - pp[3];
              *cp++ = pack((k * (255 - pp[0])) / 255, (k * (255 - pp[1])) / 255,
                           (k * (255 - pp[2])) / 255);
            }
            pp += S;
          }
          cp += toskew;
          pp += fromskew;
        }
        return;
      case PUT_RGB16: case PUT_RGBAA16: case PUT_RGBUA16: {
        fromskew *= S;
        const uint8_t* wp = pp;
        auto at = [&](int k) {
          uint16_t v;
          std::memcpy(&v, wp + 2 * k, 2);
          return to8[v];
        };
        for (; h > 0; --h) {
          for (uint32_t x = w; x > 0; --x) {
            if (put == PUT_RGB16) *cp++ = pack(at(0), at(1), at(2));
            else if (put == PUT_RGBAA16) *cp++ = pack(at(0), at(1), at(2), at(3));
            else {
              uint32_t a = at(3);
              const uint8_t* m = &ua[(size_t)a << 8];
              *cp++ = pack(m[at(0)], m[at(1)], m[at(2)], a);
            }
            wp += 2 * S;
          }
          cp += toskew;
          wp += 2 * (int64_t)fromskew;
        }
        return;
      }
      case PUT_YCBCR:
        ycbcr_contig(cp, w, h, fromskew, toskew, pp);
        return;
      case PUT_CIELAB:
        fromskew *= 3;
        for (; h > 0; --h) {
          for (uint32_t x = w; x > 0; --x) {
            if (bits == 8) {
              *cp++ = lab.rgb(lab.xyz(pp[0] * 257u, (int8_t)pp[1] * 256, (int8_t)pp[2] * 256));
              pp += 3;
            } else {
              uint16_t v[3];
              std::memcpy(v, pp, 6);
              *cp++ = lab.rgb(lab.xyz(v[0], (int16_t)v[1], (int16_t)v[2]));
              pp += 6;
            }
          }
          cp += toskew;
          pp += (int64_t)fromskew * (bits / 8);
        }
        return;
      default:
        return;
    }
  }

  // the subsampled YCbCr routines: each pixel of a block its own Y, the
  // block's Cb and Cr; partial blocks at the right and bottom edges
  void ycbcr_contig(uint32_t* cp, uint32_t w, uint32_t h, int32_t fromskew, int32_t toskew,
                    const uint8_t* pp) const {
    const int sh = sub_h, sv = sub_v, unit = sh * sv + 2;
    // putcontig8bitYCbCr44tile skips 4:2 units (4 * 2 + 2) per clipped block
    fromskew = (fromskew / sh) * (sh == 4 && sv == 4 ? 10 : unit);
    int32_t stride = (int32_t)w + toskew;   // raster step from one row to the next
    for (uint32_t r = 0; r < h; r += sv) {
      uint32_t rows = std::min<uint32_t>(sv, h - r);
      uint32_t* row0 = cp;
      for (uint32_t c = 0; c < w; c += sh) {
        uint32_t cols = std::min<uint32_t>(sh, w - c);
        int32_t Cb = pp[sh * sv], Cr = pp[sh * sv + 1];
        for (uint32_t i = 0; i < rows; i++)
          for (uint32_t j = 0; j < cols; j++)
            row0[(int64_t)i * stride + c + j] = ycc.rgb(pp[i * sh + j], Cb, Cr);
        pp += unit;
      }
      cp += (int64_t)sv * stride;
      pp += fromskew;
    }
  }

  void separate(uint32_t* cp, uint32_t w, uint32_t h, int32_t fromskew, int32_t toskew,
                const uint8_t* r, const uint8_t* g, const uint8_t* b, const uint8_t* a) const {
    bool deep = put == PUT_SEP_RGB16 || put == PUT_SEP_RGBAA16 || put == PUT_SEP_RGBUA16;
    int k = deep ? 2 : 1;
    auto v8 = [&](const uint8_t* p) -> uint32_t {
      if (!deep) return *p;
      uint16_t v;
      std::memcpy(&v, p, 2);
      return to8[v];
    };
    for (; h > 0; --h) {
      for (uint32_t x = w; x > 0; --x) {
        switch (put) {
          case PUT_SEP_RGB8: case PUT_SEP_RGB16: *cp++ = pack(v8(r), v8(g), v8(b)); break;
          case PUT_SEP_RGBAA8: case PUT_SEP_RGBAA16:
            *cp++ = pack(v8(r), v8(g), v8(b), v8(a));
            break;
          case PUT_SEP_RGBUA8: case PUT_SEP_RGBUA16: {
            uint32_t av = v8(a);
            const uint8_t* m = &ua[(size_t)av << 8];
            *cp++ = pack(m[v8(r)], m[v8(g)], m[v8(b)], av);
            break;
          }
          case PUT_SEP_CMYK8: {
            uint32_t kv = 255 - *a;
            *cp++ = pack((kv * (255 - *r)) / 255, (kv * (255 - *g)) / 255, (kv * (255 - *b)) / 255);
            break;
          }
          case PUT_SEP_YCBCR11:
            *cp++ = ycc.rgb(*r, *g, *b);
            break;
          default:
            break;
        }
        r += k;
        g += k;
        b += k;
        if (a) a += k;
      }
      r += (int64_t)fromskew * k;
      g += (int64_t)fromskew * k;
      b += (int64_t)fromskew * k;
      if (a) a += (int64_t)fromskew * k;
      cp += toskew;
    }
  }
};

enum { FLIP_V = 1, FLIP_H = 2 };

// setorientation with the requested orientation BOTLEFT
int flips(uint16_t o) {
  switch (o) {
    case 1: case 5: return FLIP_V;
    case 2: case 6: return FLIP_V | FLIP_H;
    case 3: case 7: return FLIP_H;
  }
  return 0;
}

void flip_rows(uint32_t* raster, uint32_t w, uint32_t h) {
  for (uint32_t line = 0; line < h; line++)
    std::reverse(raster + (size_t)line * w, raster + (size_t)line * w + w);
}

// TIFFReadRGBAStrip(row): the strip's rows into raster (w x rows, bottom-up
// for the usual orientation). false where it fails (no image).
bool rgba_strip(Reader& rd, const Rgba& im, uint32_t row, std::vector<uint32_t>& raster) {
  const Dir& d = rd.d;
  uint32_t rps = d.rowsperstrip;
  if (rps == 0 || row % rps != 0 || row >= d.length) return false;
  uint32_t h = row + rps > d.length ? d.length - row : rps;
  if (rps == 0xFFFFFFFFu) h = d.length - row;
  uint32_t w = d.width;
  raster.assign((size_t)w * h, 0);
  int flip = flips(d.orientation);
  uint32_t y = (flip & FLIP_V) ? h - 1 : 0;
  int32_t toskew = (flip & FLIP_V) ? -(int32_t)(w + w) : 0;
  uint64_t scanline = scanline_size(d);
  uint64_t maxstripsize = strip_size(d);
  uint32_t strip = row / rps;   // TIFFComputeStrip
  uint16_t sv = d.ycbcrsub[1];
  if (im.is_contig) {
    if (sv == 0) return false;
    uint32_t nrowsub = h;
    if (nrowsub % sv) nrowsub += sv - nrowsub % sv;
    uint64_t temp = nrowsub;   // (row + row_offset) % rowsperstrip is 0
    // TIFFReadEncodedStripGetStripSize
    uint32_t crps = std::min(d.rowsperstrip, d.length);
    uint32_t per_plane = d.length / crps + (d.length % crps != 0);
    uint32_t in_plane = strip % per_plane;
    uint32_t rows = d.length - in_plane * crps;
    if (rows > crps) rows = crps;
    int64_t this_size = (int64_t)vstrip_size(d, rows);
    if (this_size == 0) return false;
    int64_t want = (int64_t)(temp * scanline);
    if (want < this_size) this_size = want;
    std::vector<uint8_t> buf;
    if (!rd.read_first(strip, buf, maxstripsize, this_size, false)) return false;
    im.contig(raster.data() + (size_t)y * w, w, h, 0, toskew, buf.data());
  } else {
    int colorchannels = (im.photometric == P_MINISWHITE || im.photometric == P_MINISBLACK ||
                         im.photometric == P_PALETTE) ? 1 : 3;
    uint64_t ss = maxstripsize;
    uint64_t bufsize = (im.alpha ? 4 : 3) * ss;
    int64_t size = (int64_t)(h * scanline);
    uint32_t crps = std::min(d.rowsperstrip, d.length);
    uint32_t rows = std::min<uint32_t>(crps, d.length - row);
    int64_t plane_size = std::min<int64_t>(size, (int64_t)vstrip_size(d, rows));
    std::vector<uint8_t> buf;
    if (!rd.read_first(strip, buf, bufsize, plane_size, false)) return false;
    uint8_t* p0 = buf.data();
    uint8_t *p1, *p2, *pa;
    if (colorchannels == 1) {
      p1 = p2 = p0;
      pa = im.alpha ? p0 + 3 * ss : nullptr;
    } else {
      p1 = p0 + ss;
      p2 = p1 + ss;
      pa = im.alpha ? p2 + ss : nullptr;
    }
    uint32_t per_image = d.stripsperimage;
    if (colorchannels > 1) {
      rd.read_more(strip + per_image, p1, plane_size, false);
      rd.read_more(strip + 2 * per_image, p2, plane_size, false);
    }
    if (im.alpha) rd.read_more(strip + colorchannels * per_image, pa, plane_size, false);
    im.separate(raster.data() + (size_t)y * w, w, h, 0, toskew, p0, p1, p2, pa);
  }
  if (flip & FLIP_H) flip_rows(raster.data(), w, h);
  return true;
}

// TIFFReadRGBATile(col, row): a full tile raster (tw x th, bottom-up, the
// image's part in the bottom rows and left columns). false: no image.
bool rgba_tile(Reader& rd, const Rgba& im, uint32_t col, uint32_t row,
               std::vector<uint32_t>& raster) {
  const Dir& d = rd.d;
  uint32_t tw = d.tilewidth, th = d.tilelength;
  if (tw == 0 || th == 0 || col % tw || row % th) return false;
  uint32_t rh = row + th > d.length ? d.length - row : th;
  uint32_t rw = col + tw > d.width ? d.width - col : tw;
  raster.assign((size_t)tw * th, 0);
  // gtTileContig / gtTileSeparate for one tile: w = rw, h = rh
  uint32_t w = rw, h = rh;
  int flip = flips(d.orientation);
  uint32_t y = (flip & FLIP_V) ? h - 1 : 0;
  int32_t toskew = (flip & FLIP_V) ? -(int32_t)(tw + w) : -(int32_t)(tw - w);
  int32_t fromskew = 0, this_toskew = toskew;
  uint32_t this_tw = tw;
  if (this_tw > w) {   // the rightmost tile, clipped
    fromskew = tw - w;
    this_tw = w;
    this_toskew = toskew + fromskew;
  }
  uint64_t tsize = tile_size(d);
  // TIFFCheckTile and TIFFComputeTile (z = 0)
  if (col >= d.width || row >= d.length || d.depth == 0) return false;
  uint32_t dz = d.tiledepth == 0xFFFFFFFFu ? d.depth : d.tiledepth;
  uint32_t xpt = howmany32(d.width, tw), ypt = howmany32(d.length, th);
  uint32_t zpt = dz ? howmany32(d.depth, dz) : 0;
  uint32_t tile = xpt * (row / th) + col / tw;
  std::vector<uint32_t> part((size_t)w * h, 0);
  uint32_t* cp = part.data() + (size_t)y * w;
  if (im.is_contig) {
    std::vector<uint8_t> buf;
    if (!rd.read_first(tile, buf, tsize, (int64_t)tsize, true)) return false;
    im.contig(cp, this_tw, h, fromskew, this_toskew, buf.data());
  } else {
    int colorchannels = (im.photometric == P_MINISWHITE || im.photometric == P_MINISBLACK ||
                         im.photometric == P_PALETTE) ? 1 : 3;
    uint64_t bufsize = (im.alpha ? 4 : 3) * tsize;
    std::vector<uint8_t> buf;
    if (!rd.read_first(tile, buf, bufsize, (int64_t)tsize, true)) return false;
    uint8_t* p0 = buf.data();
    uint8_t *p1, *p2, *pa;
    if (colorchannels == 1) {
      p1 = p2 = p0;
      pa = im.alpha ? p0 + 3 * tsize : nullptr;
    } else {
      p1 = p0 + tsize;
      p2 = p1 + tsize;
      pa = im.alpha ? p2 + tsize : nullptr;
    }
    uint32_t plane = xpt * ypt * zpt;
    if (colorchannels > 1) {
      rd.read_more(tile + plane, p1, (int64_t)tsize, true);
      rd.read_more(tile + 2 * plane, p2, (int64_t)tsize, true);
    }
    if (im.alpha) rd.read_more(tile + colorchannels * plane, pa, (int64_t)tsize, true);
    im.separate(cp, this_tw, h, fromskew, this_toskew, p0, p1, p2, pa);
  }
  if (flip & FLIP_H) flip_rows(part.data(), w, h);
  // the fix-up to a full tile: row i of the part goes to tile row th - 1 - (h - 1 - i)
  for (uint32_t i = 0; i < h; i++)
    std::memcpy(raster.data() + (size_t)(th - h + i) * tw, part.data() + (size_t)i * w,
                (size_t)w * 4);
  return true;
}

struct Parsed {
  File f;
  Dir d;
};

Parsed parse(const uint8_t* data, long n) {
  Parsed p{File{data, (uint64_t)n}, Dir{}};
  File f0 = p.f;
  p.d = read_directory(f0, p.f);
  opencv_header(p.d);
  return p;
}

// the setup checks of the codecs cv2 reads and the port does not
// the checks libtiff makes before such a codec decodes the first strip or
// tile: the chunk is read (TIFFFillStrip), the codec set up (bit depths),
// and libjpeg finds its SOI marker
void queued(const File& f, const Dir& d) {
  uint16_t c = d.compression;
  Reader rd(f, d);
  int64_t cc;
  const uint8_t* raw = rd.fill(0, cc, d.tiled);
  if (!raw) bad("a strip that cannot be read");
  if ((c == C_FAX3 || c == C_FAX4 || c == C_CCITTRLE || c == C_CCITTRLEW) && d.bits != 1)
    bad("CCITT coding of samples other than 1-bit");
  if (c == C_JPEG && !(cc >= 2 && raw[0] == 0xFF && raw[1] == 0xD8)) bad("not a JPEG stream");
  if (c == C_THUNDER && d.bits != 4) bad("ThunderScan coding of samples other than 4-bit");
  if (c == C_NEXT) bad("NeXT codes 2-bit samples only, which OpenCV refuses");
  if ((c == C_SGILOG || c == C_SGILOG24) && d.photometric != P_LOGL && d.photometric != P_LOGLUV)
    bad("SGILog coding of other than LogL / LogLuv data");
  fail(QUEUED, std::string("a TIFF file coded with ") + codec_name(c) +
                   ": the port does not read this codec yet (ROADMAP.md queues it)");
}

void decode(const uint8_t* data, long n, bool color, uint8_t* out) {
  Parsed p = parse(data, n);
  const Dir& d = p.d;
  // OpenCV's readData for an 8-bit read
  uint32_t tw0 = d.width, th0 = 0;
  if (d.tiled) {
    tw0 = d.tilewidth;
    th0 = d.tilelength;
  } else if (d.has_rowsperstrip) {
    th0 = d.rowsperstrip;
  }
  if (tw0 == 0) tw0 = d.width;
  if (th0 == 0 || (!d.tiled && th0 == 0xFFFFFFFFu)) th0 = d.length;
  if (!((int)tw0 > 0 && (int)tw0 <= (1 << 24))) bad("tile width OpenCV refuses");
  if (!((int)th0 > 0 && (int)th0 <= (1 << 24))) bad("tile height OpenCV refuses");
  uint32_t ncn = opencv_channels(d);
  if (d.bits > 64) bad("bit depth over 64 (OpenCV refuses)");
  if (!((uint64_t)tw0 * th0 * ncn * std::max(1, d.bits / 8) < (1ull << 30)))
    bad("a tile of 1 GB or more (OpenCV refuses)");
  Rgba::ok(d);
  if (codec_queued(d.compression)) queued(p.f, d);
  Rgba im(d);
  im.begin();
  Reader rd(p.f, d);
  const int H = (int)d.length, W = (int)d.width;
  uint16_t o = d.has_orientation ? d.orientation : 1;
  bool vert_flip = o == 3 || o == 7 || o == 4 || o == 8;
  if (o >= 5 && H != W) bad("an orientation cv2.imread can apply only to a square image");
  std::vector<uint32_t> raster;
  const int nch = color ? 3 : 1;
  for (int y = 0; y < H; y += (int)th0) {
    int tile_h = std::min((int)th0, H - y);
    int img_y = vert_flip ? H - y - tile_h : y;
    for (int x = 0; x < W; x += (int)tw0) {
      int tile_w = std::min((int)tw0, W - x);
      const uint32_t* bstart;
      if (!d.tiled) {
        if (!rgba_strip(rd, im, (uint32_t)y, raster)) bad("a strip that cannot be read");
        bstart = raster.data();
      } else {
        if (!rgba_tile(rd, im, (uint32_t)x, (uint32_t)y, raster)) bad("a tile that cannot be read");
        bstart = raster.data() + (size_t)(th0 - tile_h) * tw0;
      }
      for (int i = 0; i < tile_h; i++) {
        const uint32_t* src = bstart + (size_t)i * tw0;
        uint8_t* dst = out + ((size_t)(img_y + tile_h - i - 1) * W + x) * nch;
        for (int k = 0; k < tile_w; k++) {
          uint32_t v = src[k];
          int r = v & 255, g = v >> 8 & 255, b = v >> 16 & 255;
          if (color) {
            dst[3 * k] = (uint8_t)r;
            dst[3 * k + 1] = (uint8_t)g;
            dst[3 * k + 2] = (uint8_t)b;
          } else {
            dst[k] = gray(b, g, r);
          }
        }
      }
    }
  }
  if (o >= 5) {
    // transposed in place: 5 and 7 as they are, 6 and 8 turned by 180 degrees too
    std::vector<uint8_t> tmp(out, out + (size_t)H * W * nch);
    bool turn = o == 6 || o == 8;
    for (int i = 0; i < H; i++)
      for (int j = 0; j < W; j++) {
        int si = turn ? W - 1 - j : j, sj = turn ? H - 1 - i : i;
        std::memcpy(out + ((size_t)i * W + j) * nch, tmp.data() + ((size_t)si * W + sj) * nch,
                    nch);
      }
  }
}

}  // namespace

extern "C" {

int pv_tiff_info(const uint8_t* data, long n, int color, int* h, int* w, char* err, int errlen) {
  (void)color;
  return guarded([&] {
    Parsed p = parse(data, n);
    *h = (int)p.d.length;
    *w = (int)p.d.width;
  }, err, errlen);
}

int pv_tiff_decode(const uint8_t* data, long n, int color, uint8_t* out, char* err, int errlen) {
  return guarded([&] { decode(data, n, color != 0, out); }, err, errlen);
}

}  // extern "C"
