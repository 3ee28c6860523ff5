// The part of the JPEG decoder (jpeg.cpp) that the TIFF decoder (tiff.cpp)
// decodes JPEG-coded strips and tiles with, as libtiff's tif_jpeg.c drives
// libjpeg: one decompressor for all the strips or tiles of an image, whose
// quantisation and Huffman tables persist from the JPEGTables stream and
// from one strip to the next (a table a stream defines replaces the slot's;
// libjpeg's standard Huffman tables fill the slots that no stream defined
// by the first scan). Errors are thrown as imgc::Error.

#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>

namespace pvjpeg {

// What jpeg_read_header gives of an abbreviated image stream: the frame
struct Frame {
  int width = 0, height = 0, components = 0, precision = 0;
  int h[4] = {}, v[4] = {};   // sampling factors of each component
};

class Session {
 public:
  Session();
  ~Session();
  // jpeg_read_header(FALSE) of the JPEGTables stream: false where it is
  // not a table-specification stream (libtiff: "Bogus JPEGTables field")
  bool tables(const uint8_t* data, size_t n);
  // jpeg_read_header(TRUE) of one strip or tile (the bytes must outlive
  // start and rows)
  Frame header(const uint8_t* data, size_t n);
  // jpeg_start_decompress with libtiff's colour request: YCbCr to RGB
  // (ycc), else the null conversion of JCS_UNKNOWN
  void start(bool ycc);
  // jpeg_read_scanlines of the first `rows` rows: row r, width *
  // (ycc ? 3 : components) bytes, at out + r * stride
  void rows(uint8_t* out, size_t stride, int rows);

 private:
  struct State;
  std::unique_ptr<State> s_;
};

}  // namespace pvjpeg
