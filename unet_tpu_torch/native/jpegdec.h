// Baseline + progressive JPEG decoder — native twin of
// unet_tpu_torch/geo/jpeg.py. See jpegdec.cpp for semantics; tiffdec.cpp uses
// it for compression-7 segments so JPEG-in-TIFF rides the multithreaded
// batch decode path.
#pragma once

#include <cstdint>

namespace unet_native {

// Scan `data` for the SOF0/SOF1/SOF2 frame header. Returns 0 and fills
// h/w/c on success, <0 on failure (no frame, or an arithmetic/lossless SOF).
int jpeg_dims_impl(const uint8_t* data, long long n, int* h, int* w, int* c);

// Decode a baseline-sequential or progressive Huffman JPEG stream into
// interleaved uint8 HWC `dst` (capacity `cap` bytes). `tables` is an
// optional abbreviated-tables stream (TIFF JPEGTables tag 347) parsed
// first; the segment's own DQT/DHT/DRI override. `color_transform`:
// 1 = YCbCr→RGB for 3-component images, 0 = raw planes, -1 = auto
// (convert unless component ids spell 'R','G','B'). On success fills
// out_h/out_w/out_c and returns 0.
// Errors: -1 corrupt/unsupported-layout, -2 unsupported coding
// (arithmetic/lossless/12-bit), -3 dst too small.
int jpeg_decode_impl(const uint8_t* data, long long n, const uint8_t* tables,
                     long long tn, uint8_t* dst, long long cap, int* out_h,
                     int* out_w, int* out_c, int color_transform);

// Like jpeg_dims_impl but also reports `precision` (bits/sample) and
// `mode`: 0 = baseline/progressive DCT, 2 = lossless (SOF3). Arithmetic
// and differential frames still return -2.
int jpeg_info_impl(const uint8_t* data, long long n, int* h, int* w, int* c,
                   int* precision, int* mode);

// Decode a lossless (SOF3) Huffman JPEG stream into interleaved uint16
// HWC `dst` (capacity `cap` VALUES). Native twin of geo/jpeg.py's
// Annex-H path: same predictor / scan-start / restart rules, bit-exact.
// Fills out_precision so callers can downcast <=8-bit frames.
int jpeg_decode16_impl(const uint8_t* data, long long n,
                       const uint8_t* tables, long long tn, uint16_t* dst,
                       long long cap, int* out_h, int* out_w, int* out_c,
                       int* out_precision);

}  // namespace unet_native
