// Native raster codec: multithreaded TIFF → batch assembly plus fast
// LZW/PackBits primitives for the Python codec.
//
// The PyTorch port's copy of unet_tpu/native/tiffdec.cpp (ABI v4), changed
// only where it reaches zlib: it declares zlib's one function it calls,
// uncompress, itself and links the runtime library libz.so.1, so it builds
// on a machine without zlib's headers or the libz.so development link.
//
// The reference's performance-critical raster decode lives in native code
// (libgdal/libtiff C++ under rasterio). This is its counterpart for the
// training/prediction hot path: decode a whole batch of equally-sized
// tiles in worker threads, writing directly into the caller's
// pre-allocated NHWC batch buffer, bypassing the Python GIL entirely.
//
// Supported TIFF subset (matches unet_tpu_torch.geo.tiff, the Python codec):
//   classic TIFF and BigTIFF, little- and big-endian,
//   strip- and tile-organized, PlanarConfiguration 1|2,
//   Compression 1 (none) | 5 (LZW) | 7 (new-style baseline JPEG, via
//   jpegdec.cpp) | 8/32946 (deflate) | 32773 (PackBits),
//   Predictor 1|2|3, uint8..int32/float32/float64 samples.
//
// C ABI (ctypes):
//   int unet_decode_batch(const char** paths, int n_tiles,
//                         float* out, long long tile_stride,
//                         int height, int width, int channels,
//                         int n_threads);
//   int unet_decode_masks(const char** paths, int n_tiles,
//                         int* out, long long tile_stride,
//                         int height, int width, int n_threads);
//   long long unet_lzw_decode(const uint8_t* src, long long n,
//                             uint8_t* dst, long long cap);
//   long long unet_lzw_encode(const uint8_t* src, long long n,
//                             uint8_t* dst, long long cap);
//   long long unet_packbits_decode(const uint8_t* src, long long n,
//                                  uint8_t* dst, long long cap);
//   long long unet_packbits_encode(const uint8_t* src, long long n,
//                                  uint8_t* dst, long long cap);
// Batch return: 0 on success, (tile_index + 1) on the first failing tile.
// Codec return: output length, or -1 on failure/overflow.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

// zlib's uncompress (zlib.h: Bytef*, uLongf*, const Bytef*, uLong; Z_OK = 0)
extern "C" int uncompress(unsigned char* dest, unsigned long* dest_len,
                          const unsigned char* source, unsigned long source_len);

#include "jpegdec.h"

namespace {

// ---------------------------------------------------------------- LZW ----
// TIFF LZW: MSB-first bit packing, ClearCode 256, EOI 257, "early change"
// width switching. Semantics cross-validated against libtiff via the
// Python codec's PIL round-trip tests (tests/test_tiff.py).

constexpr int kLzwClear = 256;
constexpr int kLzwEoi = 257;
constexpr int kLzwFirst = 258;
constexpr int kLzwMax = 4096;

long long lzw_decode_impl(const uint8_t* src, long long n, uint8_t* dst,
                          long long cap) {
  static thread_local std::vector<uint16_t> prefix(kLzwMax);
  static thread_local std::vector<uint8_t> suffix(kLzwMax), firstb(kLzwMax);
  static thread_local std::vector<uint32_t> length(kLzwMax);
  for (int i = 0; i < 256; i++) {
    prefix[i] = 0xFFFF;
    suffix[i] = (uint8_t)i;
    firstb[i] = (uint8_t)i;
    length[i] = 1;
  }
  int width = 9, next = kLzwFirst, prev = -1;
  uint32_t acc = 0;
  int accbits = 0;
  long long pos = 0, outp = 0;

  auto emit = [&](int code) -> bool {
    uint32_t l = length[code];
    if (outp + (long long)l > cap) return false;
    long long end = outp + l;
    int c = code;
    for (long long k = end; k-- > outp;) {
      dst[k] = suffix[c];
      c = prefix[c];
    }
    outp = end;
    return true;
  };

  while (true) {
    while (accbits < width) {
      if (pos >= n) return outp;  // missing EOI is tolerated (libtiff does)
      acc = (acc << 8) | src[pos++];
      accbits += 8;
    }
    accbits -= width;
    int code = (acc >> accbits) & ((1 << width) - 1);
    acc &= (1u << accbits) - 1;
    if (code == kLzwClear) {
      width = 9;
      next = kLzwFirst;
      prev = -1;
      continue;
    }
    if (code == kLzwEoi) return outp;
    if (prev < 0) {
      if (code >= 256) return -1;
      if (!emit(code)) return -1;
    } else {
      if (code > next || next >= kLzwMax) return -1;
      int seed = (code == next) ? prev : code;
      prefix[next] = (uint16_t)prev;
      suffix[next] = firstb[seed];
      firstb[next] = firstb[prev];
      length[next] = length[prev] + 1;
      next++;
      if (!emit(code)) return -1;
      // early change: the NEXT code is read wider once the table holds
      // (1<<width)-1 entries
      if (next >= (1 << width) - 1 && width < 12) width++;
    }
    prev = code;
  }
}

long long lzw_encode_impl(const uint8_t* src, long long n, uint8_t* dst,
                          long long cap) {
  // (prefix_code, byte) → code map as an epoch-stamped direct table:
  // no per-Clear memset.
  struct Slot {
    uint32_t epoch;
    uint16_t code;
  };
  static thread_local std::vector<Slot> table;
  static thread_local uint32_t epoch = 0;
  if (table.empty()) table.assign((size_t)kLzwMax * 256, Slot{0, 0});
  epoch++;

  uint32_t acc = 0;
  int accbits = 0;
  long long outp = 0;
  auto emit = [&](int code, int width) -> bool {
    acc = (acc << width) | (uint32_t)code;
    accbits += width;
    while (accbits >= 8) {
      accbits -= 8;
      if (outp >= cap) return false;
      dst[outp++] = (uint8_t)((acc >> accbits) & 0xFF);
    }
    acc &= (1u << accbits) - 1;
    return true;
  };

  int width = 9, next = kLzwFirst;
  if (!emit(kLzwClear, width)) return -1;
  if (n == 0) {
    if (!emit(kLzwEoi, width)) return -1;
    if (accbits && outp < cap) dst[outp++] = (uint8_t)((acc << (8 - accbits)) & 0xFF);
    else if (accbits) return -1;
    return outp;
  }
  int w = src[0];
  for (long long i = 1; i < n; i++) {
    uint8_t b = src[i];
    size_t key = (size_t)w * 256 + b;
    if (table[key].epoch == epoch) {
      w = table[key].code;
      continue;
    }
    if (!emit(w, width)) return -1;
    table[key] = Slot{epoch, (uint16_t)next};
    next++;
    // mirror of the decoder's early change (encoder table leads by one)
    if (next >= kLzwMax - 2) {
      if (!emit(kLzwClear, width)) return -1;
      epoch++;
      next = kLzwFirst;
      width = 9;
    } else if (next == (1 << width)) {
      width++;
    }
    w = b;
  }
  if (!emit(w, width)) return -1;
  if (!emit(kLzwEoi, width)) return -1;
  if (accbits) {
    if (outp >= cap) return -1;
    dst[outp++] = (uint8_t)((acc << (8 - accbits)) & 0xFF);
  }
  return outp;
}

// ----------------------------------------------------------- PackBits ----

long long packbits_decode_impl(const uint8_t* src, long long n, uint8_t* dst,
                               long long cap) {
  long long i = 0, outp = 0;
  while (i < n) {
    uint8_t h = src[i++];
    if (h < 128) {
      long long len = h + 1;
      if (i + len > n || outp + len > cap) return -1;
      std::memcpy(dst + outp, src + i, (size_t)len);
      i += len;
      outp += len;
    } else if (h > 128) {
      long long len = 257 - h;
      if (i >= n || outp + len > cap) return -1;
      std::memset(dst + outp, src[i++], (size_t)len);
      outp += len;
    }  // 128: no-op
  }
  return outp;
}

long long packbits_encode_impl(const uint8_t* src, long long n, uint8_t* dst,
                               long long cap) {
  long long i = 0, outp = 0;
  while (i < n) {
    long long j = i;
    while (j < n - 1 && src[j] == src[j + 1] && j - i < 127) j++;
    if (j > i) {
      if (outp + 2 > cap) return -1;
      dst[outp++] = (uint8_t)(257 - (j - i + 1));
      dst[outp++] = src[i];
      i = j + 1;
      continue;
    }
    j = i;
    while (j < n && j - i < 128) {
      if (j < n - 2 && src[j] == src[j + 1] && src[j + 1] == src[j + 2]) break;
      j++;
    }
    if (outp + 1 + (j - i) > cap) return -1;
    dst[outp++] = (uint8_t)(j - i - 1);
    std::memcpy(dst + outp, src + i, (size_t)(j - i));
    outp += j - i;
    i = j;
  }
  return outp;
}

// ------------------------------------------------------------- parser ----

struct Ifd {
  uint32_t width = 0, height = 0;
  uint16_t samples = 1, bits = 8, sample_format = 1;
  uint16_t compression = 1, planar = 1, predictor = 1;
  uint16_t photometric = 1;
  uint32_t rows_per_strip = 0;
  bool tiled = false;
  uint32_t tile_w = 0, tile_h = 0;
  bool bigendian = false;
  // JPEGTables tag 347 (abbreviated-tables stream shared by all segments)
  uint64_t jpegtables_off = 0, jpegtables_len = 0;
  std::vector<uint64_t> seg_offsets, seg_counts;
};

struct Reader {
  const uint8_t* d;
  size_t n;
  bool be;
  uint16_t r16(size_t off) const {
    if (off + 2 > n) return 0;
    return be ? (uint16_t)((d[off] << 8) | d[off + 1])
              : (uint16_t)(d[off] | (d[off + 1] << 8));
  }
  uint32_t r32(size_t off) const {
    if (off + 4 > n) return 0;
    return be ? ((uint32_t)d[off] << 24) | ((uint32_t)d[off + 1] << 16) |
                    ((uint32_t)d[off + 2] << 8) | d[off + 3]
              : (uint32_t)d[off] | ((uint32_t)d[off + 1] << 8) |
                    ((uint32_t)d[off + 2] << 16) | ((uint32_t)d[off + 3] << 24);
  }
  uint64_t r64(size_t off) const {
    if (off + 8 > n) return 0;
    uint64_t hi, lo;
    if (be) {
      hi = r32(off);
      lo = r32(off + 4);
    } else {
      lo = r32(off);
      hi = r32(off + 4);
    }
    return (hi << 32) | lo;
  }
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 8) {
    std::fclose(f);
    return false;
  }
  buf.resize((size_t)size);
  size_t got = std::fread(buf.data(), 1, (size_t)size, f);
  std::fclose(f);
  return got == (size_t)size;
}

uint32_t type_size(uint16_t t) {
  switch (t) {
    case 1: case 2: case 6: case 7: return 1;
    case 3: case 8: return 2;
    case 4: case 9: case 11: return 4;
    case 5: case 10: case 12: case 16: case 17: case 18: return 8;
    default: return 1;
  }
}

// Parse the first IFD of a classic or BigTIFF file, either byte order.
bool parse_ifd(const std::vector<uint8_t>& buf, Ifd& ifd) {
  if (buf.size() < 8) return false;
  bool be;
  if (buf[0] == 'I' && buf[1] == 'I') be = false;
  else if (buf[0] == 'M' && buf[1] == 'M') be = true;
  else return false;
  Reader r{buf.data(), buf.size(), be};
  ifd.bigendian = be;
  uint16_t magic = r.r16(2);
  bool big;
  uint64_t off;
  if (magic == 42) {
    big = false;
    off = r.r32(4);
  } else if (magic == 43) {
    if (r.r16(4) != 8) return false;
    big = true;
    off = r.r64(8);
  } else {
    return false;
  }

  uint64_t n_entries = big ? r.r64(off) : r.r16(off);
  uint64_t base = off + (big ? 8 : 2);
  uint64_t esz = big ? 20 : 12;
  uint64_t inline_cap = big ? 8 : 4;
  if (base + n_entries * esz > buf.size()) return false;

  std::vector<uint64_t> tile_offsets, tile_counts;
  for (uint64_t i = 0; i < n_entries; i++) {
    uint64_t e = base + esz * i;
    uint16_t tag = r.r16(e);
    uint16_t type = r.r16(e + 2);
    uint64_t count = big ? r.r64(e + 4) : r.r32(e + 4);
    uint64_t vpos = e + (big ? 12 : 8);
    uint64_t size = (uint64_t)type_size(type) * count;
    uint64_t voff = (size <= inline_cap) ? vpos : (big ? r.r64(vpos) : r.r32(vpos));
    if (voff + size > buf.size()) return false;
    auto val_at = [&](uint64_t idx) -> uint64_t {
      if (type == 3) return r.r16(voff + 2 * idx);
      if (type == 4) return r.r32(voff + 4 * idx);
      if (type == 16) return r.r64(voff + 8 * idx);
      return 0;
    };
    auto fill = [&](std::vector<uint64_t>& v) {
      v.resize(count);
      for (uint64_t k = 0; k < count; k++) v[k] = val_at(k);
    };
    switch (tag) {
      case 256: ifd.width = (uint32_t)val_at(0); break;
      case 257: ifd.height = (uint32_t)val_at(0); break;
      case 258: ifd.bits = (uint16_t)val_at(0); break;
      case 259: ifd.compression = (uint16_t)val_at(0); break;
      case 262: ifd.photometric = (uint16_t)val_at(0); break;
      case 347:
        ifd.jpegtables_off = voff;
        ifd.jpegtables_len = size;
        break;
      case 277: ifd.samples = (uint16_t)val_at(0); break;
      case 278: ifd.rows_per_strip = (uint32_t)val_at(0); break;
      case 284: ifd.planar = (uint16_t)val_at(0); break;
      case 317: ifd.predictor = (uint16_t)val_at(0); break;
      case 339: ifd.sample_format = (uint16_t)val_at(0); break;
      case 273: fill(ifd.seg_offsets); break;
      case 279: fill(ifd.seg_counts); break;
      case 322: ifd.tile_w = (uint32_t)val_at(0); break;
      case 323: ifd.tile_h = (uint32_t)val_at(0); break;
      case 324: fill(tile_offsets); break;
      case 325: fill(tile_counts); break;
      default: break;
    }
  }
  if (!tile_offsets.empty()) {
    ifd.tiled = true;
    ifd.seg_offsets = std::move(tile_offsets);
    ifd.seg_counts = std::move(tile_counts);
    if (!ifd.tile_w || !ifd.tile_h) return false;
  }
  if (ifd.rows_per_strip == 0) ifd.rows_per_strip = ifd.height;
  return ifd.width && ifd.height && !ifd.seg_offsets.empty() &&
         ifd.seg_offsets.size() == ifd.seg_counts.size();
}

// --------------------------------------------------------- conversion ----

inline void bswap_buf(uint8_t* p, size_t n, uint32_t itemsize) {
  if (itemsize == 2) {
    for (size_t i = 0; i + 1 < n; i += 2) std::swap(p[i], p[i + 1]);
  } else if (itemsize == 4) {
    for (size_t i = 0; i + 3 < n; i += 4) {
      std::swap(p[i], p[i + 3]);
      std::swap(p[i + 1], p[i + 2]);
    }
  } else if (itemsize == 8) {
    for (size_t i = 0; i + 7 < n; i += 8)
      for (uint32_t k = 0; k < 4; k++) std::swap(p[i + k], p[i + 7 - k]);
  }
}

// Undo predictor 2 in place on one row of `n` samples with channel
// interleave `stride` (modular arithmetic in the sample type).
template <typename T>
void unpredict2_row(T* row, uint32_t n, uint32_t stride) {
  for (uint32_t ch = 0; ch < stride; ch++) {
    T acc{};
    for (uint32_t i = ch; i < n; i += stride) {
      acc = (T)(acc + row[i]);
      row[i] = acc;
    }
  }
}

// Undo predictor 3 (floating point) in place on one row: byte-delta
// cumsum, then reassemble from MSB-first byte planes.
void unpredict3_row(uint8_t* row, uint32_t nvals, uint32_t itemsize,
                    std::vector<uint8_t>& scratch) {
  uint32_t nbytes = nvals * itemsize;
  uint8_t acc = 0;
  for (uint32_t i = 0; i < nbytes; i++) {
    acc = (uint8_t)(acc + row[i]);
    row[i] = acc;
  }
  scratch.resize(nbytes);
  // plane p holds the p-th most significant byte of every value
  for (uint32_t v = 0; v < nvals; v++)
    for (uint32_t p = 0; p < itemsize; p++)
      scratch[v * itemsize + p] = row[p * nvals + v];
  // scratch now big-endian values; convert to host little-endian
  bswap_buf(scratch.data(), nbytes, itemsize);
  std::memcpy(row, scratch.data(), nbytes);
}

template <typename T>
void to_f32(const uint8_t* raw, float* out, size_t n) {
  const T* src = reinterpret_cast<const T*>(raw);
  for (size_t i = 0; i < n; i++) out[i] = (float)src[i];
}

void convert_to_f32(const uint8_t* raw, float* out, size_t n, uint16_t bits,
                    uint16_t sf) {
  if (sf == 3) {
    if (bits == 32) to_f32<float>(raw, out, n);
    else to_f32<double>(raw, out, n);
  } else if (sf == 2) {
    if (bits == 8) to_f32<int8_t>(raw, out, n);
    else if (bits == 16) to_f32<int16_t>(raw, out, n);
    else to_f32<int32_t>(raw, out, n);
  } else {
    if (bits == 8) to_f32<uint8_t>(raw, out, n);
    else if (bits == 16) to_f32<uint16_t>(raw, out, n);
    else to_f32<uint32_t>(raw, out, n);
  }
}

struct Scratch {
  std::vector<uint8_t> seg, pred3, jpeg;
  std::vector<float> tilebuf;
};

// Decompress segment `s` into scratch (or return a direct pointer), undo
// byte order and predictor in place, ready for conversion. `rows`×`w_seg`
// samples×`ch` channels.
const uint8_t* prep_segment(const std::vector<uint8_t>& d, const Ifd& ifd,
                            uint32_t s, uint32_t rows, uint32_t w_seg,
                            uint32_t ch, Scratch& sc) {
  uint64_t off = ifd.seg_offsets[s], cnt = ifd.seg_counts[s];
  if (off + cnt > d.size()) return nullptr;
  uint32_t itemsize = ifd.bits / 8;
  size_t decoded = (size_t)rows * w_seg * ch * itemsize;
  const uint8_t* raw;
  uint8_t* mut = nullptr;
  if (ifd.compression == 7) {
    // new-style JPEG: each segment is a JPEG stream; shared tables ride
    // tag 347; PhotometricInterpretation decides the YCbCr transform
    // (mirrors geo/tiff.py _decode_chunk). Tiles may be MCU-padded past
    // the requested region — decode at frame size, crop top-left.
    if (ifd.sample_format != 1 || ifd.predictor != 1) return nullptr;
    const uint8_t* tb = nullptr;
    long long tbn = 0;
    if (ifd.jpegtables_len > 4 &&
        ifd.jpegtables_off + ifd.jpegtables_len <= d.size()) {
      tb = d.data() + ifd.jpegtables_off;
      tbn = (long long)ifd.jpegtables_len;
    }
    int fh, fw, fc, fprec, fmode;
    if (unet_native::jpeg_info_impl(d.data() + off, (long long)cnt, &fh, &fw,
                                    &fc, &fprec, &fmode) != 0)
      return nullptr;
    if (fc != (int)ch || fh < (int)rows || fw < (int)w_seg) return nullptr;
    // MCU round-up is the only legitimate excess; a forged frame header
    // must not drive a giant allocation
    if (fh > (int)rows + 64 || fw > (int)w_seg + 64) return nullptr;
    int oh, ow, oc;
    if (fmode == 2) {
      // lossless (SOF3): 8- or 16-bit samples, no color transform
      if (ifd.bits != 8 && ifd.bits != 16) return nullptr;
      std::vector<uint16_t> wide((size_t)fh * fw * fc);
      int oprec;
      if (unet_native::jpeg_decode16_impl(
              d.data() + off, (long long)cnt, tb, tbn, wide.data(),
              (long long)wide.size(), &oh, &ow, &oc, &oprec) != 0)
        return nullptr;
      sc.seg.resize(decoded);
      if (ifd.bits == 16) {
        uint16_t* out = reinterpret_cast<uint16_t*>(sc.seg.data());
        for (uint32_t rrow = 0; rrow < rows; rrow++)
          std::memcpy(out + (size_t)rrow * w_seg * ch,
                      wide.data() + (size_t)rrow * fw * fc,
                      (size_t)w_seg * ch * 2);
      } else {
        for (uint32_t rrow = 0; rrow < rows; rrow++) {
          const uint16_t* src = wide.data() + (size_t)rrow * fw * fc;
          uint8_t* out = sc.seg.data() + (size_t)rrow * w_seg * ch;
          for (size_t i = 0; i < (size_t)w_seg * ch; i++)
            out[i] = (uint8_t)src[i];
        }
      }
      return sc.seg.data();
    }
    if (ifd.bits != 8) return nullptr;
    sc.jpeg.resize((size_t)fh * fw * fc);
    int ct = (ifd.photometric == 6) ? 1 : (ifd.photometric == 2 ? 0 : -1);
    if (unet_native::jpeg_decode_impl(d.data() + off, (long long)cnt, tb, tbn,
                         sc.jpeg.data(), (long long)sc.jpeg.size(), &oh, &ow,
                         &oc, ct) != 0)
      return nullptr;
    if (fw == (int)w_seg && fh == (int)rows) return sc.jpeg.data();
    sc.seg.resize(decoded);
    for (uint32_t rrow = 0; rrow < rows; rrow++)
      std::memcpy(sc.seg.data() + (size_t)rrow * w_seg * ch,
                  sc.jpeg.data() + (size_t)rrow * fw * fc,
                  (size_t)w_seg * ch);
    return sc.seg.data();
  }
  if (ifd.compression == 1) {
    raw = d.data() + off;
  } else {
    sc.seg.resize(decoded);
    mut = sc.seg.data();
    if (ifd.compression == 8 || ifd.compression == 32946) {
      unsigned long out_len = (unsigned long)decoded;
      if (uncompress(mut, &out_len, d.data() + off, (unsigned long)cnt) != 0 ||
          out_len != decoded)
        return nullptr;
    } else if (ifd.compression == 5) {
      if (lzw_decode_impl(d.data() + off, (long long)cnt, mut,
                          (long long)decoded) != (long long)decoded)
        return nullptr;
    } else if (ifd.compression == 32773) {
      if (packbits_decode_impl(d.data() + off, (long long)cnt, mut,
                               (long long)decoded) != (long long)decoded)
        return nullptr;
    } else {
      return nullptr;
    }
    raw = mut;
  }
  bool need_mut = (ifd.bigendian && itemsize > 1 && ifd.predictor != 3) ||
                  ifd.predictor != 1;
  if (need_mut && !mut) {
    sc.seg.assign(raw, raw + decoded);
    mut = sc.seg.data();
    raw = mut;
  }
  if (!need_mut) return raw;

  uint32_t row_samples = w_seg * ch;
  if (ifd.predictor == 3) {
    // predictor-3 bytes are byte planes (endianness-free until reassembly)
    for (uint32_t rrow = 0; rrow < rows; rrow++)
      unpredict3_row(mut + (size_t)rrow * row_samples * itemsize, row_samples / 1,
                     itemsize, sc.pred3);
    return raw;
  }
  if (ifd.bigendian && itemsize > 1) bswap_buf(mut, decoded, itemsize);
  if (ifd.predictor == 2) {
    for (uint32_t rrow = 0; rrow < rows; rrow++) {
      uint8_t* rp = mut + (size_t)rrow * row_samples * itemsize;
      if (itemsize == 1) {
        if (ifd.sample_format == 2)
          unpredict2_row(reinterpret_cast<int8_t*>(rp), row_samples, ch);
        else
          unpredict2_row(rp, row_samples, ch);
      } else if (itemsize == 2) {
        unpredict2_row(reinterpret_cast<uint16_t*>(rp), row_samples, ch);
      } else if (itemsize == 4 && ifd.sample_format != 3) {
        unpredict2_row(reinterpret_cast<uint32_t*>(rp), row_samples, ch);
      }  // float predictor-2 is not a thing; ignore
    }
  }
  return raw;
}

// Decode one whole image into HWC float32 `out` (size H*W*C).
bool decode_image_f32(const char* path, float* out, int H, int W, int C,
                      Scratch& sc) {
  std::vector<uint8_t> d;
  if (!read_file(path, d)) return false;
  Ifd ifd;
  if (!parse_ifd(d, ifd)) return false;
  if ((int)ifd.width != W || (int)ifd.height != H || (int)ifd.samples != C)
    return false;
  if (ifd.bits != 8 && ifd.bits != 16 && ifd.bits != 32 && ifd.bits != 64)
    return false;
  uint32_t itemsize = ifd.bits / 8;
  uint32_t planes = (ifd.planar == 2) ? ifd.samples : 1;
  uint32_t ch = (ifd.planar == 2) ? 1 : ifd.samples;

  if (!ifd.tiled) {
    uint32_t rps = ifd.rows_per_strip;
    uint32_t strips_per_plane = (ifd.height + rps - 1) / rps;
    if (ifd.seg_offsets.size() < (size_t)strips_per_plane * planes) return false;
    for (uint32_t p = 0; p < planes; p++) {
      for (uint32_t s = 0; s < strips_per_plane; s++) {
        uint32_t rows = std::min(rps, ifd.height - s * rps);
        const uint8_t* raw =
            prep_segment(d, ifd, p * strips_per_plane + s, rows, ifd.width, ch, sc);
        if (!raw) return false;
        if (planes == 1) {
          float* dst = out + (size_t)s * rps * ifd.width * ifd.samples;
          convert_to_f32(raw, dst, (size_t)rows * ifd.width * ifd.samples,
                         ifd.bits, ifd.sample_format);
        } else {
          // planar: scatter band p into interleaved HWC output
          sc.tilebuf.resize((size_t)rows * ifd.width);
          convert_to_f32(raw, sc.tilebuf.data(), (size_t)rows * ifd.width,
                         ifd.bits, ifd.sample_format);
          for (uint32_t rrow = 0; rrow < rows; rrow++) {
            const float* srow = sc.tilebuf.data() + (size_t)rrow * ifd.width;
            float* drow =
                out + ((size_t)(s * rps + rrow) * ifd.width) * ifd.samples + p;
            for (uint32_t x = 0; x < ifd.width; x++)
              drow[(size_t)x * ifd.samples] = srow[x];
          }
        }
      }
    }
    return true;
  }

  // tiled organization
  uint32_t tl = ifd.tile_h, tw = ifd.tile_w;
  uint32_t tiles_down = (ifd.height + tl - 1) / tl;
  uint32_t tiles_across = (ifd.width + tw - 1) / tw;
  uint32_t per_plane = tiles_down * tiles_across;
  if (ifd.seg_offsets.size() < (size_t)per_plane * planes) return false;
  sc.tilebuf.resize((size_t)tl * tw * ch);
  for (uint32_t p = 0; p < planes; p++) {
    for (uint32_t ty = 0; ty < tiles_down; ty++) {
      for (uint32_t tx = 0; tx < tiles_across; tx++) {
        uint32_t s = p * per_plane + ty * tiles_across + tx;
        const uint8_t* raw = prep_segment(d, ifd, s, tl, tw, ch, sc);
        if (!raw) return false;
        convert_to_f32(raw, sc.tilebuf.data(), (size_t)tl * tw * ch, ifd.bits,
                       ifd.sample_format);
        uint32_t copy_rows = std::min(tl, ifd.height - ty * tl);
        uint32_t copy_cols = std::min(tw, ifd.width - tx * tw);
        for (uint32_t rrow = 0; rrow < copy_rows; rrow++) {
          const float* srow = sc.tilebuf.data() + (size_t)rrow * tw * ch;
          float* drow = out + (((size_t)(ty * tl + rrow) * ifd.width) +
                               (size_t)tx * tw) * ifd.samples;
          if (planes == 1) {
            std::memcpy(drow, srow, (size_t)copy_cols * ch * sizeof(float));
          } else {
            for (uint32_t x = 0; x < copy_cols; x++)
              drow[(size_t)x * ifd.samples + p] = srow[x];
          }
        }
      }
    }
  }
  (void)itemsize;
  return true;
}

// Decode one whole image into HWC `out` in the file's own sample type
// (after byte-order + predictor normalization) — no float conversion, so
// uint8 tiles stay 1 byte/px all the way to the device transfer.
bool decode_image_raw(const char* path, uint8_t* out, int H, int W, int C,
                      uint32_t itemsize, int is_float, Scratch& sc) {
  std::vector<uint8_t> d;
  if (!read_file(path, d)) return false;
  Ifd ifd;
  if (!parse_ifd(d, ifd)) return false;
  if ((int)ifd.width != W || (int)ifd.height != H || (int)ifd.samples != C)
    return false;
  if (ifd.bits / 8 != itemsize) return false;
  if ((ifd.sample_format == 3) != (is_float != 0)) return false;
  uint32_t planes = (ifd.planar == 2) ? ifd.samples : 1;
  uint32_t ch = (ifd.planar == 2) ? 1 : ifd.samples;
  size_t px = (size_t)ifd.samples * itemsize;  // bytes per full pixel

  auto scatter_rows = [&](const uint8_t* raw, uint32_t rows, uint32_t w_seg,
                          size_t out_row0, size_t out_col0, uint32_t p) {
    for (uint32_t rrow = 0; rrow < rows; rrow++) {
      const uint8_t* srow = raw + (size_t)rrow * w_seg * ch * itemsize;
      uint8_t* drow = out + ((out_row0 + rrow) * ifd.width + out_col0) * px;
      if (planes == 1) {
        std::memcpy(drow, srow, (size_t)w_seg * ch * itemsize);
      } else {
        uint8_t* dp = drow + (size_t)p * itemsize;
        for (uint32_t x = 0; x < w_seg; x++)
          std::memcpy(dp + (size_t)x * px, srow + (size_t)x * itemsize, itemsize);
      }
    }
  };

  if (!ifd.tiled) {
    uint32_t rps = ifd.rows_per_strip;
    uint32_t strips_per_plane = (ifd.height + rps - 1) / rps;
    if (ifd.seg_offsets.size() < (size_t)strips_per_plane * planes) return false;
    for (uint32_t p = 0; p < planes; p++) {
      for (uint32_t s = 0; s < strips_per_plane; s++) {
        uint32_t rows = std::min(rps, ifd.height - s * rps);
        const uint8_t* raw =
            prep_segment(d, ifd, p * strips_per_plane + s, rows, ifd.width, ch, sc);
        if (!raw) return false;
        scatter_rows(raw, rows, ifd.width, (size_t)s * rps, 0, p);
      }
    }
    return true;
  }
  uint32_t tl = ifd.tile_h, tw = ifd.tile_w;
  uint32_t tiles_down = (ifd.height + tl - 1) / tl;
  uint32_t tiles_across = (ifd.width + tw - 1) / tw;
  uint32_t per_plane = tiles_down * tiles_across;
  if (ifd.seg_offsets.size() < (size_t)per_plane * planes) return false;
  for (uint32_t p = 0; p < planes; p++) {
    for (uint32_t ty = 0; ty < tiles_down; ty++) {
      for (uint32_t tx = 0; tx < tiles_across; tx++) {
        uint32_t s = p * per_plane + ty * tiles_across + tx;
        const uint8_t* raw = prep_segment(d, ifd, s, tl, tw, ch, sc);
        if (!raw) return false;
        uint32_t copy_rows = std::min(tl, ifd.height - ty * tl);
        uint32_t copy_cols = std::min(tw, ifd.width - tx * tw);
        // clip: copy row prefixes only (raw rows are tile-width wide)
        for (uint32_t rrow = 0; rrow < copy_rows; rrow++) {
          const uint8_t* srow = raw + (size_t)rrow * tw * ch * itemsize;
          uint8_t* drow = out + (((size_t)(ty * tl + rrow) * ifd.width) +
                                 (size_t)tx * tw) * px;
          if (planes == 1) {
            std::memcpy(drow, srow, (size_t)copy_cols * ch * itemsize);
          } else {
            uint8_t* dp = drow + (size_t)p * itemsize;
            for (uint32_t x = 0; x < copy_cols; x++)
              std::memcpy(dp + (size_t)x * px, srow + (size_t)x * itemsize,
                          itemsize);
          }
        }
      }
    }
  }
  return true;
}

template <typename Fn>
int run_parallel(int n_tiles, int n_threads, Fn&& per_tile) {
  std::atomic<int> next{0};
  std::atomic<int> failed{0};  // 0 = ok, else tile_index + 1
  int workers = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (workers > n_tiles) workers = n_tiles;
  if (workers < 1) workers = 1;
  if (workers == 1) {
    for (int i = 0; i < n_tiles; i++)
      if (!per_tile(i)) return i + 1;
    return 0;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < workers; t++) {
    pool.emplace_back([&] {
      while (true) {
        int i = next.fetch_add(1);
        if (i >= n_tiles || failed.load() != 0) break;
        if (!per_tile(i)) {
          int expected = 0;
          failed.compare_exchange_strong(expected, i + 1);
          break;
        }
      }
    });
  }
  for (auto& th : pool) th.join();
  return failed.load();
}

}  // namespace

extern "C" {

int unet_decode_batch(const char** paths, int n_tiles, float* out,
                      long long tile_stride, int height, int width,
                      int channels, int n_threads) {
  return run_parallel(n_tiles, n_threads, [&](int i) {
    Scratch sc;
    return decode_image_f32(paths[i], out + (size_t)i * tile_stride, height,
                            width, channels, sc);
  });
}

int unet_decode_masks(const char** paths, int n_tiles, int* out,
                      long long tile_stride, int height, int width,
                      int n_threads) {
  return run_parallel(n_tiles, n_threads, [&](int i) {
    Scratch sc;
    std::vector<float> tmp((size_t)height * width);
    if (!decode_image_f32(paths[i], tmp.data(), height, width, 1, sc))
      return false;
    int* dst = out + (size_t)i * tile_stride;
    for (size_t k = 0; k < tmp.size(); k++) dst[k] = (int)tmp[k];
    return true;
  });
}

int unet_decode_batch_raw(const char** paths, int n_tiles, uint8_t* out,
                          long long tile_stride_bytes, int height, int width,
                          int channels, int itemsize, int is_float,
                          int n_threads) {
  return run_parallel(n_tiles, n_threads, [&](int i) {
    Scratch sc;
    return decode_image_raw(paths[i], out + (size_t)i * tile_stride_bytes,
                            height, width, channels, (uint32_t)itemsize,
                            is_float, sc);
  });
}

long long unet_lzw_decode(const uint8_t* src, long long n, uint8_t* dst,
                          long long cap) {
  return lzw_decode_impl(src, n, dst, cap);
}

long long unet_lzw_encode(const uint8_t* src, long long n, uint8_t* dst,
                          long long cap) {
  return lzw_encode_impl(src, n, dst, cap);
}

long long unet_packbits_decode(const uint8_t* src, long long n, uint8_t* dst,
                               long long cap) {
  return packbits_decode_impl(src, n, dst, cap);
}

long long unet_packbits_encode(const uint8_t* src, long long n, uint8_t* dst,
                               long long cap) {
  return packbits_encode_impl(src, n, dst, cap);
}

int unet_native_version(void) { return 4; }

}  // extern "C"
