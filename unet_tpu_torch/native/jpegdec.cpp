// JPEG decoder: baseline sequential (SOF0/SOF1) and progressive (SOF2),
// Huffman, 8-bit, 1- to 4-component, arbitrary sampling factors, restart
// markers, TIFF JPEGTables abbreviated streams, multi-scan streams with
// spectral selection + successive approximation, libjpeg "fancy" chroma
// upsampling.
//
// Native twin of unet_tpu_torch/geo/jpeg.py (a copy of unet_tpu's): same marker walk, same
// coefficient-buffer scan decoding, same float32 matmul IDCT, same integer
// triangle-filter upsampling and rint/clip rounding, so outputs agree with
// the Python decoder within ±1 level (the only divergence is sgemm
// accumulation order at exact-half rounding boundaries) and with libjpeg
// within ±2. The Python decoder's Huffman loop is the production
// bottleneck for JPEG-in-TIFF aerial tiles (the reference reads these
// through libgdal→libjpeg, the reference's utils.py:39-48); this module
// restores native decode speed with a libjpeg-style two-level Huffman
// lookup (8-bit lookahead table + canonical maxcode fallback).

#include "jpegdec.h"

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace unet_native {
namespace {

// zigzag position -> natural (row-major) position
const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// 8-point IDCT basis A[u][x] = c(u)/2 * cos((2x+1) u pi / 16), float32 —
// the exact matrix geo/jpeg.py builds, so pixel values agree.
struct Basis {
  float a[8][8];
  Basis() {
    for (int u = 0; u < 8; u++) {
      double c = (u == 0) ? (1.0 / std::sqrt(2.0)) : 1.0;
      for (int x = 0; x < 8; x++)
        a[u][x] = (float)(0.5 * c * std::cos((2 * x + 1) * u * M_PI / 16.0));
    }
  }
};
const Basis kBasis;

struct HuffTbl {
  bool present = false;
  // canonical decode: maxcode[l] = largest code of length l (-1 if none),
  // valptr[l] + (code - mincode[l]) indexes symbols[]
  int32_t maxcode[17];
  int32_t mincode[17];
  int32_t valptr[17];
  uint8_t symbols[256];
  int ntotal = 0;
  // 8-bit lookahead: for codes of length <= 8, look_nbits[peek] gives the
  // code length (0 = not resolvable in 8 bits) and look_sym[] the symbol
  uint8_t look_nbits[256];
  uint8_t look_sym[256];

  void build(const uint8_t counts[16], const uint8_t* syms, int total) {
    present = true;
    ntotal = total;
    std::memcpy(symbols, syms, (size_t)total);
    int code = 0, k = 0;
    std::memset(look_nbits, 0, sizeof(look_nbits));
    for (int l = 1; l <= 16; l++) {
      if (counts[l - 1] == 0) {
        maxcode[l] = -1;
        mincode[l] = 0;
        valptr[l] = 0;
        code <<= 1;
        continue;
      }
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < counts[l - 1]; i++) {
        if (l <= 8) {
          // every 8-bit peek starting with this code resolves to it
          int lo = code << (8 - l), hi = lo + (1 << (8 - l));
          for (int p = lo; p < hi; p++) {
            look_nbits[p] = (uint8_t)l;
            look_sym[p] = syms[k];
          }
        }
        code++;
        k++;
      }
      maxcode[l] = code - 1;
      code <<= 1;
    }
  }
};

// MSB-first bit reader with 0xFF00 destuffing; markers and EOF pad with
// zero bytes without being consumed (geo/jpeg.py _BitReader semantics).
struct BitSrc {
  const uint8_t* d;
  long long n;
  long long pos;
  uint64_t acc = 0;
  int nbits = 0;

  void fill() {
    while (nbits <= 48) {
      uint32_t b = 0;
      if (pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint32_t nxt = (pos + 1 < n) ? d[pos + 1] : 0xD9;
          if (nxt == 0x00) {
            pos += 2;  // stuffed literal 0xFF
          } else {
            b = 0;  // restart/EOI/other marker: pad, do not consume
          }
        } else {
          pos++;
        }
      }
      acc = (acc << 8) | b;
      nbits += 8;
    }
  }

  int bits(int nb) {
    if (nb == 0) return 0;
    if (nbits < nb) fill();
    nbits -= nb;
    return (int)((acc >> nbits) & ((1u << nb) - 1));
  }

  int bit() { return bits(1); }

  // returns symbol, or -1 on an invalid code
  int decode(const HuffTbl& t) {
    if (nbits < 16) fill();
    int look = (int)((acc >> (nbits - 8)) & 0xFF);
    int nb = t.look_nbits[look];
    if (nb) {
      nbits -= nb;
      return t.look_sym[look];
    }
    int code16 = (int)((acc >> (nbits - 16)) & 0xFFFF);
    for (int l = 9; l <= 16; l++) {
      int c = code16 >> (16 - l);
      if (t.maxcode[l] >= 0 && c <= t.maxcode[l]) {
        // corrupt entropy data can peek a prefix below mincode[l] that
        // still clears maxcode[l]; the index must stay inside symbols[]
        int idx = t.valptr[l] + c - t.mincode[l];
        if (idx < 0 || idx >= t.ntotal) return -1;
        nbits -= l;
        return t.symbols[idx];
      }
    }
    return -1;
  }

  void align_restart() {
    acc = 0;
    nbits = 0;
    while (pos + 1 < n) {
      if (d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7) {
        pos += 2;
        return;
      }
      pos++;
    }
    pos = n;
  }
};

inline int jextend(int v, int nb) {
  if (nb == 0) return 0;
  return (v >= (1 << (nb - 1))) ? v : v - (1 << nb) + 1;
}

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc = 0, ac = 0;  // from the current SOS
};

struct JState {
  float qt[4][64];  // natural order
  bool qt_present[4] = {false, false, false, false};
  HuffTbl huff_dc[4], huff_ac[4];
  int restart_interval = 0;
  bool has_frame = false;
  bool progressive = false;
  bool lossless = false;
  int precision = 0, h = 0, w = 0, nc = 0;
  Comp comps[4];
  // current scan (refreshed at each SOS)
  int scan_order[4];  // scan position -> component index
  int scan_nc = 0;
  int ss = 0, se = 63, ah = 0, al = 0;
};

// Walk marker segments from `pos` filling `state`. Returns the offset of
// entropy-coded data after the next SOS, -1 if no further SOS (EOI or end
// of stream; normal for abbreviated-tables streams and after the last
// scan), -2 for unsupported coding (arithmetic/lossless/12-bit), -3 for
// corrupt structure.
long long parse_segments(const uint8_t* data, long long n, long long pos,
                         JState& st) {
  while (pos + 4 <= n) {
    if (data[pos] != 0xFF) {
      pos++;
      continue;
    }
    int marker = data[pos + 1];
    if (marker == 0xD8 || marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) {
      pos += 2;
      continue;
    }
    if (marker == 0xD9) return -1;  // EOI
    int seglen = (data[pos + 2] << 8) | data[pos + 3];
    if (pos + 2 + seglen > n || seglen < 2) return -3;
    const uint8_t* seg = data + pos + 4;
    int sn = seglen - 2;
    if (marker == 0xDB) {  // DQT
      int i = 0;
      while (i < sn) {
        int pq = seg[i] >> 4, tq = seg[i] & 0xF;
        i++;
        if (tq > 3) return -3;
        st.qt_present[tq] = true;
        if (pq == 0) {
          if (i + 64 > sn) return -3;
          for (int k = 0; k < 64; k++) st.qt[tq][kZigzag[k]] = (float)seg[i + k];
          i += 64;
        } else {
          if (i + 128 > sn) return -3;
          for (int k = 0; k < 64; k++)
            st.qt[tq][kZigzag[k]] =
                (float)((seg[i + 2 * k] << 8) | seg[i + 2 * k + 1]);
          i += 128;
        }
      }
    } else if (marker == 0xC4) {  // DHT
      int i = 0;
      while (i + 17 <= sn) {
        int tc = seg[i] >> 4, th = seg[i] & 0xF;
        if (th > 3) return -3;
        int total = 0;
        for (int k = 0; k < 16; k++) total += seg[i + 1 + k];
        if (total > 256 || i + 17 + total > sn) return -3;
        HuffTbl& t = (tc == 0) ? st.huff_dc[th] : st.huff_ac[th];
        t.build(seg + i + 1, seg + i + 17, total);
        i += 17 + total;
      }
    } else if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2 ||
               marker == 0xC3) {
      // SOF0/SOF1 baseline, SOF2 progressive, SOF3 lossless
      if (st.has_frame) return -3;  // a second frame would invalidate the
                                    // coefficient-buffer geometry mid-decode
      st.progressive = marker == 0xC2;
      st.lossless = marker == 0xC3;
      if (sn < 6) return -3;
      st.precision = seg[0];
      st.h = (seg[1] << 8) | seg[2];
      st.w = (seg[3] << 8) | seg[4];
      st.nc = seg[5];
      if (st.nc < 1 || st.nc > 4 || sn < 6 + 3 * st.nc) return -3;
      for (int c = 0; c < st.nc; c++) {
        st.comps[c].id = seg[6 + 3 * c];
        st.comps[c].h = seg[7 + 3 * c] >> 4;
        st.comps[c].v = seg[7 + 3 * c] & 0xF;
        st.comps[c].tq = seg[8 + 3 * c];
        if (st.comps[c].h < 1 || st.comps[c].h > 4 || st.comps[c].v < 1 ||
            st.comps[c].v > 4 || st.comps[c].tq > 3)
          return -3;
      }
      st.has_frame = true;
    } else if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7 ||
               marker == 0xC9 || marker == 0xCA || marker == 0xCB ||
               marker == 0xCD || marker == 0xCE || marker == 0xCF) {
      return -2;  // arithmetic / differential
    } else if (marker == 0xDD) {  // DRI
      if (sn < 2) return -3;
      st.restart_interval = (seg[0] << 8) | seg[1];
    } else if (marker == 0xDA) {  // SOS
      if (sn < 1) return -3;
      st.scan_nc = seg[0];
      if (st.scan_nc < 1 || st.scan_nc > 4 || sn < 4 + 2 * st.scan_nc)
        return -3;
      for (int c = 0; c < st.scan_nc; c++) {
        int cs = seg[1 + 2 * c];
        int found = -1;
        for (int k = 0; k < st.nc; k++)
          if (st.comps[k].id == cs) found = k;
        if (found < 0) return -3;
        st.comps[found].dc = seg[2 + 2 * c] >> 4;
        st.comps[found].ac = seg[2 + 2 * c] & 0xF;
        // 4-bit fields index the 4-entry table arrays; T.81 allows 0-3
        if (st.comps[found].dc > 3 || st.comps[found].ac > 3) return -3;
        st.scan_order[c] = found;
      }
      st.ss = seg[1 + 2 * st.scan_nc];
      st.se = seg[2 + 2 * st.scan_nc];
      st.ah = seg[3 + 2 * st.scan_nc] >> 4;
      st.al = seg[3 + 2 * st.scan_nc] & 0xF;
      if (st.lossless) {
        // lossless scan header: Ss = predictor 1-7, Se = 0, Al = Pt
        if (st.ss < 1 || st.ss > 7 || st.se != 0) return -3;
      } else if (st.ss > 63 || st.se > 63 || st.se < st.ss) {
        return -3;
      }
      return pos + 2 + seglen;
    }
    pos += 2 + seglen;
  }
  return -1;
}

// Advance past a scan's entropy-coded data to the next marker that is not
// a stuffed byte, fill byte, or restart (geo/jpeg.py _next_marker_pos).
long long next_marker_pos(const uint8_t* data, long long n, long long pos) {
  while (pos + 1 < n) {
    if (data[pos] != 0xFF) {
      pos++;
      continue;
    }
    uint8_t nxt = data[pos + 1];
    if (nxt == 0x00 || (nxt >= 0xD0 && nxt <= 0xD7))
      pos += 2;
    else if (nxt == 0xFF)
      pos += 1;  // fill byte
    else
      return pos;
  }
  return n;
}

// Frame block geometry: interleaved (MCU-padded) coefficient grid per
// component plus its non-interleaved scan grid (T.81 A.2.2).
struct Geom {
  int hmax = 1, vmax = 1, mcus_x = 0, mcus_y = 0;
  int nby[4], nbx[4];  // MCU-padded storage grid
  int sbh[4], sbw[4];  // non-interleaved scan grid

  void init(const JState& st) {
    for (int c = 0; c < st.nc; c++) {
      if (st.comps[c].h > hmax) hmax = st.comps[c].h;
      if (st.comps[c].v > vmax) vmax = st.comps[c].v;
    }
    mcus_x = (st.w + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (st.h + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < st.nc; c++) {
      nby[c] = mcus_y * st.comps[c].v;
      nbx[c] = mcus_x * st.comps[c].h;
      int cw = (st.w * st.comps[c].h + hmax - 1) / hmax;
      int ch = (st.h * st.comps[c].v + vmax - 1) / vmax;
      sbh[c] = (ch + 7) / 8;
      sbw[c] = (cw + 7) / 8;
    }
  }
};

// Decode one block's contribution for the current scan into `blk`
// (length-64 int32, zigzag order). Covers sequential DC+AC, progressive
// DC first/refine (T.81 G.2.1) and AC first/refine with EOB runs
// (G.2.2, jdphuff.c semantics). Returns 0, or -1 on corrupt data.
int decode_block(BitSrc& br, int32_t* blk, const HuffTbl* dct,
                 const HuffTbl* act, int ss, int se, int ah, int al,
                 int* dc_pred, int ci, long long& eobrun) {
  if (ss == 0) {
    if (ah == 0) {  // DC first (or sequential)
      int t = br.decode(*dct);
      if (t < 0 || t > 15) return -1;
      dc_pred[ci] += jextend(br.bits(t), t);
      blk[0] = dc_pred[ci] * (1 << al);
    } else {  // DC refinement: one correction bit
      if (br.bit()) blk[0] |= (int32_t)1 << al;
    }
    if (se == 0) return 0;
    // sequential scan: AC coefficients follow in the same scan
    int k = 1;
    while (k <= se) {
      int rs = br.decode(*act);
      if (rs < 0) return -1;
      int run = rs >> 4, size = rs & 0xF;
      if (size == 0) {
        if (run == 15) {
          k += 16;
          continue;
        }
        break;  // EOB
      }
      k += run;
      if (k > se) break;
      blk[k] = jextend(br.bits(size), size) * (1 << al);
      k++;
    }
    return 0;
  }
  if (ah == 0) {  // AC first scan
    if (eobrun > 0) {
      eobrun--;
      return 0;
    }
    int k = ss;
    while (k <= se) {
      int rs = br.decode(*act);
      if (rs < 0) return -1;
      int run = rs >> 4, size = rs & 0xF;
      if (size == 0) {
        if (run != 15) {
          eobrun = ((long long)1 << run) - 1;  // this block starts the run
          if (run) eobrun += br.bits(run);
          break;
        }
        k += 16;
        continue;
      }
      k += run;
      if (k > se) break;
      blk[k] = jextend(br.bits(size), size) * (1 << al);
      k++;
    }
    return 0;
  }
  // AC refinement: correction bits for already-nonzero coefficients, plus
  // newly significant ±1<<al coefficients placed by run lengths.
  int32_t p1 = (int32_t)1 << al;
  int32_t m1 = -((int32_t)1 << al);
  int k = ss;
  if (eobrun == 0) {
    while (k <= se) {
      int rs = br.decode(*act);
      if (rs < 0) return -1;
      int run = rs >> 4, size = rs & 0xF;
      int32_t newval = 0;
      if (size == 0) {
        if (run != 15) {
          eobrun = (long long)1 << run;  // current block: tail below
          if (run) eobrun += br.bits(run);
          break;
        }
      } else {  // size is 1 by spec: a newly significant coefficient
        newval = br.bit() ? p1 : m1;
      }
      // advance `run` zero-history coefficients, correcting nonzero ones
      while (k <= se) {
        int32_t c = blk[k];
        if (c != 0) {
          if (br.bit() && (c & p1) == 0) blk[k] = c + (c >= 0 ? p1 : m1);
        } else {
          if (run == 0) break;
          run--;
        }
        k++;
      }
      if (newval != 0 && k <= se) blk[k] = newval;
      k++;
    }
  }
  if (eobrun > 0) {
    while (k <= se) {  // EOB run still sends correction bits for nonzeros
      int32_t c = blk[k];
      if (c != 0) {
        if (br.bit() && (c & p1) == 0) blk[k] = c + (c >= 0 ? p1 : m1);
      }
      k++;
    }
    eobrun--;
  }
  return 0;
}

// Decode one scan's entropy data into the coefficient buffers.
int decode_scan(BitSrc& br, JState& st, const Geom& g,
                std::vector<int32_t>* coefs) {
  int ss = st.ss, se = st.se, ah = st.ah, al = st.al;
  const HuffTbl* dct[4] = {nullptr, nullptr, nullptr, nullptr};
  const HuffTbl* act[4] = {nullptr, nullptr, nullptr, nullptr};
  for (int s = 0; s < st.scan_nc; s++) {
    const Comp& cp = st.comps[st.scan_order[s]];
    if (ss == 0 && ah == 0) {
      if (!st.huff_dc[cp.dc].present) return -1;
      dct[s] = &st.huff_dc[cp.dc];
    }
    if (se > 0) {
      if (!st.huff_ac[cp.ac].present) return -1;
      act[s] = &st.huff_ac[cp.ac];
    }
  }
  if (ss > 0 && st.scan_nc != 1) return -1;  // progressive AC: 1 component

  int dc_pred[4] = {0, 0, 0, 0};
  long long eobrun = 0;
  int ri = st.restart_interval;
  long long count = 0;

  if (st.scan_nc > 1) {  // interleaved over the MCU grid
    for (int my = 0; my < g.mcus_y; my++) {
      for (int mx = 0; mx < g.mcus_x; mx++) {
        if (ri && count && count % ri == 0) {
          br.align_restart();
          dc_pred[0] = dc_pred[1] = dc_pred[2] = dc_pred[3] = 0;
          eobrun = 0;
        }
        for (int s = 0; s < st.scan_nc; s++) {
          int ci = st.scan_order[s];
          const Comp& cp = st.comps[ci];
          for (int by = 0; by < cp.v; by++) {
            for (int bx = 0; bx < cp.h; bx++) {
              int32_t* blk =
                  coefs[ci].data() +
                  ((size_t)(my * cp.v + by) * g.nbx[ci] + (mx * cp.h + bx)) *
                      64;
              if (decode_block(br, blk, dct[s], act[s], ss, se, ah, al,
                               dc_pred, ci, eobrun) < 0)
                return -1;
            }
          }
        }
        count++;
      }
    }
  } else {  // single component: its own block grid, one block per MCU
    int ci = st.scan_order[0];
    for (int by = 0; by < g.sbh[ci]; by++) {
      for (int bx = 0; bx < g.sbw[ci]; bx++) {
        if (ri && count && count % ri == 0) {
          br.align_restart();
          dc_pred[0] = dc_pred[1] = dc_pred[2] = dc_pred[3] = 0;
          eobrun = 0;
        }
        int32_t* blk =
            coefs[ci].data() + ((size_t)by * g.nbx[ci] + bx) * 64;
        if (decode_block(br, blk, dct[0], act[0], ss, se, ah, al, dc_pred,
                         ci, eobrun) < 0)
          return -1;
        count++;
      }
    }
  }
  return 0;
}

// libjpeg h2v1_fancy_upsample: horizontal 2x, 3/4-1/4 triangle filter
// (geo/jpeg.py _fancy_h2). src (h, w) int32 -> dst (h, 2w) int32.
void fancy_h2(const int32_t* src, int h, int w, int32_t* dst) {
  for (int y = 0; y < h; y++) {
    const int32_t* s = src + (size_t)y * w;
    int32_t* o = dst + (size_t)y * 2 * w;
    for (int x = 0; x < w; x++) {
      int32_t p = s[x];
      int32_t prev = s[x > 0 ? x - 1 : 0];
      int32_t nxt = s[x < w - 1 ? x + 1 : w - 1];
      o[2 * x] = (3 * p + prev + 1) >> 2;
      o[2 * x + 1] = (3 * p + nxt + 2) >> 2;
    }
  }
}

// libjpeg h2v2_fancy_upsample (geo/jpeg.py _fancy_h2v2): vertical 3:1
// column sums then the horizontal triangle pass with /16 rounding.
// src (h, w) -> dst (2h, 2w).
void fancy_h2v2(const int32_t* src, int h, int w, int32_t* dst,
                std::vector<int32_t>& rowbuf) {
  rowbuf.resize((size_t)2 * h * w);
  for (int y = 0; y < h; y++) {
    const int32_t* s = src + (size_t)y * w;
    const int32_t* up = src + (size_t)(y > 0 ? y - 1 : 0) * w;
    const int32_t* dn = src + (size_t)(y < h - 1 ? y + 1 : h - 1) * w;
    int32_t* r0 = rowbuf.data() + (size_t)(2 * y) * w;
    int32_t* r1 = rowbuf.data() + (size_t)(2 * y + 1) * w;
    for (int x = 0; x < w; x++) {
      r0[x] = 3 * s[x] + up[x];
      r1[x] = 3 * s[x] + dn[x];
    }
  }
  for (int y = 0; y < 2 * h; y++) {
    const int32_t* r = rowbuf.data() + (size_t)y * w;
    int32_t* o = dst + (size_t)y * 2 * w;
    for (int x = 0; x < w; x++) {
      int32_t p = r[x];
      int32_t prev = r[x > 0 ? x - 1 : 0];
      int32_t nxt = r[x < w - 1 ? x + 1 : w - 1];
      o[2 * x] = (3 * p + prev + 8) >> 4;
      o[2 * x + 1] = (3 * p + nxt + 7) >> 4;
    }
  }
}

// np.rint: round half to even — nearbyintf under the default FE rounding
// mode, which we rely on (never changed process-wide).
inline int32_t rint_clip255(float v) {
  float r = std::nearbyintf(v);
  if (r < 0.0f) return 0;
  if (r > 255.0f) return 255;
  return (int32_t)r;
}

}  // namespace

int jpeg_dims_impl(const uint8_t* data, long long n, int* h, int* w, int* c) {
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return -3;
  long long pos = 2;
  while (pos + 4 <= n) {
    if (data[pos] != 0xFF) {
      pos++;
      continue;
    }
    int marker = data[pos + 1];
    if (marker == 0xD8 || marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) {
      pos += 2;
      continue;
    }
    if (marker == 0xD9 || marker == 0xDA) return -1;
    int seglen = (data[pos + 2] << 8) | data[pos + 3];
    if (pos + 2 + seglen > n || seglen < 2) return -3;
    if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2) {
      const uint8_t* seg = data + pos + 4;
      if (seglen - 2 < 6) return -3;
      *h = (seg[1] << 8) | seg[2];
      *w = (seg[3] << 8) | seg[4];
      *c = seg[5];
      return 0;
    }
    if (marker >= 0xC3 && marker <= 0xCF && marker != 0xC4 && marker != 0xC8 &&
        marker != 0xCC)
      return -2;  // arithmetic / lossless frame
    pos += 2 + seglen;
  }
  return -1;
}

int jpeg_decode_impl(const uint8_t* data, long long n, const uint8_t* tables,
                     long long tn, uint8_t* dst, long long cap, int* out_h,
                     int* out_w, int* out_c, int color_transform) try {
  JState st;
  if (tables && tn > 0) {
    if (tn < 2 || tables[0] != 0xFF || tables[1] != 0xD8) return -3;
    long long r = parse_segments(tables, tn, 2, st);
    if (r == -2 || r == -3) return (int)r;
    // -1 (no SOS) is the normal abbreviated-tables outcome
  }
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return -3;

  Geom g;
  std::vector<int32_t> coefs[4];
  long long pos = 2;
  int nscans = 0;
  bool geom_ready = false;
  while (true) {
    long long scan_pos = parse_segments(data, n, pos, st);
    if (scan_pos == -2 || scan_pos == -3) return (int)scan_pos;
    if (scan_pos < 0) break;  // EOI / end: no further scans
    if (!st.has_frame) return -1;
    if (!geom_ready) {
      if (st.lossless) return -2;  // SOF3 rides jpeg_decode16_impl
      if (st.precision != 8) return -2;
      if (st.h <= 0 || st.w <= 0) return -1;
      // a forged frame header must not drive allocation past the caller's
      // buffer: coefficient + plane scratch is a few times h*w*nc, so
      // bound the frame by the destination capacity before allocating
      if ((long long)st.h * st.w * st.nc > cap) return -3;
      g.init(st);
      for (int c = 0; c < st.nc; c++)
        coefs[c].assign((size_t)g.nby[c] * g.nbx[c] * 64, 0);
      geom_ready = true;
    }
    BitSrc br{data, n, scan_pos};
    if (decode_scan(br, st, g, coefs) < 0) return -1;
    nscans++;
    pos = next_marker_pos(data, n, br.pos);
  }
  if (!st.has_frame || nscans == 0) return -1;

  // dequantize + IDCT every component's blocks, upsample, color-convert —
  // mirrors geo/jpeg.py: subsampled planes round to int before the
  // integer triangle filters.
  std::vector<std::vector<float>> full(st.nc);
  std::vector<float> plane;
  std::vector<int32_t> ibuf, obuf, rowbuf;
  float block[64], tmp[64];
  for (int ci = 0; ci < st.nc; ci++) {
    const Comp& cp = st.comps[ci];
    if (!st.qt_present[cp.tq]) return -1;
    const float* q = st.qt[cp.tq];
    int pw = g.nbx[ci] * 8, ph = g.nby[ci] * 8;
    plane.assign((size_t)pw * ph, 0.0f);
    for (int by = 0; by < g.nby[ci]; by++) {
      for (int bx = 0; bx < g.nbx[ci]; bx++) {
        const int32_t* zz =
            coefs[ci].data() + ((size_t)by * g.nbx[ci] + bx) * 64;
        for (int k = 0; k < 64; k++)
          block[kZigzag[k]] = (float)zz[k] * q[kZigzag[k]];
        for (int u = 0; u < 8; u++)
          for (int y = 0; y < 8; y++) {
            float acc = 0.0f;
            for (int v = 0; v < 8; v++)
              acc += block[u * 8 + v] * kBasis.a[v][y];
            tmp[u * 8 + y] = acc;
          }
        int y0 = by * 8, x0 = bx * 8;
        for (int x = 0; x < 8; x++) {
          float* prow = plane.data() + (size_t)(y0 + x) * pw + x0;
          for (int y = 0; y < 8; y++) {
            float acc = 0.0f;
            for (int u = 0; u < 8; u++) acc += kBasis.a[u][x] * tmp[u * 8 + y];
            prow[y] = acc + 128.0f;
          }
        }
      }
    }
    int fy = g.vmax / cp.v, fx = g.hmax / cp.h;
    if ((fy == 1 && fx == 2) || (fy == 2 && fx == 2)) {
      ibuf.resize((size_t)pw * ph);
      for (size_t i = 0; i < ibuf.size(); i++) ibuf[i] = rint_clip255(plane[i]);
      obuf.resize((size_t)pw * ph * (size_t)fy * fx);
      if (fy == 1)
        fancy_h2(ibuf.data(), ph, pw, obuf.data());
      else
        fancy_h2v2(ibuf.data(), ph, pw, obuf.data(), rowbuf);
      int fw = pw * fx;
      full[ci].resize((size_t)st.h * st.w);
      for (int y = 0; y < st.h; y++)
        for (int x = 0; x < st.w; x++)
          full[ci][(size_t)y * st.w + x] = (float)obuf[(size_t)y * fw + x];
    } else if (fy > 1 || fx > 1) {
      // nearest-neighbor replication for other factors (np.repeat)
      full[ci].resize((size_t)st.h * st.w);
      for (int y = 0; y < st.h; y++)
        for (int x = 0; x < st.w; x++)
          full[ci][(size_t)y * st.w + x] =
              plane[(size_t)(y / fy) * pw + (x / fx)];
    } else {
      full[ci].resize((size_t)st.h * st.w);
      for (int y = 0; y < st.h; y++)
        std::memcpy(full[ci].data() + (size_t)y * st.w,
                    plane.data() + (size_t)y * pw, (size_t)st.w * sizeof(float));
    }
  }

  *out_h = st.h;
  *out_w = st.w;
  *out_c = st.nc;

  if (st.nc == 3) {
    bool convert;
    if (color_transform >= 0) {
      convert = color_transform != 0;
    } else {
      convert = !(st.comps[0].id == 0x52 && st.comps[1].id == 0x47 &&
                  st.comps[2].id == 0x42);
    }
    const float* yp = full[0].data();
    const float* cbp = full[1].data();
    const float* crp = full[2].data();
    size_t npix = (size_t)st.h * st.w;
    if (convert) {
      for (size_t i = 0; i < npix; i++) {
        float y = yp[i], cb = cbp[i] - 128.0f, cr = crp[i] - 128.0f;
        dst[3 * i] = (uint8_t)rint_clip255(y + 1.402f * cr);
        dst[3 * i + 1] =
            (uint8_t)rint_clip255(y - 0.344136f * cb - 0.714136f * cr);
        dst[3 * i + 2] = (uint8_t)rint_clip255(y + 1.772f * cb);
      }
    } else {
      for (size_t i = 0; i < npix; i++) {
        dst[3 * i] = (uint8_t)rint_clip255(yp[i]);
        dst[3 * i + 1] = (uint8_t)rint_clip255(cbp[i]);
        dst[3 * i + 2] = (uint8_t)rint_clip255(crp[i]);
      }
    }
  } else {
    size_t npix = (size_t)st.h * st.w;
    for (int s = 0; s < st.nc; s++) {
      const float* p = full[s].data();
      for (size_t i = 0; i < npix; i++)
        dst[i * st.nc + s] = (uint8_t)rint_clip255(p[i]);
    }
  }
  return 0;
} catch (const std::exception&) {
  return -1;  // bad_alloc etc. must not escape the C ABI
}

// --------------------------------------------------------------------------
// Lossless mode (SOF3, T.81 Annex H) — native twin of geo/jpeg.py's
// Annex-H path. Residuals are Huffman-coded as DC categories (SSSS=16 is a
// residual of exactly 32768 with no extra bits); prediction runs mod 2^16
// in the point-transformed domain with the scan-start / line-start /
// restart rules. Fully sequential: the Ra dependency chains every sample,
// and at native speed that is already ~100x the vectorized numpy path.
// --------------------------------------------------------------------------

inline long long lossless_px(long long ra, long long rb, long long rc,
                             int sel) {
  switch (sel) {
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) >> 1;  // 7 (validated by the caller)
  }
}

int jpeg_info_impl(const uint8_t* data, long long n, int* h, int* w, int* c,
                   int* precision, int* mode) {
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return -3;
  long long pos = 2;
  while (pos + 4 <= n) {
    if (data[pos] != 0xFF) {
      pos++;
      continue;
    }
    int marker = data[pos + 1];
    if (marker == 0xD8 || marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) {
      pos += 2;
      continue;
    }
    if (marker == 0xD9 || marker == 0xDA) return -1;
    int seglen = (data[pos + 2] << 8) | data[pos + 3];
    if (pos + 2 + seglen > n || seglen < 2) return -3;
    if (marker >= 0xC0 && marker <= 0xC3) {
      const uint8_t* seg = data + pos + 4;
      if (seglen - 2 < 6) return -3;
      *precision = seg[0];
      *h = (seg[1] << 8) | seg[2];
      *w = (seg[3] << 8) | seg[4];
      *c = seg[5];
      *mode = (marker == 0xC3) ? 2 : 0;
      return 0;
    }
    if (marker >= 0xC5 && marker <= 0xCF && marker != 0xC8 && marker != 0xCC)
      return -2;  // arithmetic / differential frame
    pos += 2 + seglen;
  }
  return -1;
}

int jpeg_decode16_impl(const uint8_t* data, long long n,
                       const uint8_t* tables, long long tn, uint16_t* dst,
                       long long cap, int* out_h, int* out_w, int* out_c,
                       int* out_precision) try {
  JState st;
  if (tables && tn > 0) {
    if (tn < 2 || tables[0] != 0xFF || tables[1] != 0xD8) return -3;
    long long r = parse_segments(tables, tn, 2, st);
    if (r == -2 || r == -3) return (int)r;
  }
  if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) return -3;

  std::vector<std::vector<uint16_t>> planes;
  int sizes_h[4], sizes_w[4], pts[4] = {0, 0, 0, 0};
  long long pos = 2;
  int nscans = 0;
  bool ready = false;
  while (true) {
    long long scan_pos = parse_segments(data, n, pos, st);
    if (scan_pos == -2 || scan_pos == -3) return (int)scan_pos;
    if (scan_pos < 0) break;
    if (!st.has_frame) return -1;
    if (!st.lossless) return -2;  // DCT modes ride jpeg_decode_impl
    if (!ready) {
      if (st.precision < 2 || st.precision > 16) return -1;
      if (st.h <= 0 || st.w <= 0) return -1;
      if ((long long)st.h * st.w * st.nc > cap) return -3;
      int hmax = 1, vmax = 1;
      for (int c = 0; c < st.nc; c++) {
        hmax = std::max(hmax, st.comps[c].h);
        vmax = std::max(vmax, st.comps[c].v);
      }
      planes.resize(st.nc);
      for (int c = 0; c < st.nc; c++) {
        sizes_h[c] = (st.h * st.comps[c].v + vmax - 1) / vmax;
        sizes_w[c] = (st.w * st.comps[c].h + hmax - 1) / hmax;
        planes[c].assign((size_t)sizes_h[c] * sizes_w[c], 0);
      }
      ready = true;
    }
    // one scan
    int sel = st.ss, pt = st.al;
    if (st.se != 0 || sel < 1 || sel > 7) return -1;
    if (pt < 0 || pt >= st.precision) return -1;
    const long long dflt = 1LL << (st.precision - pt - 1);
    int members[4] = {0, 0, 0, 0};
    const HuffTbl* tbls[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int m = 0; m < st.scan_nc; m++) {
      int ci = st.scan_order[m];
      members[m] = ci;
      if (!st.huff_dc[st.comps[ci].dc].present) return -1;
      tbls[m] = &st.huff_dc[st.comps[ci].dc];
      pts[ci] = pt;
      if (st.scan_nc > 1 && (st.comps[ci].h != 1 || st.comps[ci].v != 1))
        return -1;  // interleaved lossless with subsampling: unsupported
    }
    const int ch = sizes_h[members[0]], cw = sizes_w[members[0]];
    for (int m = 1; m < st.scan_nc; m++)
      if (sizes_h[members[m]] != ch || sizes_w[members[m]] != cw) return -1;

    BitSrc br{data, n, scan_pos};
    const int ri = st.restart_interval;
    long long anchor = 0, count = 0;
    for (int r = 0; r < ch; r++) {
      const long long rowbase = (long long)r * cw;
      for (int c = 0; c < cw; c++) {
        const long long flat = rowbase + c;
        if (ri && count && count % ri == 0) {
          br.align_restart();
          anchor = flat;
        }
        for (int m = 0; m < st.scan_nc; m++) {
          int t = br.decode(*tbls[m]);
          if (t < 0 || t > 16) return -1;
          long long diff = (t == 16) ? 32768 : jextend(br.bits(t), t);
          uint16_t* p = planes[members[m]].data();
          long long px;
          if (flat == anchor) {
            px = dflt;
          } else if (r == (int)(anchor / cw)) {
            px = p[flat - 1];  // first line since scan start/restart: Ra
          } else if (c == 0) {
            px = p[flat - cw];
          } else {
            px = lossless_px(p[flat - 1], p[flat - cw], p[flat - cw - 1], sel);
          }
          p[flat] = (uint16_t)((px + diff) & 0xFFFF);
        }
        count++;
      }
    }
    nscans++;
    pos = next_marker_pos(data, n, br.pos);
  }
  if (!st.has_frame || nscans == 0) return -1;

  int hmax = 1, vmax = 1;
  for (int c = 0; c < st.nc; c++) {
    hmax = std::max(hmax, st.comps[c].h);
    vmax = std::max(vmax, st.comps[c].v);
  }
  for (int ci = 0; ci < st.nc; ci++) {
    const uint16_t* p = planes[ci].data();
    const int pw = sizes_w[ci];
    const int fy = vmax / st.comps[ci].v, fx = hmax / st.comps[ci].h;
    const int shift = pts[ci];
    for (int y = 0; y < st.h; y++) {
      const uint16_t* prow = p + (size_t)(y / fy) * pw;
      uint16_t* drow = dst + ((size_t)y * st.w) * st.nc + ci;
      for (int x = 0; x < st.w; x++)
        drow[(size_t)x * st.nc] = (uint16_t)(prow[x / fx] << shift);
    }
  }
  *out_h = st.h;
  *out_w = st.w;
  *out_c = st.nc;
  *out_precision = st.precision;
  return 0;
} catch (const std::exception&) {
  return -1;
}

}  // namespace unet_native

extern "C" {

int unet_jpeg_dims(const uint8_t* data, long long n, int* h, int* w, int* c) {
  return unet_native::jpeg_dims_impl(data, n, h, w, c);
}

int unet_jpeg_decode(const uint8_t* data, long long n, const uint8_t* tables,
                     long long tn, uint8_t* dst, long long cap, int* out_h,
                     int* out_w, int* out_c, int color_transform) {
  return unet_native::jpeg_decode_impl(data, n, tables, tn, dst, cap, out_h,
                                       out_w, out_c, color_transform);
}

int unet_jpeg_info(const uint8_t* data, long long n, int* h, int* w, int* c,
                   int* precision, int* mode) {
  return unet_native::jpeg_info_impl(data, n, h, w, c, precision, mode);
}

int unet_jpeg_decode16(const uint8_t* data, long long n,
                       const uint8_t* tables, long long tn, uint16_t* dst,
                       long long cap, int* out_h, int* out_w, int* out_c,
                       int* out_precision) {
  return unet_native::jpeg_decode16_impl(data, n, tables, tn, dst, cap, out_h,
                                         out_w, out_c, out_precision);
}

}  // extern "C"
