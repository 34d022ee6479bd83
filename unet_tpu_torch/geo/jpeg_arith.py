"""Arithmetic-coded JPEG entropy layer (ITU-T T.81 Annexes D, F, G).

QM-coder decode/encode plus the DC/AC statistical models, covering
extended-sequential (SOF9) and progressive (SOF10) arithmetic scans —
the one JPEG coding process ``geo/jpeg.py`` previously routed to the
PIL fallback. The reference pipeline reads imagery through GDAL
(the reference utils.py:39-48) whose libjpeg backend decodes these
streams; this module closes that parity gap dependency-free.

Design notes
------------
* The probability-estimation state machine is ITU-T T.81 Table D.3
  (113 adaptive states + the fixed ~0.5 bin used for sign decisions).
  The table constants were cross-checked against the copy libjpeg
  ships in its public ``jpeg_aritab`` symbol, so interop is exact.
* Each context is one byte in a per-scan statistics area: bit 7 holds
  the current MPS sense, bits 0-6 the Table D.3 state index — DC areas
  are 49 bins per conditioning table (T.81 Table F.4), AC areas 245
  bins (Table F.5), reallocated/zeroed at every scan and restart.
* The coder registers follow the interval math directly rather than
  any particular C implementation: ``a`` is the current interval size
  renormalized into [0x8000, 0x10000); the decoder keeps ``v``, the
  code-point offset inside that interval at the same scale, feeding
  bytes lazily with 0xFF-stuffing removal and an endless zero feed
  once a marker is reached (T.81 D.2.6-D.2.7); the encoder keeps the
  28-bit carry-propagating ``c`` register with stacked-0xFF byteout
  and the CLEARBITS/FINALWRITES flush (D.1.6-D.1.9).
* Encoding supports the sequential mode (used by round-trip tests,
  ``encode_arithmetic`` and TIFF writers); progressive streams are
  decode-only, mirroring what real-world writers produce.

Bit-exact interop with libjpeg (both directions, at the coefficient
level via ``jpeg_read_coefficients``) is pinned in
``tests/test_jpeg_arith.py`` through the ``tools/jpegref.c`` harness.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

# ITU-T T.81 Table D.3 — Qe value, Next_Index_MPS, Next_Index_LPS,
# Switch_MPS; entry 113 is the non-adapting ~0.5 bin (sign decisions).
QE_TABLE: Tuple[Tuple[int, int, int, int], ...] = (
    (0x5A1D, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0),
    (0x080B, 4, 18, 0), (0x03D8, 5, 20, 0), (0x01DA, 6, 23, 0),
    (0x00E5, 7, 25, 0), (0x006F, 8, 28, 0), (0x0036, 9, 30, 0),
    (0x001A, 10, 33, 0), (0x000D, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5A7F, 15, 15, 1),
    (0x3F25, 16, 36, 0), (0x2CF2, 17, 38, 0), (0x207C, 18, 39, 0),
    (0x17B9, 19, 40, 0), (0x1182, 20, 42, 0), (0x0CEF, 21, 43, 0),
    (0x09A1, 22, 45, 0), (0x072F, 23, 46, 0), (0x055C, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0),
    (0x01B1, 28, 54, 0), (0x0144, 29, 56, 0), (0x00F5, 30, 57, 0),
    (0x00B7, 31, 59, 0), (0x008A, 32, 60, 0), (0x0068, 33, 62, 0),
    (0x004E, 34, 63, 0), (0x003B, 35, 32, 0), (0x002C, 9, 33, 0),
    (0x5AE1, 37, 37, 1), (0x484C, 38, 64, 0), (0x3A0D, 39, 65, 0),
    (0x2EF1, 40, 67, 0), (0x261F, 41, 68, 0), (0x1F33, 42, 69, 0),
    (0x19A8, 43, 70, 0), (0x1518, 44, 72, 0), (0x1177, 45, 73, 0),
    (0x0E74, 46, 74, 0), (0x0BFB, 47, 75, 0), (0x09F8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05CD, 51, 48, 0),
    (0x04DE, 52, 50, 0), (0x040F, 53, 50, 0), (0x0363, 54, 51, 0),
    (0x02D4, 55, 52, 0), (0x025C, 56, 53, 0), (0x01F8, 57, 54, 0),
    (0x01A4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00F6, 61, 58, 0), (0x00CB, 62, 59, 0), (0x00AB, 63, 61, 0),
    (0x008F, 32, 61, 0), (0x5B12, 65, 65, 1), (0x4D04, 66, 80, 0),
    (0x412C, 67, 81, 0), (0x37D8, 68, 82, 0), (0x2FE8, 69, 83, 0),
    (0x293C, 70, 84, 0), (0x2379, 71, 86, 0), (0x1EDF, 72, 87, 0),
    (0x1AA9, 73, 87, 0), (0x174E, 74, 72, 0), (0x1424, 75, 72, 0),
    (0x119C, 76, 74, 0), (0x0F6B, 77, 74, 0), (0x0D51, 78, 75, 0),
    (0x0BB6, 79, 77, 0), (0x0A40, 48, 77, 0), (0x5832, 81, 80, 1),
    (0x4D1C, 82, 88, 0), (0x438E, 83, 89, 0), (0x3BDD, 84, 90, 0),
    (0x34EE, 85, 91, 0), (0x2EAE, 86, 92, 0), (0x299A, 87, 93, 0),
    (0x2516, 71, 86, 0), (0x5570, 89, 88, 1), (0x4CA9, 90, 95, 0),
    (0x44D9, 91, 96, 0), (0x3E22, 92, 97, 0), (0x3824, 93, 99, 0),
    (0x32B4, 94, 99, 0), (0x2E17, 86, 93, 0), (0x56A8, 96, 95, 1),
    (0x4F46, 97, 101, 0), (0x47E5, 98, 102, 0), (0x41CF, 99, 103, 0),
    (0x3C3D, 100, 104, 0), (0x375E, 93, 99, 0), (0x5231, 102, 105, 0),
    (0x4C0F, 103, 106, 0), (0x4639, 104, 107, 0), (0x415E, 99, 103, 0),
    (0x5627, 106, 105, 1), (0x50E7, 107, 108, 0), (0x4B85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504F, 107, 111, 0), (0x5A10, 111, 110, 1),
    (0x5522, 109, 112, 0), (0x59EB, 111, 112, 1), (0x5A1D, 113, 113, 0),
)

DC_STAT_BINS = 64   # 49 used (Table F.4); padded like the table ids allow
AC_STAT_BINS = 256  # 245 used (Table F.5)
FIXED_BIN = 113     # non-adapting state index for sign decisions


class Decoder:
    """QM arithmetic decoder over one entropy-coded segment.

    ``a``: interval size in [0x8000, 0x10000) after renormalization
    (0x10000 at stream start); ``v``: code-point offset within the
    current interval at the same scale. ``pos`` tracks the next unread
    byte; hitting a marker (or running out of data) flips ``marker``
    and every subsequent byte reads as zero, matching the encoder's
    trailing-zero truncation.
    """

    __slots__ = ("data", "n", "pos", "marker", "a", "v", "bitbuf", "bitcnt")

    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.n = len(data)
        self.pos = pos
        self.marker = False
        self.bitbuf = 0
        self.bitcnt = 0
        b0 = self._byte()
        b1 = self._byte()
        self.a = 0x10000
        self.v = (b0 << 8) | b1

    def _byte(self) -> int:
        if self.marker:
            return 0
        d, n, p = self.data, self.n, self.pos
        if p >= n:
            self.marker = True
            return 0
        b = d[p]
        start = p
        p += 1
        if b == 0xFF:
            # swallow fill 0xFF bytes; 0xFF 0x00 is a stuffed 0xFF datum
            while p < n and d[p] == 0xFF:
                p += 1
            if p < n and d[p] == 0x00:
                p += 1
            else:  # marker (or truncated stream): endless zero feed
                self.marker = True
                self.pos = start  # leave pos at the marker's first 0xFF
                return 0
        self.pos = p
        return b

    def decode(self, st: bytearray, k: int) -> int:
        """Decode one binary decision in context ``st[k]``."""
        sv = st[k]
        qe, nmps, nlps, sw = QE_TABLE[sv & 0x7F]
        a = self.a - qe
        if self.v < a:
            if a & 0x8000:  # no renormalization: MPS by definition
                self.a = a
                return sv >> 7
            # renormalizing MPS-side path: conditional exchange applies
            if a < qe:
                bit = (sv >> 7) ^ 1
                st[k] = ((sv & 0x80) ^ (sw << 7)) | nlps
            else:
                bit = sv >> 7
                st[k] = (sv & 0x80) | nmps
        else:
            self.v -= a
            if a < qe:  # exchanged: the Qe-sized top interval is the MPS
                bit = sv >> 7
                st[k] = (sv & 0x80) | nmps
            else:
                bit = (sv >> 7) ^ 1
                st[k] = ((sv & 0x80) ^ (sw << 7)) | nlps
            a = qe
        v = self.v
        bitcnt = self.bitcnt
        bitbuf = self.bitbuf
        while a < 0x8000:
            if bitcnt == 0:
                bitbuf = self._byte()
                bitcnt = 8
            bitcnt -= 1
            a <<= 1
            v = (v << 1) | ((bitbuf >> bitcnt) & 1)
        self.a, self.v = a, v
        self.bitcnt, self.bitbuf = bitcnt, bitbuf
        return bit


class Encoder:
    """QM arithmetic encoder emitting a stuffed entropy-coded segment."""

    __slots__ = ("a", "c", "ct", "buf", "pending", "stacked_ff")

    def __init__(self):
        self.a = 0x10000
        self.c = 0
        self.ct = 11
        self.buf = bytearray()
        self.pending: Optional[int] = None  # last byte awaiting carry
        self.stacked_ff = 0                 # 0xFF run after ``pending``

    def _commit(self, b: int) -> None:
        self.buf.append(b)
        if b == 0xFF:
            self.buf.append(0x00)  # byte stuffing (T.81 D.1.6)

    def _byteout(self) -> None:
        t = self.c >> 19
        self.c &= 0x7FFFF
        self.ct = 8
        if t > 0xFF:  # carry: resolve into pending byte and stacked 0xFFs
            if self.pending is None:
                raise AssertionError("arithmetic coder carry before output")
            self._commit(self.pending + 1)
            for _ in range(self.stacked_ff):
                self._commit(0x00)
            self.stacked_ff = 0
            self.pending = t & 0xFF
        elif t == 0xFF:
            self.stacked_ff += 1
        else:
            if self.pending is not None:
                self._commit(self.pending)
            for _ in range(self.stacked_ff):
                self._commit(0xFF)
            self.stacked_ff = 0
            self.pending = t

    def encode(self, st: bytearray, k: int, bit: int) -> None:
        sv = st[k]
        qe, nmps, nlps, sw = QE_TABLE[sv & 0x7F]
        a = self.a - qe
        if bit == (sv >> 7):  # MPS
            if a & 0x8000:
                self.a = a
                return
            if a < qe:  # conditional exchange: MPS takes the top interval
                self.c += a
                a = qe
            st[k] = (sv & 0x80) | nmps
        else:  # LPS
            if a >= qe:
                self.c += a
                a = qe
            st[k] = ((sv & 0x80) ^ (sw << 7)) | nlps
        c, ct = self.c, self.ct
        while a < 0x8000:
            a <<= 1
            c <<= 1
            ct -= 1
            if ct == 0:
                self.c, self.ct = c, ct
                self._byteout()
                c, ct = self.c, self.ct
        self.a, self.c, self.ct = a, c, ct

    def flush(self) -> bytes:
        """Terminate (T.81 D.1.8-D.1.9) and return the entropy segment."""
        # CLEARBITS: move C to the value in [C, C+A) with the most
        # trailing zero bits.
        t = (self.c + self.a - 1) & 0xFFFF0000
        self.c = t + 0x8000 if t < self.c else t
        # FINALWRITES: flush the two remaining bytes through byteout so
        # carry propagation stays uniform.
        self.c <<= self.ct
        self._byteout()
        self.c <<= 8
        self._byteout()
        if self.pending is not None:
            self._commit(self.pending)
        for _ in range(self.stacked_ff):
            self._commit(0xFF)
        self.pending, self.stacked_ff = None, 0
        # Trailing zero bytes are reconstructed by the decoder's zero
        # feed; drop them, but never a stuffed zero (its 0xFF needs it).
        buf = self.buf
        while buf and buf[-1] == 0x00 and not (len(buf) >= 2 and buf[-2] == 0xFF):
            buf.pop()
        out = bytes(buf)
        self.buf = bytearray()
        return out


class _ScanStats:
    """Per-scan statistics areas + per-component DC predictors."""

    def __init__(self, n_components: int):
        self.dc: Dict[int, bytearray] = {}
        self.ac: Dict[int, bytearray] = {}
        self.fixed = bytearray([FIXED_BIN])
        self.dc_context = [0] * n_components
        self.last_dc = [0] * n_components

    def dc_area(self, tbl: int) -> bytearray:
        if tbl not in self.dc:
            self.dc[tbl] = bytearray(DC_STAT_BINS)
        return self.dc[tbl]

    def ac_area(self, tbl: int) -> bytearray:
        if tbl not in self.ac:
            self.ac[tbl] = bytearray(AC_STAT_BINS)
        return self.ac[tbl]

    def reset(self) -> None:
        for area in self.dc.values():
            area[:] = bytes(len(area))
        for area in self.ac.values():
            area[:] = bytes(len(area))
        self.fixed[0] = FIXED_BIN
        self.dc_context = [0] * len(self.dc_context)
        self.last_dc = [0] * len(self.last_dc)


def _decode_dc_diff(dec: Decoder, stats: _ScanStats, tbl: int, ci: int,
                    cond: Tuple[int, int]) -> int:
    """One DC difference (T.81 F.1.4.4.1 decision tree)."""
    lo, up = cond
    st = stats.dc_area(tbl)
    base = stats.dc_context[ci]
    if dec.decode(st, base) == 0:
        stats.dc_context[ci] = 0
        return 0
    sign = dec.decode(st, base + 1)
    k = base + 2 + sign
    m = dec.decode(st, k)
    if m:
        k = 20  # X1 bin (Table F.4)
        while dec.decode(st, k):
            m <<= 1
            if m == 0x8000:
                raise ValueError("Corrupt arithmetic JPEG: DC magnitude")
            k += 1
    # conditioning category for the NEXT block (F.1.4.4.1.2)
    if m < (1 << lo) >> 1:
        stats.dc_context[ci] = 0
    elif m > (1 << up) >> 1:
        stats.dc_context[ci] = 12 + 4 * sign
    else:
        stats.dc_context[ci] = 4 + 4 * sign
    v = m
    k += 14  # magnitude mantissa bins live one chain-width above
    while m > 1:
        m >>= 1
        if dec.decode(st, k):
            v |= m
    v += 1
    return -v if sign else v


def _decode_ac_seq(dec: Decoder, stats: _ScanStats, tbl: int,
                   block: np.ndarray, ss: int, se: int, al: int,
                   kx: int) -> None:
    """AC coefficients for a sequential or progressive-first scan
    (T.81 F.1.4.4.2 / G.1.3.2), zigzag indices ``ss..se``."""
    st = stats.ac_area(tbl)
    k = ss
    while k <= se:
        base = 3 * (k - 1)
        if dec.decode(st, base):  # EOB
            return
        while dec.decode(st, base + 1) == 0:
            base += 3
            k += 1
            if k > se:
                raise ValueError("Corrupt arithmetic JPEG: AC zero run")
        sign = dec.decode(stats.fixed, 0)
        base += 2
        m = dec.decode(st, base)
        if m and dec.decode(st, base):
            m = 2
            base = 189 if k <= kx else 217  # shared X chains (Table F.5)
            while dec.decode(st, base):
                m <<= 1
                if m == 0x8000:
                    raise ValueError("Corrupt arithmetic JPEG: AC magnitude")
                base += 1
        v = m
        base += 14
        while m > 1:
            m >>= 1
            if dec.decode(st, base):
                v |= m
        v += 1
        block[k] = (-v if sign else v) << al
        k += 1


def _decode_ac_refine(dec: Decoder, stats: _ScanStats, tbl: int,
                      block: np.ndarray, ss: int, se: int, al: int) -> None:
    """Successive-approximation AC refinement (T.81 G.1.3.3)."""
    st = stats.ac_area(tbl)
    p1 = 1 << al
    m1 = -1 << al
    kex = se  # end of the previous scans' nonzero history
    while kex > 0 and block[kex] == 0:
        kex -= 1
    k = ss
    while k <= se:
        base = 3 * (k - 1)
        if k > kex and dec.decode(st, base):  # EOB
            return
        while True:
            c = int(block[k])
            if c:
                if dec.decode(st, base + 2):
                    block[k] = c + (p1 if c >= 0 else m1)
                break
            if dec.decode(st, base + 1):  # newly nonzero
                block[k] = m1 if dec.decode(stats.fixed, 0) else p1
                break
            base += 3
            k += 1
            if k > se:
                raise ValueError("Corrupt arithmetic JPEG: AC refinement")
        k += 1


def _find_restart(data: bytes, pos: int, want: int) -> int:
    """Position after the next restart marker at/after ``pos``."""
    n = len(data)
    while pos + 1 < n:
        if data[pos] != 0xFF:
            pos += 1
        elif data[pos + 1] == 0x00:
            pos += 2
        elif data[pos + 1] == 0xFF:
            pos += 1
        else:
            m = data[pos + 1]
            if 0xD0 <= m <= 0xD7:
                if m != 0xD0 + want:
                    raise ValueError("Corrupt JPEG: restart marker out of "
                                     f"order (got RST{m - 0xD0}, want "
                                     f"RST{want})")
                return pos + 2
            raise ValueError("Corrupt JPEG: expected restart marker, got "
                             f"marker 0x{m:02X}")
    raise ValueError("Corrupt JPEG: missing restart marker")


def decode_scan(data: bytes, scan_pos: int, state, geom, coefs: List[np.ndarray],
                comps: List[dict]) -> Decoder:
    """Decode one arithmetic-coded scan's entropy data into the zigzag
    coefficient buffers. Mirrors ``jpeg._decode_scan``'s walk; returns
    the decoder (its ``pos`` marks where the scan's entropy data ended).
    """
    scan = state.scan
    ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
    by_id = {c["id"]: i for i, c in enumerate(comps)}
    members = []
    for s in scan["comps"]:
        if s["cs"] not in by_id:
            raise ValueError(f"Scan references unknown component {s['cs']}")
        members.append((by_id[s["cs"]], comps[by_id[s["cs"]]],
                        s["dc"], s["ac"]))
    if ss > 0 and len(members) != 1:
        raise ValueError("Corrupt JPEG: progressive AC scan must be "
                         "non-interleaved")

    stats = _ScanStats(len(comps))
    dec = Decoder(data, scan_pos)
    ri = state.restart_interval
    rst = 0
    count = 0

    def maybe_restart(d: Decoder) -> Decoder:
        nonlocal rst
        pos = _find_restart(data, d.pos, rst)
        rst = (rst + 1) & 7
        stats.reset()
        return Decoder(data, pos)

    def decode_block_dc(ci: int, block: np.ndarray, dc_tbl: int) -> None:
        cond = state.arith_dc_cond.get(dc_tbl, (0, 1))
        if ah == 0:
            stats.last_dc[ci] += _decode_dc_diff(dec, stats, dc_tbl, ci, cond)
            block[0] = stats.last_dc[ci] << al
        else:  # DC refinement: one fixed-probability bit
            if dec.decode(stats.fixed, 0):
                block[0] |= 1 << al

    interleaved = len(scan["comps"]) > 1
    if interleaved:
        for my in range(geom.mcus_y):
            for mx in range(geom.mcus_x):
                if ri and count and count % ri == 0:
                    dec = maybe_restart(dec)
                for ci, c, dc_tbl, ac_tbl in members:
                    for by in range(c["v"]):
                        for bx in range(c["h"]):
                            block = coefs[ci][my * c["v"] + by,
                                              mx * c["h"] + bx]
                            decode_block_dc(ci, block, dc_tbl)
                            if se > 0:
                                kx = state.arith_ac_cond.get(ac_tbl, 5)
                                _decode_ac_seq(dec, stats, ac_tbl, block,
                                               1, se, 0, kx)
                count += 1
    else:
        ci, c, dc_tbl, ac_tbl = members[0]
        _, _, bh, bw = geom.grid[ci]
        kx = state.arith_ac_cond.get(ac_tbl, 5)
        for by in range(bh):
            for bx in range(bw):
                if ri and count and count % ri == 0:
                    dec = maybe_restart(dec)
                block = coefs[ci][by, bx]
                if ss == 0:
                    decode_block_dc(ci, block, dc_tbl)
                    if se > 0:
                        _decode_ac_seq(dec, stats, ac_tbl, block, 1, se,
                                       0, kx)
                elif ah == 0:
                    _decode_ac_seq(dec, stats, ac_tbl, block, ss, se, al, kx)
                else:
                    _decode_ac_refine(dec, stats, ac_tbl, block, ss, se, al)
                count += 1
    return dec


# ---------------------------------------------------------------------------
# Sequential encoder (round-trip verification + ``encode_arithmetic``)

def _encode_dc_diff(enc: Encoder, stats: _ScanStats, tbl: int, ci: int,
                    cond: Tuple[int, int], diff: int) -> None:
    lo, up = cond
    st = stats.dc_area(tbl)
    base = stats.dc_context[ci]
    if diff == 0:
        enc.encode(st, base, 0)
        stats.dc_context[ci] = 0
        return
    enc.encode(st, base, 1)
    sign = 1 if diff < 0 else 0
    enc.encode(st, base + 1, sign)
    sz = (-diff if sign else diff) - 1
    k = base + 2 + sign
    if sz == 0:
        enc.encode(st, k, 0)
        m = 0
    else:
        enc.encode(st, k, 1)
        m = 1
        k = 20
        while (m << 1) <= sz:
            enc.encode(st, k, 1)
            m <<= 1
            k += 1
        enc.encode(st, k, 0)
    if m < (1 << lo) >> 1:
        stats.dc_context[ci] = 0
    elif m > (1 << up) >> 1:
        stats.dc_context[ci] = 12 + 4 * sign
    else:
        stats.dc_context[ci] = 4 + 4 * sign
    k += 14
    mm = m
    while mm > 1:
        mm >>= 1
        enc.encode(st, k, 1 if sz & mm else 0)


def _encode_ac_block(enc: Encoder, stats: _ScanStats, tbl: int,
                     block: np.ndarray, se: int, kx: int) -> None:
    st = stats.ac_area(tbl)
    ke = se
    while ke > 0 and block[ke] == 0:
        ke -= 1
    k = 1
    while k <= ke:
        base = 3 * (k - 1)
        enc.encode(st, base, 0)  # not EOB
        while block[k] == 0:
            enc.encode(st, base + 1, 0)
            base += 3
            k += 1
        enc.encode(st, base + 1, 1)
        v = int(block[k])
        sign = 1 if v < 0 else 0
        enc.encode(stats.fixed, 0, sign)
        sz = (-v if sign else v) - 1
        base += 2
        if sz == 0:
            enc.encode(st, base, 0)
            m = 0
        elif sz == 1:
            enc.encode(st, base, 1)
            enc.encode(st, base, 0)
            m = 1
        else:
            enc.encode(st, base, 1)
            enc.encode(st, base, 1)
            m = 2
            base = 189 if k <= kx else 217
            while (m << 1) <= sz:
                enc.encode(st, base, 1)
                m <<= 1
                base += 1
            enc.encode(st, base, 0)
        base += 14
        mm = m
        while mm > 1:
            mm >>= 1
            enc.encode(st, base, 1 if sz & mm else 0)
        k += 1
    if ke < se:
        enc.encode(st, 3 * ke, 1)  # EOB at position ke+1


def encode_scan(coefs: List[np.ndarray], comps: List[dict], geom,
                dc_cond: Dict[int, Tuple[int, int]], ac_cond: Dict[int, int],
                restart_interval: int = 0) -> bytes:
    """Entropy-encode interleaved sequential-arithmetic scan data from
    zigzag coefficient buffers (the inverse of ``decode_scan`` for a
    single full scan; Ss=0, Se=63, Ah=Al=0)."""
    stats = _ScanStats(len(comps))
    enc = Encoder()
    out = bytearray()
    rst = 0
    count = 0
    for my in range(geom.mcus_y):
        for mx in range(geom.mcus_x):
            if restart_interval and count and count % restart_interval == 0:
                out += enc.flush()
                out += bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) & 7
                enc = Encoder()
                stats.reset()
            for ci, c in enumerate(comps):
                dc_tbl = c.get("dc_tbl", 0)
                ac_tbl = c.get("ac_tbl", 0)
                for by in range(c["v"]):
                    for bx in range(c["h"]):
                        block = coefs[ci][my * c["v"] + by, mx * c["h"] + bx]
                        dc = int(block[0])
                        _encode_dc_diff(enc, stats, dc_tbl, ci,
                                        dc_cond.get(dc_tbl, (0, 1)),
                                        dc - stats.last_dc[ci])
                        stats.last_dc[ci] = dc
                        _encode_ac_block(enc, stats, ac_tbl, block, 63,
                                         ac_cond.get(ac_tbl, 5))
            count += 1
    out += enc.flush()
    return bytes(out)


def encode_arithmetic(img: np.ndarray, quality: int = 90,
                      restart_interval: int = 0,
                      dc_cond: Tuple[int, int] = (0, 1),
                      ac_kx: int = 5) -> bytes:
    """Encode (H, W[, C]) uint8 samples as an extended-sequential
    arithmetic-coded JPEG (SOF9), 4:4:4, one interleaved scan.

    3-channel input is converted to JFIF YCbCr (matching ``decode``'s
    auto color transform); other channel counts are encoded as raw
    planes. Emits an explicit DAC segment so non-default conditioning
    bounds round-trip through the parser.
    """
    # IDCT basis (orthonormal, FDCT = A·x·Aᵀ) + shared quantization /
    # color helpers live with the baseline codec
    from .jpeg import K1_CHROMA, K1_LUMA, ZIGZAG, _A, _quant_table, \
        _rgb_to_ycbcr

    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.dtype != np.uint8:
        raise ValueError("encode_arithmetic: 8-bit samples only")
    h, w, nc = img.shape
    planes = img.astype(np.float64)
    if nc == 3:
        planes = _rgb_to_ycbcr(planes)

    qluma = _quant_table(K1_LUMA, quality)
    qchroma = _quant_table(K1_CHROMA, quality)
    qts = [qluma] + ([qchroma] if nc > 1 else [])

    bh, bw = -(-h // 8), -(-w // 8)
    coefs = []
    comps = []
    for ci in range(nc):
        p = planes[..., ci]
        p = np.pad(p, ((0, bh * 8 - h), (0, bw * 8 - w)), mode="edge") - 128.0
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ui,YXij,vj->YXuv", _A, blocks, _A, optimize=True)
        q = (qts[min(ci, len(qts) - 1)]).reshape(8, 8)
        nat = np.rint(f / q[None, None]).astype(np.int32).reshape(bh, bw, 64)
        coefs.append(nat[..., ZIGZAG])  # natural order → zigzag vectors
        comps.append({"id": ci + 1, "h": 1, "v": 1,
                      "tq": min(ci, len(qts) - 1),
                      "dc_tbl": min(ci, 1), "ac_tbl": min(ci, 1)})

    class _G:  # minimal geometry for the interleaved walk
        mcus_x, mcus_y = bw, bh

    dc_conds = {t: dc_cond for t in {c["dc_tbl"] for c in comps}}
    ac_conds = {t: ac_kx for t in {c["ac_tbl"] for c in comps}}
    entropy = encode_scan(coefs, comps, _G, dc_conds, ac_conds,
                          restart_interval)

    out = bytearray(b"\xff\xd8")
    for tq, q in enumerate(qts):
        zzq = q.reshape(64)[ZIGZAG].astype(np.uint8)
        out += struct.pack(">HHB", 0xFFDB, 67, tq) + zzq.tobytes()
    out += struct.pack(">HHBHHB", 0xFFC9, 8 + 3 * nc, 8, h, w, nc)
    for c in comps:
        out += bytes([c["id"], 0x11, c["tq"]])
    dac = bytearray()
    for t in sorted(dc_conds):
        dac += bytes([t, (dc_cond[1] << 4) | dc_cond[0]])
    for t in sorted(ac_conds):
        dac += bytes([0x10 | t, ac_kx])
    out += struct.pack(">HH", 0xFFCC, 2 + len(dac)) + dac
    if restart_interval:
        out += struct.pack(">HHH", 0xFFDD, 4, restart_interval)
    out += struct.pack(">HHB", 0xFFDA, 6 + 2 * nc, nc)
    for c in comps:
        out += bytes([c["id"], (c["dc_tbl"] << 4) | c["ac_tbl"]])
    out += bytes([0, 63, 0])
    out += entropy
    out += b"\xff\xd9"
    return bytes(out)
