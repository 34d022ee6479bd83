"""Dependency-free (Geo)TIFF codec.

The reference stack delegates raster I/O to libgdal/rasterio (C libraries;
see the reference utils.py:39-48, create_tiles_unet.py:208-249,
predict.py:19-52). Neither is available in this environment, so this module
implements the subset of TIFF 6.0 + BigTIFF + GeoTIFF that real aerial
imagery needs:

* classic TIFF **and BigTIFF**, little- **and big-endian**
* **strip- and tile-organized** pixel data (tags 322/323/324/325)
* dtypes: uint8, uint16, int16, int32, uint32, float32, float64
* multi-band, PlanarConfiguration 1 (chunky) and 2 (planar) on read,
  chunky on write
* Compression: 1 (none), 5 (**LZW**, read+write), 8/32946 (zlib/deflate),
  32773 (**PackBits**, read+write); horizontal predictor (2) for ints and
  floating-point predictor (3) for floats
* GeoTIFF georeferencing: ModelPixelScaleTag + ModelTiepointTag (33550/33922)
  or ModelTransformationTag (34264), GeoKeyDirectory (34735) with EPSG codes,
  GeoAsciiParams (34737), GDAL_NODATA (42113)
* new-style JPEG (compression 7): **reads** baseline sequential,
  progressive, lossless (SOF3) and arithmetic-coded (SOF9/SOF10)
  streams via the dependency-free codecs in ``geo/jpeg.py`` /
  ``geo/jpeg_arith.py`` (JPEGTables tag honored); **writes** GDAL's
  ``COMPRESS=JPEG`` orthophoto layout (``compress="jpeg"``, YCbCr
  photometric 6) and bit-exact Annex-H lossless
  (``compress="jpeg-lossless"``, uint8/uint16); unknown codecs fall
  back to PIL when available, otherwise the error names the feature

Geotransforms use the GDAL 6-tuple convention
``(ulx, xres, xrot, uly, yrot, yres)`` so tiling / mosaic math matches the
reference bit-for-bit (create_tiles_unet.py:289, predict.py:214).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import _epsg_data

# --- TIFF tag ids -----------------------------------------------------------
TAG_IMAGE_WIDTH = 256
TAG_IMAGE_LENGTH = 257
TAG_BITS_PER_SAMPLE = 258
TAG_COMPRESSION = 259
TAG_PHOTOMETRIC = 262
TAG_STRIP_OFFSETS = 273
TAG_SAMPLES_PER_PIXEL = 277
TAG_ROWS_PER_STRIP = 278
TAG_STRIP_BYTE_COUNTS = 279
TAG_PLANAR_CONFIG = 284
TAG_PREDICTOR = 317
TAG_TILE_WIDTH = 322
TAG_TILE_LENGTH = 323
TAG_TILE_OFFSETS = 324
TAG_TILE_BYTE_COUNTS = 325
TAG_NEW_SUBFILE_TYPE = 254
TAG_EXTRA_SAMPLES = 338
TAG_YCBCR_SUBSAMPLING = 530
TAG_SAMPLE_FORMAT = 339
TAG_MODEL_PIXEL_SCALE = 33550
TAG_MODEL_TIEPOINT = 33922
TAG_MODEL_TRANSFORMATION = 34264
TAG_GEO_KEY_DIRECTORY = 34735
TAG_GEO_DOUBLE_PARAMS = 34736
TAG_GEO_ASCII_PARAMS = 34737
TAG_JPEG_TABLES = 347
TAG_GDAL_METADATA = 42112
TAG_GDAL_NODATA = 42113

# --- TIFF field types -------------------------------------------------------
TYPE_BYTE = 1
TYPE_ASCII = 2
TYPE_SHORT = 3
TYPE_LONG = 4
TYPE_RATIONAL = 5
TYPE_SBYTE = 6
TYPE_UNDEFINED = 7
TYPE_SSHORT = 8
TYPE_SLONG = 9
TYPE_SRATIONAL = 10
TYPE_FLOAT = 11
TYPE_DOUBLE = 12
TYPE_LONG8 = 16
TYPE_SLONG8 = 17
TYPE_IFD8 = 18

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
              11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d",
             16: "Q", 17: "q", 18: "Q"}

# compression codes
COMP_NONE = 1
COMP_LZW = 5
COMP_JPEG = 7
COMP_DEFLATE = 8
COMP_DEFLATE_LEGACY = 32946
COMP_PACKBITS = 32773

_COMP_NAMES = {COMP_JPEG: "JPEG", 6: "old-style JPEG", 2: "CCITT RLE",
               3: "CCITT G3", 4: "CCITT G4", 34712: "JPEG2000",
               50000: "zstd", 50001: "webp", 34925: "LZMA"}

# GeoKey ids
GK_MODEL_TYPE = 1024
GK_RASTER_TYPE = 1025
GK_CITATION = 1026
GK_GEOGRAPHIC_TYPE = 2048
GK_GEOG_CITATION = 2049
GK_GEOG_ANGULAR_UNITS = 2054
GK_PROJECTED_CS_TYPE = 3072
GK_PCS_CITATION = 3073
GK_PROJ_LINEAR_UNITS = 3076
GK_USER_DEFINED = 32767  # sentinel value: "user-defined", not an EPSG code

# GeoTIFF model types (GTModelTypeGeoKey values)
MODEL_TYPE_PROJECTED = 1
MODEL_TYPE_GEOGRAPHIC = 2

# EPSG unit codes
UNIT_METRE = 9001
UNIT_DEGREE = 9102


class CRS(str):
    """A CRS label (``"EPSG:xxxx"`` or citation text) that also carries the
    complete GeoTIFF GeoKey set, so arbitrary — including non-EPSG,
    fully-parameterized — coordinate reference systems survive
    read → tile → train → predict → merge losslessly.

    Behaves as a plain ``str`` everywhere (equality, hashing, JSON); the
    writer recognises the attached ``geokeys`` mapping (GeoKey id →
    SHORT int | double | list-of-doubles | ascii str) and re-emits the full
    directory verbatim instead of synthesizing a minimal one. This is the
    TPU-native equivalent of the reference round-tripping full GDAL WKT via
    ``GetProjection()``/``SetProjection()`` (reference predict.py:29-52,
    create_tiles_unet.py:289).
    """

    def __new__(cls, label: str, geokeys: Optional[Dict[int, object]] = None):
        self = super().__new__(cls, label)
        self.geokeys = dict(geokeys or {})
        return self

    def __reduce__(self):  # keep geokeys across pickle/copy
        return (self.__class__, (str(self), self.geokeys))


def _epsg_is_geographic(code: int) -> bool:
    """Classify an EPSG code as geographic (2D/3D lat/lon) vs projected.

    Backed by the complete EPSG dataset baked from PROJ's database
    (``_epsg_data.py``, generated by tools/gen_epsg_data.py) — a block
    heuristic is NOT enough: the 4000-4999 "geographic" block contains
    projected CRS (4647 ETRS89/UTM32N zE-N, 4087/4088, 4839, the NAD27/BLM
    zones, ...) and modern geographic realizations live outside it
    (7844 GDA2020, 9755 WGS84 G2139, ...). Unknown codes (not horizontal
    CRS in EPSG v10) fall back to the block heuristic.
    """
    kind = _epsg_data.epsg_kind(code)
    if kind is not None:
        return kind == "geographic"
    return 4000 <= code <= 4999

# sample-format codes
SF_UINT = 1
SF_INT = 2
SF_FLOAT = 3

_DTYPE_TO_SF = {
    np.dtype(np.uint8): SF_UINT,
    np.dtype(np.uint16): SF_UINT,
    np.dtype(np.uint32): SF_UINT,
    np.dtype(np.int8): SF_INT,
    np.dtype(np.int16): SF_INT,
    np.dtype(np.int32): SF_INT,
    np.dtype(np.float32): SF_FLOAT,
    np.dtype(np.float64): SF_FLOAT,
}


def _sf_to_dtype(sample_format: int, bits: int) -> np.dtype:
    table = {
        (SF_UINT, 8): np.uint8,
        (SF_UINT, 16): np.uint16,
        (SF_UINT, 32): np.uint32,
        (SF_INT, 8): np.int8,
        (SF_INT, 16): np.int16,
        (SF_INT, 32): np.int32,
        (SF_FLOAT, 32): np.float32,
        (SF_FLOAT, 64): np.float64,
    }
    key = (sample_format, bits)
    if key not in table:
        raise ValueError(f"Unsupported TIFF sample format/bits: {key}")
    return np.dtype(table[key])


GeoTransform = Tuple[float, float, float, float, float, float]


@dataclass
class TiffInfo:
    """Parsed metadata of a single-IFD TIFF."""

    width: int
    height: int
    bands: int
    dtype: np.dtype
    transform: Optional[GeoTransform]
    crs: Optional[str]
    nodata: Optional[float]
    tags: Dict[int, object]


# --- LZW (TIFF variant: MSB-first bit packing, early code-width change) -----


def lzw_decode(data: bytes) -> bytes:
    """Decode TIFF LZW (compression 5)."""
    out = bytearray()
    table: List[bytes] = [bytes([i]) for i in range(256)] + [b"", b""]
    width = 9
    acc = 0
    accbits = 0
    pos = 0
    n = len(data)
    prev: Optional[bytes] = None
    while True:
        while accbits < width:
            if pos >= n:
                return bytes(out)
            acc = (acc << 8) | data[pos]
            pos += 1
            accbits += 8
        accbits -= width
        code = (acc >> accbits) & ((1 << width) - 1)
        acc &= (1 << accbits) - 1  # keep the accumulator a small int
        if code == 256:  # ClearCode
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            width = 9
            prev = None
            continue
        if code == 257:  # EndOfInformation
            return bytes(out)
        if prev is None:
            if code >= len(table):  # first code after clear must be known
                raise ValueError("Corrupt LZW stream (code beyond table)")
            entry = table[code]
        else:
            if code < len(table):
                entry = table[code]
            elif code == len(table):
                entry = prev + prev[:1]
            else:
                raise ValueError("Corrupt LZW stream (code beyond table)")
            table.append(prev + entry[:1])
        out += entry
        prev = entry
        # early change: width grows one code earlier than standard LZW
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1


def lzw_encode(data: bytes) -> bytes:
    """Encode TIFF LZW (compression 5). Cross-validated against PIL/libtiff.

    The dictionary is keyed by ``(prefix_code, next_byte)`` int pairs (not
    byte strings), keeping the encoder O(n) — byte-string keys degrade to
    O(n²) on runs, which made multi-megabyte LZW writes take minutes.
    """
    out = bytearray()
    acc = 0
    accbits = 0

    def emit(code: int, width: int):
        nonlocal acc, accbits
        acc = (acc << width) | code
        accbits += width
        while accbits >= 8:
            accbits -= 8
            out.append((acc >> accbits) & 0xFF)
        acc &= (1 << accbits) - 1  # keep the accumulator a small int

    table: Dict[Tuple[int, int], int] = {}
    next_code = 258
    width = 9
    emit(256, width)  # initial ClearCode
    if not data:
        emit(257, width)
        if accbits:
            out.append((acc << (8 - accbits)) & 0xFF)
        return bytes(out)
    get = table.get
    w = data[0]  # current prefix code (single bytes are codes 0-255)
    for b in data[1:]:
        code = get((w, b))
        if code is not None:
            w = code
            continue
        emit(w, width)
        table[(w, b)] = next_code
        next_code += 1
        # The decoder's table lags the encoder's by exactly one entry (it
        # appends on reading the NEXT code), and it widens at table size
        # (1<<width)-1 ("early change"); so the encoder widens at
        # next_code == (1<<width) — validated both ways against libtiff.
        if next_code >= 4094:
            emit(256, width)
            table = {}
            get = table.get
            next_code = 258
            width = 9
        elif next_code == (1 << width):
            width += 1
        w = b
    emit(w, width)
    emit(257, width)  # EOI
    if accbits:
        out.append((acc << (8 - accbits)) & 0xFF)
    return bytes(out)


# --- PackBits ----------------------------------------------------------------


def packbits_decode(data: bytes, expected: Optional[int] = None) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n and (expected is None or len(out) < expected):
        h = data[i]
        i += 1
        if h < 128:  # literal run of h+1 bytes
            out += data[i : i + h + 1]
            i += h + 1
        elif h > 128:  # repeat next byte 257-h times
            out += data[i : i + 1] * (257 - h)
            i += 1
        # h == 128: no-op
    return bytes(out)


def packbits_encode(data: bytes) -> bytes:
    out = bytearray()
    i = 0
    n = len(data)
    while i < n:
        # find a run
        j = i
        while j < n - 1 and data[j] == data[j + 1] and j - i < 127:
            j += 1
        if j > i:  # run of length j-i+1 (>=2)
            out.append(257 - (j - i + 1))
            out.append(data[i])
            i = j + 1
            continue
        # literal until the next run of >=3 (or 128 bytes)
        j = i
        while j < n and j - i < 128:
            if j < n - 2 and data[j] == data[j + 1] == data[j + 2]:
                break
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


# --- predictors ---------------------------------------------------------------


def _unpredict(arr: np.ndarray, predictor: int, dt: np.dtype) -> np.ndarray:
    """Undo TIFF predictor on a (rows, width, channels) segment array."""
    if predictor == 2:
        # horizontal differencing per sample channel; modular wrap on the
        # native integer dtype
        native = arr.astype(dt.newbyteorder("="), copy=False)
        return np.cumsum(native, axis=1, dtype=native.dtype)
    return arr


def _unpredict_float(raw: bytes, rows: int, width: int, channels: int,
                     dt: np.dtype) -> np.ndarray:
    """TIFF predictor 3 (floating point): per row, byte-delta decode then
    reassemble values from byte planes (MSB plane first)."""
    s = dt.itemsize
    nvals = width * channels
    b = np.frombuffer(raw, np.uint8, count=rows * nvals * s).reshape(rows, s * nvals)
    b = np.cumsum(b, axis=1, dtype=np.uint8)
    planes = b.reshape(rows, s, nvals)  # byte plane p = p-th significant byte
    be = np.ascontiguousarray(planes.transpose(0, 2, 1))  # rows, vals, bytes
    vals = np.frombuffer(be.tobytes(), dtype=dt.newbyteorder(">"))
    return vals.reshape(rows, width, channels).astype(dt.newbyteorder("="))


def _predict_float(seg: np.ndarray) -> bytes:
    """Inverse of :func:`_unpredict_float` for the writer. ``seg`` is
    (rows, width, channels) float."""
    rows = seg.shape[0]
    s = seg.dtype.itemsize
    be = np.ascontiguousarray(seg.astype(seg.dtype.newbyteorder(">")))
    b = np.frombuffer(be.tobytes(), np.uint8).reshape(rows, -1, s)
    planes = np.ascontiguousarray(b.transpose(0, 2, 1)).reshape(rows, -1)
    diff = planes.copy()
    diff[:, 1:] = planes[:, 1:] - planes[:, :-1]
    return diff.tobytes()


# --- IFD parsing ---------------------------------------------------------------


def read_info(path: str) -> TiffInfo:
    """Parse the first IFD of a TIFF without decoding pixel data.

    Uses bounded seek-based reads (header + IFD + out-of-line tag values
    only) — a 40 GB BigTIFF costs a few KB of I/O here."""
    with open(path, "rb") as f:
        return _parse_info_fh(f)


def _parse_info(data: bytes, ifd_index: int = 0) -> TiffInfo:
    import io

    return _parse_info_fh(io.BytesIO(data), ifd_index)


def _parse_info_fh(f, ifd_index: int = 0) -> TiffInfo:
    """Parse one IFD (the ``ifd_index``-th page of the chain; 0 = the main
    image, 1+ = overview/extra pages) from an open binary file handle with
    bounded reads: the header, the IFD entry block, and each out-of-line
    value are fetched by seek — never the whole file (the IFD may sit at
    EOF for streamed files; offsets are absolute so this costs nothing)."""

    def pread(off: int, n: int) -> bytes:
        f.seek(off)
        raw = f.read(n)
        if len(raw) < n:
            raise ValueError(
                f"Truncated TIFF: wanted {n} bytes at offset {off}, got {len(raw)}")
        return raw

    head = pread(0, 8)
    if head[:2] == b"II":
        bo = "<"
    elif head[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("Not a TIFF file")
    (magic,) = struct.unpack(bo + "H", head[2:4])
    if magic == 42:  # classic TIFF
        bigtiff = False
        (ifd_off,) = struct.unpack(bo + "I", head[4:8])
    elif magic == 43:  # BigTIFF
        bigtiff = True
        offsize, pad, ifd_off = struct.unpack(bo + "HHQ", pread(4, 12))
        if offsize != 8 or pad != 0:
            raise ValueError(f"Malformed BigTIFF header (offsize={offsize})")
    else:
        raise ValueError(f"Not a TIFF file (magic={magic})")

    def walk_next(off: int) -> int:
        """Next-IFD pointer of the page at ``off`` (0 = end of chain)."""
        if bigtiff:
            (n,) = struct.unpack(bo + "Q", pread(off, 8))
            (nxt,) = struct.unpack(bo + "Q", pread(off + 8 + n * 20, 8))
        else:
            (n,) = struct.unpack(bo + "H", pread(off, 2))
            (nxt,) = struct.unpack(bo + "I", pread(off + 2 + n * 12, 4))
        return nxt

    for _ in range(ifd_index):
        ifd_off = walk_next(ifd_off)
        if ifd_off == 0:
            raise ValueError(f"TIFF has no page #{ifd_index}")

    tags: Dict[int, object] = {}
    if bigtiff:
        (n_entries,) = struct.unpack(bo + "Q", pread(ifd_off, 8))
        entry_base, entry_size, count_fmt, inline = ifd_off + 8, 20, "Q", 8
    else:
        (n_entries,) = struct.unpack(bo + "H", pread(ifd_off, 2))
        entry_base, entry_size, count_fmt, inline = ifd_off + 2, 12, "I", 4
    entry_block = pread(entry_base, entry_size * n_entries)
    next_ifd = walk_next(ifd_off)

    for i in range(n_entries):
        off = entry_size * i
        tag, ftype = struct.unpack(bo + "HH", entry_block[off : off + 4])
        (count,) = struct.unpack(
            bo + count_fmt, entry_block[off + 4 : off + 4 + (8 if bigtiff else 4)])
        vpos = off + 4 + (8 if bigtiff else 4)
        size = _TYPE_SIZE.get(ftype, 1) * count
        if size <= inline:
            raw = entry_block[vpos : vpos + size]
        else:
            (voff,) = struct.unpack(
                bo + ("Q" if bigtiff else "I"), entry_block[vpos : vpos + inline])
            raw = pread(voff, size)
        if ftype == TYPE_ASCII:
            tags[tag] = raw.rstrip(b"\x00").decode("latin1")
        elif ftype in _TYPE_FMT:
            vals = struct.unpack(bo + _TYPE_FMT[ftype] * count, raw)
            tags[tag] = vals[0] if count == 1 else list(vals)
        elif ftype in (TYPE_RATIONAL, TYPE_SRATIONAL):
            sub = "II" if ftype == TYPE_RATIONAL else "ii"
            vals = struct.unpack(bo + sub * count, raw)
            ratios = [vals[2 * k] / max(vals[2 * k + 1], 1) for k in range(count)]
            tags[tag] = ratios[0] if count == 1 else ratios
        else:
            tags[tag] = raw

    width = int(tags[TAG_IMAGE_WIDTH])
    height = int(tags[TAG_IMAGE_LENGTH])
    spp = int(tags.get(TAG_SAMPLES_PER_PIXEL, 1))
    bits = tags.get(TAG_BITS_PER_SAMPLE, 8)
    if isinstance(bits, list):
        bits = bits[0]
    sf = tags.get(TAG_SAMPLE_FORMAT, SF_UINT)
    if isinstance(sf, list):
        sf = sf[0]
    dtype = _sf_to_dtype(int(sf), int(bits))

    nodata = None
    if TAG_GDAL_NODATA in tags:
        try:
            nodata = float(str(tags[TAG_GDAL_NODATA]).strip())
        except ValueError:
            nodata = None

    tags["_byteorder"] = bo
    tags["_bigtiff"] = bigtiff
    tags["_next_ifd"] = next_ifd
    return TiffInfo(
        width=width,
        height=height,
        bands=spp,
        dtype=dtype,
        transform=_transform_from_tags(tags),
        crs=_parse_geokeys(tags),
        nodata=nodata,
        tags=tags,
    )


def _parse_geokeys(tags: Dict[int, object]) -> Optional["CRS"]:
    """Parse the complete GeoKey set (SHORT / double / ascii params) into a
    :class:`CRS` — a str label ("EPSG:xxxx" or citation) carrying every key
    so the writer can re-emit the directory losslessly."""
    gkd = tags.get(TAG_GEO_KEY_DIRECTORY)
    if gkd is None:
        return None
    gkd = list(gkd) if isinstance(gkd, (list, tuple)) else [gkd]
    if len(gkd) < 4:
        return None
    ascii_params = tags.get(TAG_GEO_ASCII_PARAMS, "")
    doubles = tags.get(TAG_GEO_DOUBLE_PARAMS, [])
    if isinstance(doubles, (int, float)):
        doubles = [doubles]
    n_keys = int(gkd[3])
    keys: Dict[int, object] = {}
    for i in range(n_keys):
        ent = gkd[4 + 4 * i : 8 + 4 * i]
        if len(ent) < 4:
            break
        key_id, loc, count, value = (int(v) for v in ent)
        if loc == 0:
            keys[key_id] = value
        elif loc == TAG_GEO_ASCII_PARAMS:
            keys[key_id] = str(ascii_params)[value : value + count].rstrip("|\x00")
        elif loc == TAG_GEO_DOUBLE_PARAMS:
            vals = [float(v) for v in doubles[value : value + count]]
            keys[key_id] = vals[0] if len(vals) == 1 else vals
        elif loc == TAG_GEO_KEY_DIRECTORY:
            # SHORT arrays stored in the tail of the directory itself
            vals = [int(v) for v in gkd[value : value + count]]
            keys[key_id] = vals[0] if len(vals) == 1 else vals
    if not keys:
        return None

    def _epsg_label(key_id: int) -> Optional[str]:
        v = keys.get(key_id)
        if isinstance(v, int) and 0 < v < GK_USER_DEFINED:
            return f"EPSG:{v}"
        return None

    label = (
        _epsg_label(GK_PROJECTED_CS_TYPE)
        or _epsg_label(GK_GEOGRAPHIC_TYPE)
        or next((str(keys[k]) for k in (GK_CITATION, GK_PCS_CITATION, GK_GEOG_CITATION)
                 if isinstance(keys.get(k), str) and keys[k]), None)
        or "user-defined"
    )
    return CRS(label, keys)


def _transform_from_tags(tags: Dict[int, object]) -> Optional[GeoTransform]:
    mt = tags.get(TAG_MODEL_TRANSFORMATION)
    if mt is not None:
        t = list(mt)
        return (t[3], t[0], t[1], t[7], t[4], t[5])
    scale = tags.get(TAG_MODEL_PIXEL_SCALE)
    tie = tags.get(TAG_MODEL_TIEPOINT)
    if scale is None or tie is None:
        return None
    sx, sy = float(scale[0]), float(scale[1])
    i, j, _k, x, y, _z = [float(v) for v in tie[:6]]
    # Tiepoint: raster (i, j) maps to model (x, y); y axis points down.
    return (x - i * sx, sx, 0.0, y + j * sy, 0.0, -sy)


# --- segment decoding -----------------------------------------------------------


def _native_codecs():
    """The C++ codec module, or None (pure-Python fallback)."""
    from .. import native

    return native if native.available() else None


def _decompress(chunk: bytes, compression: int, expected: Optional[int] = None) -> bytes:
    if compression == COMP_NONE:
        return chunk
    if compression in (COMP_DEFLATE, COMP_DEFLATE_LEGACY):
        try:
            if expected is not None:  # cap output: no decompression bombs
                return zlib.decompressobj().decompress(chunk, expected)
            return zlib.decompress(chunk)
        except zlib.error as e:
            raise ValueError(f"Corrupt TIFF: bad deflate stream ({e})") from e
    if compression == COMP_LZW:
        nat = _native_codecs() if expected else None
        if nat is not None:
            out = nat.lzw_decode(chunk, expected)
            if out is not None:
                return out
        return lzw_decode(chunk)
    if compression == COMP_PACKBITS:
        nat = _native_codecs() if expected else None
        if nat is not None:
            out = nat.packbits_decode(chunk, expected)
            if out is not None:
                return out
        return packbits_decode(chunk, expected)
    name = _COMP_NAMES.get(compression, str(compression))
    raise ValueError(f"Unsupported TIFF compression: {name} (code {compression})")


def _as_list(v) -> List[int]:
    return list(v) if isinstance(v, list) else [v]


def _pil_fallback_read(path: str, info: TiffInfo, reason: str) -> np.ndarray:
    """Decode via PIL/libtiff for features outside the pure codec (e.g.
    JPEG-in-TIFF). Returns (C, H, W)."""
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{reason}; PIL fallback unavailable in this environment"
        ) from None
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = np.moveaxis(arr, 2, 0)
    return np.ascontiguousarray(arr)


def read(path: str) -> Tuple[np.ndarray, TiffInfo]:
    """Read a TIFF into a channels-first ``(C, H, W)`` numpy array.

    Mirrors rasterio's ``open(path).read()`` layout used throughout the
    reference (create_tiles_unet.py:282, data.py:20). Handles strip- and
    tile-organized files, classic and BigTIFF, both byte orders, and
    none/deflate/LZW/PackBits/JPEG compression — the formats real aerial
    orthophotos come in.

    Malformed files raise ValueError — never IndexError/struct.error/
    MemoryError: semantic checks (segment bounds vs file size, dimension
    plausibility vs codec expansion limits) plus a top-level trap, the
    contract libgdal/libtiff meet. Fuzz-pinned in
    tests/test_fuzz_parsers.py.
    """
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _read_impl(data, path)
    except ValueError:
        raise
    except (struct.error, IndexError, KeyError, OverflowError,
            MemoryError, TypeError) as e:
        raise ValueError(f"Corrupt TIFF: {type(e).__name__}: {e}") from e


def read_overview(path: str, level: int) -> Tuple[np.ndarray, TiffInfo]:
    """Read overview page ``level`` (0 = first reduced-resolution IFD —
    the pages ``write(overviews=[...])`` / gdaladdo append) as (C, H, W).
    Same malformed-input contract as :func:`read`."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _read_impl(data, path, ifd_index=level + 1)
    except ValueError:
        raise
    except (struct.error, IndexError, KeyError, OverflowError,
            MemoryError, TypeError) as e:
        raise ValueError(f"Corrupt TIFF: {type(e).__name__}: {e}") from e


def list_overviews(path: str) -> List[Tuple[int, int]]:
    """(height, width) of each overview page, in chain order — empty for
    single-page files. Bounded reads (header + IFD blocks only)."""
    out: List[Tuple[int, int]] = []
    with open(path, "rb") as f:
        k = 1
        while k <= 64:  # also bounds corrupt cyclic IFD chains
            try:
                info = _parse_info_fh(f, ifd_index=k)
            except (ValueError, struct.error, IndexError, KeyError,
                    OverflowError, MemoryError, TypeError):
                break
            out.append((info.height, info.width))
            k += 1
    return out


def _read_impl(data: bytes, path: str,
               ifd_index: int = 0) -> Tuple[np.ndarray, TiffInfo]:
    info = _parse_info(data, ifd_index)
    tags = info.tags
    bo = tags["_byteorder"]

    compression = int(tags.get(TAG_COMPRESSION, 1))
    predictor = int(tags.get(TAG_PREDICTOR, 1))
    planar = int(tags.get(TAG_PLANAR_CONFIG, 1))
    h, w, c = info.height, info.width, info.bands
    dt = info.dtype.newbyteorder(bo)
    native = info.dtype.newbyteorder("=")

    # a corrupted IFD can declare dimensions whose decode allocation is
    # astronomically larger than any codec could expand this file to
    # (deflate's hard ceiling is 1032:1; LZW/PackBits/JPEG are lower)
    decoded = int(h) * int(w) * int(c) * dt.itemsize
    if decoded > max(16 << 20, 4096 * len(data)):
        raise ValueError(
            f"Corrupt TIFF: implausible dimensions {c}x{h}x{w} "
            f"({decoded} decoded bytes from a {len(data)}-byte file)")

    try:
        if TAG_TILE_OFFSETS in tags:
            chw = _read_tiled(data, tags, info, compression, predictor, dt, planar)
        else:
            chw = _read_striped(data, tags, info, compression, predictor, dt, planar)
    except ValueError as e:
        # unknown codecs / JPEG features beyond the in-repo decoders fall
        # back to PIL if importable; data CORRUPTION errors don't (they
        # would just fail again, less clearly)
        if str(e).startswith("Unsupported"):
            try:
                return _pil_fallback_read(path, info, str(e)), info
            except ValueError:
                raise
            except Exception as pe:  # PIL's own OSError zoo on bad data
                raise ValueError(
                    f"{e} (PIL fallback also failed: {pe})") from e
        raise
    return np.ascontiguousarray(chw.astype(native, copy=False)), info


def _decode_segment(raw: bytes, rows: int, width: int, channels: int,
                    predictor: int, dt: np.dtype) -> np.ndarray:
    """Bytes of one strip/tile (chunky within the segment) → (rows, width,
    channels) in native byte order."""
    if predictor == 3:
        return _unpredict_float(raw, rows, width, channels, dt)
    arr = np.frombuffer(raw, dtype=dt, count=rows * width * channels)
    arr = arr.reshape(rows, width, channels)
    return _unpredict(arr, predictor, dt)


def _decode_chunk(chunk: bytes, compression: int, rows: int, width: int,
                  channels: int, predictor: int, dt: np.dtype,
                  tags: Dict[int, object]) -> np.ndarray:
    """Decompress + decode one strip/tile. New-style JPEG (compression 7)
    decodes through the dependency-free baseline decoder (geo/jpeg.py) —
    each segment is a JPEG stream, shared tables ride the JPEGTables tag
    (347), and PhotometricInterpretation decides the YCbCr transform (the
    reference gets this from libgdal→libjpeg, utils.py:39-48)."""
    if compression == COMP_JPEG:
        tables = tags.get(TAG_JPEG_TABLES)
        tb = bytes(tables) if isinstance(tables, (bytes, bytearray)) else None
        photometric = int(tags.get(TAG_PHOTOMETRIC, 1))
        ct = (photometric == 6) if photometric in (2, 6) else None
        from .. import native as native_mod

        arr = native_mod.jpeg_decode(bytes(chunk), tables=tb,
                                     color_transform=ct)
        if arr is None:  # no native library / a stream it does not take
            from . import jpeg as jpeg_codec

            arr = jpeg_codec.decode(bytes(chunk), tables=tb,
                                    color_transform=ct)
        if arr.shape[2] < channels:
            raise ValueError(
                f"JPEG segment has {arr.shape[2]} components, expected {channels}")
        return arr[:rows, :width, :channels].astype(dt.newbyteorder("="))
    itemsize = dt.itemsize
    raw = _decompress(chunk, compression, rows * width * channels * itemsize)
    return _decode_segment(raw, rows, width, channels, predictor, dt)


def _check_segments(offsets, counts, file_size: int) -> None:
    """Every strip/tile byte range must lie inside the file — corrupt
    offset/count fields otherwise turn into absurd slices downstream."""
    for o, c in zip(offsets, counts):
        if o < 0 or c < 0 or o + c > file_size:
            raise ValueError(
                f"Corrupt TIFF: segment [{o}, {o}+{c}) extends past the "
                f"{file_size}-byte end of file")


def _read_striped(data, tags, info, compression, predictor, dt, planar) -> np.ndarray:
    offsets = _as_list(tags[TAG_STRIP_OFFSETS])
    counts = _as_list(tags[TAG_STRIP_BYTE_COUNTS])
    _check_segments(offsets, counts, len(data))
    h, w, c = info.height, info.width, info.bands
    rps = int(tags.get(TAG_ROWS_PER_STRIP, h))
    strips_per_plane = (h + rps - 1) // rps
    itemsize = dt.itemsize

    def strip(plane_idx: int, s: int, channels: int) -> np.ndarray:
        rows = min(rps, h - s * rps)
        i = plane_idx * strips_per_plane + s
        return _decode_chunk(data[offsets[i] : offsets[i] + counts[i]],
                             compression, rows, w, channels, predictor, dt, tags)

    if planar == 1:
        hwc = np.concatenate([strip(0, s, c) for s in range(strips_per_plane)], axis=0)
        return np.moveaxis(hwc, 2, 0)
    bands = []
    for b in range(c):
        rows = np.concatenate([strip(b, s, 1) for s in range(strips_per_plane)], axis=0)
        bands.append(rows[:, :, 0])
    return np.stack(bands, axis=0)


def _read_tiled(data, tags, info, compression, predictor, dt, planar) -> np.ndarray:
    offsets = _as_list(tags[TAG_TILE_OFFSETS])
    counts = _as_list(tags[TAG_TILE_BYTE_COUNTS])
    _check_segments(offsets, counts, len(data))
    h, w, c = info.height, info.width, info.bands
    tl = int(tags[TAG_TILE_LENGTH])
    tw = int(tags[TAG_TILE_WIDTH])
    tiles_down = (h + tl - 1) // tl
    tiles_across = (w + tw - 1) // tw
    per_plane = tiles_down * tiles_across
    itemsize = dt.itemsize

    def decode_plane(plane_idx: int, channels: int) -> np.ndarray:
        canvas = np.zeros((tiles_down * tl, tiles_across * tw, channels),
                          dt.newbyteorder("="))
        for ty in range(tiles_down):
            for tx in range(tiles_across):
                i = plane_idx * per_plane + ty * tiles_across + tx
                seg = _decode_chunk(data[offsets[i] : offsets[i] + counts[i]],
                                    compression, tl, tw, channels, predictor,
                                    dt, tags)
                canvas[ty * tl : (ty + 1) * tl, tx * tw : (tx + 1) * tw] = seg
        return canvas[:h, :w]

    if planar == 1:
        return np.moveaxis(decode_plane(0, c), 2, 0)
    return np.stack([decode_plane(b, 1)[:, :, 0] for b in range(c)], axis=0)


# --- writer ------------------------------------------------------------------


def _common_entries(
    dtype: np.dtype, c: int, h: int, w: int, comp_code: int,
    use_pred2: bool, use_pred3: bool,
    transform: Optional[GeoTransform], crs: Optional[str],
    nodata: Optional[float], photometric: int = 1,
) -> List[Tuple[int, int, Sequence]]:
    """The segment-independent IFD entries shared by ``write`` and
    ``StripStreamWriter`` (format, geo tags, nodata)."""
    entries: List[Tuple[int, int, Sequence]] = []
    entries.append((TAG_IMAGE_WIDTH, TYPE_LONG, [w]))
    entries.append((TAG_IMAGE_LENGTH, TYPE_LONG, [h]))
    entries.append((TAG_BITS_PER_SAMPLE, TYPE_SHORT, [dtype.itemsize * 8] * c))
    entries.append((TAG_COMPRESSION, TYPE_SHORT, [comp_code]))
    entries.append((TAG_PHOTOMETRIC, TYPE_SHORT, [photometric]))
    if photometric == 6:  # YCbCr-in-JPEG: chroma grids are unsubsampled
        entries.append((TAG_YCBCR_SUBSAMPLING, TYPE_SHORT, [1, 1]))
    entries.append((TAG_SAMPLES_PER_PIXEL, TYPE_SHORT, [c]))
    entries.append((TAG_PLANAR_CONFIG, TYPE_SHORT, [1]))
    if use_pred2 or use_pred3:
        entries.append((TAG_PREDICTOR, TYPE_SHORT, [2 if use_pred2 else 3]))
    n_color = 3 if photometric in (2, 6) else 1  # samples the model implies
    if c > n_color:
        entries.append((TAG_EXTRA_SAMPLES, TYPE_SHORT, [0] * (c - n_color)))
    entries.append((TAG_SAMPLE_FORMAT, TYPE_SHORT, [_DTYPE_TO_SF[dtype]] * c))

    if transform is not None:
        ulx, xres, xrot, uly, yrot, yres = [float(v) for v in transform]
        if xrot == 0.0 and yrot == 0.0:
            entries.append((TAG_MODEL_PIXEL_SCALE, TYPE_DOUBLE, [abs(xres), abs(yres), 0.0]))
            entries.append((TAG_MODEL_TIEPOINT, TYPE_DOUBLE, [0.0, 0.0, 0.0, ulx, uly, 0.0]))
        else:
            mt = [xres, xrot, 0.0, ulx, yrot, yres, 0.0, uly, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]
            entries.append((TAG_MODEL_TRANSFORMATION, TYPE_DOUBLE, mt))

    geo_ascii = ""
    geo_doubles: List[float] = []
    geo_short_tail: List[int] = []  # multi-valued SHORT keys, stored in the
    # tail of the GeoKeyDirectory itself (loc=34735); offsets patched below.
    geokeys: List[Tuple[int, int, int, int]] = []

    def _add_key(kid: int, val: object) -> None:
        nonlocal geo_ascii
        if isinstance(val, str):
            s = val if val.endswith("|") else val + "|"
            geokeys.append((kid, TAG_GEO_ASCII_PARAMS, len(s), len(geo_ascii)))
            geo_ascii += s
        elif isinstance(val, (list, tuple)) and val and all(
            isinstance(v, int) and 0 <= v <= 0xFFFF for v in val
        ):
            # Multi-valued SHORT key: keep its defined SHORT storage type on
            # round-trip (re-emitting as doubles would change the key type).
            # value_offset is in SHORTs from the start of the directory array;
            # the header+entries length isn't known yet, so stash a tail
            # index and patch when assembling.
            geokeys.append((kid, TAG_GEO_KEY_DIRECTORY, len(val), -1 - len(geo_short_tail)))
            geo_short_tail.extend(int(v) for v in val)
        elif isinstance(val, float) or isinstance(val, (list, tuple)):
            vals = [float(v) for v in (val if isinstance(val, (list, tuple)) else [val])]
            geokeys.append((kid, TAG_GEO_DOUBLE_PARAMS, len(vals), len(geo_doubles)))
            geo_doubles.extend(vals)
        else:
            geokeys.append((kid, 0, 1, int(val)))

    if crs is not None:
        full_keys = getattr(crs, "geokeys", None)
        epsg = _epsg_code(crs)
        if full_keys:
            # Lossless re-emission of a parsed GeoKey set (CRS round-trip,
            # incl. non-EPSG parameterized CRS — datum/ellipsoid/projection
            # parameter keys survive intact). Reference equivalent: GDAL
            # SetProjection(WKT) in predict.py:29-52.
            for kid in sorted(full_keys):
                _add_key(kid, full_keys[kid])
        elif epsg is not None:
            # Synthesize a spec-conformant minimal key set from the EPSG
            # code. Geographic codes (e.g. 4326) MUST go in
            # GeographicTypeGeoKey with GTModelType=Geographic; projected
            # codes in ProjectedCSTypeGeoKey with GTModelType=Projected.
            if _epsg_is_geographic(epsg):
                _add_key(GK_MODEL_TYPE, MODEL_TYPE_GEOGRAPHIC)
                _add_key(GK_RASTER_TYPE, 1)
                _add_key(GK_GEOGRAPHIC_TYPE, epsg)
                _add_key(GK_GEOG_CITATION, f"EPSG:{epsg}")
                # The CRS's actual EPSG angular unit (degree for all but a
                # handful — e.g. the NTF-Paris family is in grads).
                _add_key(GK_GEOG_ANGULAR_UNITS, _epsg_data.geographic_angular_unit(epsg))
            else:
                _add_key(GK_MODEL_TYPE, MODEL_TYPE_PROJECTED)
                _add_key(GK_RASTER_TYPE, 1)
                _add_key(GK_PROJECTED_CS_TYPE, epsg)
                _add_key(GK_CITATION, f"EPSG:{epsg}")
                # Actual EPSG linear unit (metre for most; ftUS for the
                # NAD27/83 BLM & state-plane-foot families, etc.).
                _add_key(GK_PROJ_LINEAR_UNITS, _epsg_data.projected_linear_unit(epsg))
        else:
            # Free-text CRS: model type is unknowable → user-defined + citation.
            _add_key(GK_MODEL_TYPE, GK_USER_DEFINED)
            _add_key(GK_RASTER_TYPE, 1)
            _add_key(GK_CITATION, str(crs))
    if geokeys:
        gkd = [1, 1, 0, len(geokeys)]
        tail_base = 4 + 4 * len(geokeys)  # SHORT offset of the tail region
        for kid, loc, count, value in sorted(geokeys):
            if loc == TAG_GEO_KEY_DIRECTORY:
                value = tail_base + (-1 - value)  # patch stashed tail index
            gkd.extend((kid, loc, count, value))
        gkd.extend(geo_short_tail)
        entries.append((TAG_GEO_KEY_DIRECTORY, TYPE_SHORT, gkd))
        if geo_doubles:
            entries.append((TAG_GEO_DOUBLE_PARAMS, TYPE_DOUBLE, geo_doubles))
        if geo_ascii:
            entries.append((TAG_GEO_ASCII_PARAMS, TYPE_ASCII, [geo_ascii]))
    if nodata is not None:
        nd = float(nodata)
        nd_str = str(int(nd)) if nd == int(nd) else repr(nd)
        entries.append((TAG_GDAL_NODATA, TYPE_ASCII, [nd_str]))
    return entries


def _epsg_code(crs: Optional[str]) -> Optional[int]:
    if crs is None:
        return None
    s = str(crs).strip().upper()
    if s.startswith("EPSG:"):
        try:
            return int(s.split(":", 1)[1])
        except ValueError:
            return None
    return None


def _apply_predictor(hwc: np.ndarray) -> np.ndarray:
    out = hwc.copy()
    out[:, 1:, :] = hwc[:, 1:, :] - hwc[:, :-1, :]
    return out


def _lzw_encode_fast(b: bytes) -> bytes:
    nat = _native_codecs()
    if nat is not None:
        out = nat.lzw_encode(b)
        if out is not None:
            return out
    return lzw_encode(b)


def _packbits_encode_fast(b: bytes) -> bytes:
    nat = _native_codecs()
    if nat is not None:
        out = nat.packbits_encode(b)
        if out is not None:
            return out
    return packbits_encode(b)


_WRITE_COMPRESSORS = {
    None: (COMP_NONE, lambda b: b),
    "deflate": (COMP_DEFLATE, lambda b: zlib.compress(b, 6)),
    "zlib": (COMP_DEFLATE, lambda b: zlib.compress(b, 6)),
    "lzw": (COMP_LZW, _lzw_encode_fast),
    "packbits": (COMP_PACKBITS, _packbits_encode_fast),
}


def write(
    path: str,
    array: np.ndarray,
    transform: Optional[GeoTransform] = None,
    crs: Optional[str] = None,
    nodata: Optional[float] = None,
    compress: Optional[str] = None,
    rows_per_strip: Optional[int] = None,
    predictor: bool = False,
    tile: Optional[Tuple[int, int]] = None,
    bigtiff: bool = False,
    byteorder: str = "<",
    quality: int = 90,
    overviews: Optional[Sequence[int]] = None,
    overview_resampling: str = "average",
) -> None:
    """Write a ``(C, H, W)`` or ``(H, W)`` array as a (Geo)TIFF.

    Equivalent surface to the reference's GDAL write paths
    (create_tiles_unet.py:208-249, predict.py:19-52): georeferencing via the
    GDAL 6-tuple ``transform``, CRS via ``crs`` (``"EPSG:xxxx"`` or free
    text), per-band nodata via ``nodata``. Beyond GDAL parity: ``tile``
    writes tile-organized files, ``bigtiff`` selects the 8-byte-offset
    container, ``byteorder`` ``"<"``/``">"``, ``compress`` in
    none/deflate/lzw/packbits/jpeg/jpeg-lossless.

    ``compress="jpeg"`` is GDAL's ``COMPRESS=JPEG`` orthophoto layout:
    new-style JPEG (compression 7) strips/tiles at the given ``quality``,
    uint8 only, 1 or 3 bands (3-band data is written as photometric-6
    YCbCr, unsubsampled so any strip height stays conformant).
    ``compress="jpeg-lossless"`` writes bit-exact T.81 Annex-H (SOF3)
    segments — the legacy >8-bit aerial layout — for 1-4 band
    uint8/uint16 data. Both are self-contained per segment (no
    JPEGTables), which every libtiff/GDAL reader accepts.

    ``overviews=[2, 4, 8]`` appends reduced-resolution pages
    (NewSubfileType=1 IFDs chained after the full image — what
    ``gdaladdo`` / the COG driver produce), each downsampled by the
    given integer factor with ``overview_resampling`` ``"average"``
    (imagery) or ``"nearest"`` (class maps), sharing the main image's
    compression/tiling. Read them back with :func:`read_overview` /
    :func:`list_overviews`; plain :func:`read` still returns the full
    resolution, and single-page readers are unaffected (the chain rides
    the next-IFD pointer).
    """
    arr = np.asarray(array)
    if arr.ndim == 2:
        arr = arr[None]
    if arr.ndim != 3:
        raise ValueError(f"Expected (C,H,W) or (H,W) array, got shape {array.shape}")
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    if arr.dtype == np.float16 or arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        arr = arr.astype(np.float32)
    if arr.dtype not in _DTYPE_TO_SF:
        raise ValueError(f"Unsupported dtype for TIFF write: {arr.dtype}")
    if byteorder not in ("<", ">"):
        raise ValueError(f"byteorder must be '<' or '>', got {byteorder!r}")
    c, h, w = arr.shape
    jpeg_mode = compress if compress in ("jpeg", "jpeg-lossless") else None
    photometric = 1
    if jpeg_mode:
        if predictor:
            raise ValueError("predictor does not apply to JPEG compression")
        if jpeg_mode == "jpeg":
            if arr.dtype != np.uint8:
                raise ValueError("compress='jpeg' requires uint8 data")
            if c not in (1, 3):
                raise ValueError("compress='jpeg' requires 1 or 3 bands, "
                                 f"got {c}")
            photometric = 6 if c == 3 else 1
        else:
            if arr.dtype not in (np.dtype(np.uint8), np.dtype(np.uint16)):
                raise ValueError("compress='jpeg-lossless' requires uint8 "
                                 "or uint16 data")
            if not 1 <= c <= 4:
                raise ValueError("compress='jpeg-lossless' requires 1-4 "
                                 f"bands, got {c}")
        comp_code = COMP_JPEG
        if jpeg_mode == "jpeg-lossless" and c >= 3 and arr.dtype == np.uint8:
            photometric = 2  # raw RGB samples (no color transform)
    elif compress not in _WRITE_COMPRESSORS:
        raise ValueError(
            f"Unsupported compression {compress!r}; options: deflate, lzw, "
            "packbits, jpeg, jpeg-lossless"
        )
    else:
        comp_code, compress_fn = _WRITE_COMPRESSORS[compress]
        if c >= 3 and arr.dtype == np.uint8:
            # GDAL-style RGB interpretation for >=3-band byte imagery;
            # bands 4+ become unspecified extra samples. Pure metadata for
            # our reader, but PIL/libtiff need a known photometric/sample
            # combination to map a pixel mode at all
            photometric = 2
    hwc = np.ascontiguousarray(np.moveaxis(arr, 0, 2)).astype(
        arr.dtype.newbyteorder(byteorder))

    use_pred2 = predictor and arr.dtype.kind in "iu"
    use_pred3 = predictor and arr.dtype.kind == "f"

    def encode_segment(seg: np.ndarray) -> bytes:
        if jpeg_mode:
            from . import jpeg as jpeg_codec

            pix = seg.astype(seg.dtype.newbyteorder("="))
            if jpeg_mode == "jpeg":
                return jpeg_codec.encode_baseline(pix, quality=quality)
            # predictor 7 ((Ra+Rb)/2): best average ratio on smooth
            # aerial content among the seven Annex-H predictors
            return jpeg_codec.encode_lossless(pix, predictor=7)
        if use_pred2:
            seg = _apply_predictor(seg)
            payload = seg.tobytes()
        elif use_pred3:
            payload = _predict_float(seg.astype(arr.dtype.newbyteorder("=")))
        else:
            payload = seg.tobytes()
        return compress_fn(payload)

    def build_image(level_hwc: np.ndarray, reduced: bool):
        """(entries, segments, (off_tag, cnt_tag)) for one IFD at one
        resolution level — strips or tiles via ``encode_segment``."""
        lh, lw = level_hwc.shape[:2]
        entries: List[Tuple[int, int, Sequence]] = []  # (tag, type, values)
        segments: List[bytes] = []
        if tile is not None:
            tl, tw_ = int(tile[0]), int(tile[1])
            if tl % 16 or tw_ % 16:
                raise ValueError(
                    f"TIFF tile dims must be multiples of 16, got {tile}")
            tiles_down = (lh + tl - 1) // tl
            tiles_across = (lw + tw_ - 1) // tw_
            padded = np.zeros((tiles_down * tl, tiles_across * tw_, c),
                              level_hwc.dtype)
            padded[:lh, :lw] = level_hwc
            for ty in range(tiles_down):
                for tx in range(tiles_across):
                    seg = padded[ty * tl : (ty + 1) * tl,
                                 tx * tw_ : (tx + 1) * tw_]
                    segments.append(encode_segment(np.ascontiguousarray(seg)))
            entries.append((TAG_TILE_WIDTH, TYPE_LONG, [tw_]))
            entries.append((TAG_TILE_LENGTH, TYPE_LONG, [tl]))
            off_cnt = (TAG_TILE_OFFSETS, TAG_TILE_BYTE_COUNTS)
        else:
            rps = rows_per_strip
            if rps is None:
                # target ~256 KiB strips for streaming-friendly output
                row_bytes = max(1, lw * c * arr.dtype.itemsize)
                rps = max(1, min(lh, (256 * 1024) // row_bytes))
            n_strips = (lh + rps - 1) // rps
            for s in range(n_strips):
                segments.append(encode_segment(
                    level_hwc[s * rps : (s + 1) * rps]))
            entries.append((TAG_ROWS_PER_STRIP, TYPE_LONG, [rps]))
            off_cnt = (TAG_STRIP_OFFSETS, TAG_STRIP_BYTE_COUNTS)
        if reduced:  # overview page: no geo tags, flagged reduced-resolution
            entries.append((TAG_NEW_SUBFILE_TYPE, TYPE_LONG, [1]))
            entries.extend(_common_entries(arr.dtype, c, lh, lw, comp_code,
                                           use_pred2, use_pred3, None, None,
                                           nodata, photometric=photometric))
        else:
            entries.extend(_common_entries(arr.dtype, c, lh, lw, comp_code,
                                           use_pred2, use_pred3, transform,
                                           crs, nodata,
                                           photometric=photometric))
        return entries, segments, off_cnt

    levels = [hwc]
    for f_ in (overviews or []):
        f_ = int(f_)
        if f_ < 2:
            raise ValueError(f"Overview factors must be >= 2, got {f_}")
        if overview_resampling == "nearest":
            lv = hwc[::f_, ::f_]
        elif overview_resampling == "average":
            ph, pw = -(-h // f_) * f_, -(-w // f_) * f_
            p = np.pad(hwc, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge")
            m = (p.reshape(ph // f_, f_, pw // f_, f_, c)
                 .astype(np.float64).mean(axis=(1, 3)))
            lv = (np.rint(m) if arr.dtype.kind in "iu" else m).astype(hwc.dtype)
        else:
            raise ValueError(
                f"Unknown overview_resampling {overview_resampling!r}; "
                "options: average, nearest")
        levels.append(np.ascontiguousarray(lv))

    images = [build_image(lv, i > 0) for i, lv in enumerate(levels)]

    all_counts = [len(p) for _, segs, _ in images for p in segs]
    if (not bigtiff and sum(all_counts) + 4096 * len(images)
            + 16 * len(all_counts) > 0xFFFFFFFF):
        bigtiff = True  # classic TIFF offsets are 32-bit; auto-upgrade
    offset_type = TYPE_LONG8 if bigtiff else TYPE_LONG

    bo = byteorder
    if bigtiff:
        header_size, entry_size, count_fmt, inline, next_fmt = 16, 20, "Q", 8, "Q"
    else:
        header_size, entry_size, count_fmt, inline, next_fmt = 8, 12, "I", 4, "I"

    def encode_values(ftype: int, values: Sequence) -> bytes:
        if ftype == TYPE_ASCII:
            return values[0].encode("latin1") + b"\x00"
        fmt = _TYPE_FMT[ftype]
        return struct.pack(bo + fmt * len(values), *values)

    # finalize per-image entry lists (byte counts + offset placeholders)
    finals = []
    for entries, segments, (off_tag, cnt_tag) in images:
        e = list(entries)
        e.append((cnt_tag, offset_type, [len(p) for p in segments]))
        e.append((off_tag, offset_type, [0] * len(segments)))  # pass 2
        e.sort(key=lambda t: t[0])
        finals.append((e, segments, off_tag))

    # pass 1: block sizes (value encodings are position-independent), so
    # the layout is header | IFD0+overflow0 | IFD1+overflow1 | … | data
    ifd_bases: List[int] = []
    blocks_meta: List[Tuple[int, int]] = []
    pos = header_size
    for e, _segs, _ in finals:
        ifd_size = ((8 if bigtiff else 2) + len(e) * entry_size
                    + struct.calcsize(next_fmt))
        overflow_len = 0
        for _tag, ftype, values in e:
            raw_len = len(encode_values(ftype, values))
            if raw_len > inline:
                overflow_len += raw_len + (raw_len & 1)
        ifd_bases.append(pos)
        blocks_meta.append((ifd_size, overflow_len))
        pos += ifd_size + overflow_len
    data_off = pos

    # pass 2: emit with real positions; IFDs chain via the next pointer
    out = bytearray()
    magic_bytes = b"II" if bo == "<" else b"MM"
    if bigtiff:
        out += struct.pack(bo + "2sHHHQ", magic_bytes, 43, 8, 0, header_size)
    else:
        out += struct.pack(bo + "2sHI", magic_bytes, 42, header_size)
    seg_cursor = data_off
    for idx, (e, segments, off_tag) in enumerate(finals):
        ifd_size, _overflow_len = blocks_meta[idx]
        overflow_off = ifd_bases[idx] + ifd_size
        seg_offsets = []
        for p in segments:
            seg_offsets.append(seg_cursor)
            seg_cursor += len(p)
        overflow = bytearray()
        entry_block = bytearray()
        for tag, ftype, values in e:
            if tag == off_tag:
                values = seg_offsets
            raw = encode_values(ftype, values)
            count = len(values[0]) + 1 if ftype == TYPE_ASCII else len(values)
            entry_block += struct.pack(bo + "HH" + count_fmt, tag, ftype, count)
            if len(raw) <= inline:
                entry_block += raw.ljust(inline, b"\x00")
            else:
                vpos = overflow_off + len(overflow)
                entry_block += struct.pack(bo + ("Q" if bigtiff else "I"), vpos)
                overflow += raw
                if len(raw) & 1:
                    overflow += b"\x00"
        next_ifd = ifd_bases[idx + 1] if idx + 1 < len(finals) else 0
        out += struct.pack(bo + ("Q" if bigtiff else "H"), len(e))
        out += entry_block
        out += struct.pack(bo + next_fmt, next_ifd)
        out += overflow
    for _e, segments, _ in finals:
        for p in segments:
            out += p

    with open(path, "wb") as f:
        f.write(bytes(out))


# --- windowed access / streaming ---------------------------------------------


class _CountingFile:
    """Thin wrapper recording bytes actually read — the O(band) memory claim
    of the streamed path is asserted against this in tests."""

    def __init__(self, f):
        self._f = f
        self.bytes_read = 0

    def seek(self, *a):
        return self._f.seek(*a)

    def read(self, n: int = -1) -> bytes:
        raw = self._f.read(n)
        self.bytes_read += len(raw)
        return raw

    def close(self):
        self._f.close()


def read_window(path: str, row0: int, row1: int,
                col0: int = 0, col1: Optional[int] = None,
                _cache: Optional[dict] = None) -> Tuple[np.ndarray, TiffInfo]:
    """Decode only the strips/tiles intersecting ``[row0:row1, col0:col1)``.

    Returns ``((C, row1-row0, col1-col0), info)``. This is the L0 primitive
    behind streamed whole-scene prediction: a multi-gigapixel orthophoto is
    consumed band-by-band without a full-scene decode (the reference reads
    entire scenes into RAM — create_tiles_unet.py:282). I/O is strictly
    windowed: the header+IFD are parsed with bounded seeks and only the
    strip/tile byte ranges a window touches are fetched (``pread`` style) —
    the file is never slurped, so a 40 GB BigTIFF costs O(window) RAM.

    Pass a dict as ``_cache`` to reuse the open file handle + parsed tags +
    decoded segments across calls; ``cache['f'].bytes_read`` counts I/O and
    :func:`evict_decoded_rows` bounds the decoded-segment memory for
    top-down consumers.
    """
    try:
        return _read_window_impl(path, row0, row1, col0, col1, _cache)
    except ValueError:
        raise
    except (struct.error, IndexError, KeyError, OverflowError,
            MemoryError, TypeError) as e:
        # same malformed-input contract as read(); fuzz-pinned
        raise ValueError(f"Corrupt TIFF: {type(e).__name__}: {e}") from e


def _read_window_impl(path: str, row0: int, row1: int,
                      col0: int, col1: Optional[int],
                      _cache: Optional[dict]) -> Tuple[np.ndarray, TiffInfo]:
    cache = _cache if _cache is not None else {}
    if "info" not in cache:
        cache["f"] = _CountingFile(open(path, "rb"))
        cache["info"] = _parse_info_fh(cache["f"])
    info = cache["info"]
    fh = cache["f"]

    def fetch(offset: int, count: int) -> bytes:
        fh.seek(offset)
        return fh.read(count)

    tags = info.tags
    bo = tags["_byteorder"]
    compression = int(tags.get(TAG_COMPRESSION, 1))
    predictor = int(tags.get(TAG_PREDICTOR, 1))
    planar = int(tags.get(TAG_PLANAR_CONFIG, 1))
    h, w, c = info.height, info.width, info.bands
    dt = info.dtype.newbyteorder(bo)
    native = info.dtype.newbyteorder("=")
    row0 = max(0, int(row0)); row1 = min(h, int(row1))
    col0 = max(0, int(col0)); col1 = w if col1 is None else min(w, int(col1))
    if row1 <= row0 or col1 <= col0:
        return np.zeros((c, 0, 0), native), info
    itemsize = dt.itemsize
    seg_cache = cache.setdefault("segs", {})

    if TAG_TILE_OFFSETS in tags:
        offsets = _as_list(tags[TAG_TILE_OFFSETS])
        counts = _as_list(tags[TAG_TILE_BYTE_COUNTS])
        tl = int(tags[TAG_TILE_LENGTH]); tw = int(tags[TAG_TILE_WIDTH])
        tiles_down = (h + tl - 1) // tl
        tiles_across = (w + tw - 1) // tw
        per_plane = tiles_down * tiles_across
        out = np.zeros((row1 - row0, col1 - col0, c), native)

        def fill_plane(plane_idx: int, channels: int, dst_c0: int):
            for ty in range(row0 // tl, (row1 - 1) // tl + 1):
                for tx in range(col0 // tw, (col1 - 1) // tw + 1):
                    i = plane_idx * per_plane + ty * tiles_across + tx
                    seg = seg_cache.get(i)
                    if seg is None:
                        seg = _decode_chunk(fetch(offsets[i], counts[i]),
                                            compression, tl, tw, channels,
                                            predictor, dt, tags)
                        seg_cache[i] = seg
                    ry0, ry1 = max(row0, ty * tl), min(row1, (ty + 1) * tl)
                    rx0, rx1 = max(col0, tx * tw), min(col1, (tx + 1) * tw)
                    out[ry0 - row0: ry1 - row0, rx0 - col0: rx1 - col0,
                        dst_c0: dst_c0 + channels] = \
                        seg[ry0 - ty * tl: ry1 - ty * tl, rx0 - tx * tw: rx1 - tx * tw]

        if planar == 1:
            fill_plane(0, c, 0)
        else:
            for b in range(c):
                fill_plane(b, 1, b)
        return np.moveaxis(out, 2, 0), info

    offsets = _as_list(tags[TAG_STRIP_OFFSETS])
    counts = _as_list(tags[TAG_STRIP_BYTE_COUNTS])
    rps = int(tags.get(TAG_ROWS_PER_STRIP, h))
    strips_per_plane = (h + rps - 1) // rps
    out = np.zeros((row1 - row0, col1 - col0, c), native)

    def fill_strips(plane_idx: int, channels: int, dst_c0: int):
        for s in range(row0 // rps, (row1 - 1) // rps + 1):
            rows = min(rps, h - s * rps)
            i = plane_idx * strips_per_plane + s
            seg = seg_cache.get(i)
            if seg is None:
                seg = _decode_chunk(fetch(offsets[i], counts[i]),
                                    compression, rows, w, channels,
                                    predictor, dt, tags)
                seg_cache[i] = seg
            ry0, ry1 = max(row0, s * rps), min(row1, s * rps + rows)
            out[ry0 - row0: ry1 - row0, :, dst_c0: dst_c0 + channels] = \
                seg[ry0 - s * rps: ry1 - s * rps, col0:col1]

    if planar == 1:
        fill_strips(0, c, 0)
    else:
        for b in range(c):
            fill_strips(b, 1, b)
    return np.moveaxis(out, 2, 0), info


def evict_decoded_rows(cache: dict, before_row: int) -> None:
    """Drop decoded segments from a :func:`read_window` cache that lie
    entirely above ``before_row``.

    Organization-aware: segment-cache keys are global segment indices, so
    strip keys map to rows via RowsPerStrip while tile keys map via
    TileLength and the tiles-across grid; planar-separate files repeat the
    per-plane layout at a plane offset. Top-down consumers (streamed
    whole-scene prediction) call this as their front advances to keep the
    decoded cache O(band) instead of accumulating the whole scene.
    """
    segs = cache.get("segs")
    info = cache.get("info")
    if not segs or info is None:
        return
    tags = info.tags
    h = info.height
    if TAG_TILE_OFFSETS in tags:
        tl = int(tags[TAG_TILE_LENGTH])
        tw = int(tags[TAG_TILE_WIDTH])
        tiles_across = (info.width + tw - 1) // tw
        tiles_down = (h + tl - 1) // tl
        per_plane = tiles_down * tiles_across

        def row_end(i: int) -> int:
            return min(((i % per_plane) // tiles_across + 1) * tl, h)
    else:
        rps = int(tags.get(TAG_ROWS_PER_STRIP, h))
        per_plane = (h + rps - 1) // rps

        def row_end(i: int) -> int:
            return min(((i % per_plane) + 1) * rps, h)

    for k in [k for k in segs if row_end(k) <= before_row]:
        del segs[k]


def _needs_bigtiff(data_end: int, counts: Sequence[int]) -> bool:
    """True when classic TIFF's 32-bit offsets/counts can no longer address
    the file: the IFD sits after ``data_end`` bytes of pixel data, plus
    generous slack for the IFD block and out-of-line value arrays. Called at
    ``StripStreamWriter.close()`` so a >4 GiB streamed mosaic auto-upgrades
    to BigTIFF instead of raising struct.error AFTER all compute."""
    ifd_slack = 4096 + 16 * len(counts)
    return (data_end + ifd_slack > 0xFFFFFFFF) or \
        (max(counts, default=0) > 0xFFFFFFFF)


class StripStreamWriter:
    """Write a (Geo)TIFF strip-by-strip without materializing the array.

    Rows arrive top-down via ``append_rows((C, r, W))``; pixel data streams
    to disk immediately and the IFD is written at ``close()`` (after the
    data — readers follow the header's IFD pointer, which is patched last).
    This is the output half of streamed whole-scene prediction: mosaics
    larger than RAM are finalized and written band-by-band.
    """

    def __init__(self, path: str, height: int, width: int, bands: int,
                 dtype, transform: Optional[GeoTransform] = None,
                 crs: Optional[str] = None, nodata: Optional[float] = None,
                 compress: Optional[str] = None,
                 rows_per_strip: Optional[int] = None,
                 bigtiff: bool = False, quality: int = 90):
        self.h, self.w, self.c = int(height), int(width), int(bands)
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPE_TO_SF:
            raise ValueError(f"Unsupported dtype for TIFF write: {self.dtype}")
        self._jpeg_mode = compress if compress in ("jpeg",
                                                   "jpeg-lossless") else None
        self._quality = quality
        self.photometric = 1
        if self._jpeg_mode == "jpeg":
            if self.dtype != np.uint8 or self.c not in (1, 3):
                raise ValueError("compress='jpeg' streams require uint8 "
                                 "data with 1 or 3 bands")
            self.photometric = 6 if self.c == 3 else 1
            self.comp_code, self._compress_fn = COMP_JPEG, None
        elif self._jpeg_mode == "jpeg-lossless":
            if (self.dtype not in (np.dtype(np.uint8), np.dtype(np.uint16))
                    or not 1 <= self.c <= 4):
                raise ValueError("compress='jpeg-lossless' streams require "
                                 "1-4 bands of uint8/uint16 data")
            self.comp_code, self._compress_fn = COMP_JPEG, None
        elif compress not in _WRITE_COMPRESSORS:
            raise ValueError(
                f"Unsupported compression {compress!r}; options: deflate, "
                "lzw, packbits, jpeg, jpeg-lossless")
        else:
            self.comp_code, self._compress_fn = _WRITE_COMPRESSORS[compress]
            if self.c >= 3 and self.dtype == np.uint8:
                self.photometric = 2  # GDAL-style RGB for byte imagery
        self.transform, self.crs, self.nodata = transform, crs, nodata
        # ``bigtiff=True`` forces the 8-byte-offset container; with the
        # default False the container is chosen at close(), when the actual
        # offsets are known: a streamed mosaic whose data exceeds 4 GiB
        # (e.g. all_classes float32 output of a multi-gigapixel scene) would
        # otherwise fail at close() AFTER all compute, with no IFD written.
        # A 16-byte prelude is reserved either way (classic header + 8 pad
        # bytes, or the BigTIFF header) so the decision is free.
        self.bigtiff = bool(bigtiff)
        row_bytes = max(1, self.w * self.c * self.dtype.itemsize)
        self.rps = int(rows_per_strip or max(1, min(self.h, (1 << 20) // row_bytes)))
        self._f = open(path, "wb")
        self._bo = "<"
        self._f.write(b"\x00" * 16)  # header patched at close()
        self._offsets: List[int] = []
        self._counts: List[int] = []
        self._pending = np.zeros((0, self.w, self.c), self.dtype)
        self._rows_done = 0
        self._closed = False

    def append_rows(self, arr: np.ndarray) -> None:
        arr = np.asarray(arr)
        if arr.ndim == 2:
            arr = arr[None]
        if arr.shape[0] == self.c and arr.shape[2] == self.w:
            arr = np.moveaxis(arr, 0, 2)  # (rows, W, C)
        if arr.shape[1] != self.w or arr.shape[2] != self.c:
            raise ValueError(f"append_rows shape {arr.shape} != (r, {self.w}, {self.c})")
        self._pending = np.concatenate(
            [self._pending, arr.astype(self.dtype, copy=False)], axis=0)
        self._rows_done += arr.shape[0]
        if self._rows_done > self.h:
            raise ValueError("more rows appended than declared height")
        flush_full = self._rows_done >= self.h
        while self._pending.shape[0] >= self.rps or (
                flush_full and self._pending.shape[0] > 0):
            seg = self._pending[: self.rps]
            self._pending = self._pending[self.rps:]
            if self._jpeg_mode:
                from . import jpeg as jpeg_codec

                pix = np.ascontiguousarray(seg)
                payload = (jpeg_codec.encode_baseline(pix, self._quality)
                           if self._jpeg_mode == "jpeg"
                           else jpeg_codec.encode_lossless(pix, predictor=7))
            else:
                payload = self._compress_fn(
                    np.ascontiguousarray(seg).tobytes())
            self._offsets.append(self._f.tell())
            self._counts.append(len(payload))
            self._f.write(payload)

    def close(self) -> None:
        if self._closed:
            return
        if self._rows_done != self.h:
            self._f.close()
            raise ValueError(
                f"StripStreamWriter closed after {self._rows_done}/{self.h} rows")
        # decide the container now that every offset is known
        data_end = self._f.tell()
        bigtiff = self.bigtiff or _needs_bigtiff(data_end, self._counts)
        self.bigtiff = bigtiff
        entries = _common_entries(self.dtype, self.c, self.h, self.w,
                                  self.comp_code, False, False,
                                  self.transform, self.crs, self.nodata,
                                  photometric=self.photometric)
        entries.append((TAG_ROWS_PER_STRIP, TYPE_LONG, [self.rps]))
        offset_type = TYPE_LONG8 if bigtiff else TYPE_LONG
        entries.append((TAG_STRIP_BYTE_COUNTS, offset_type, self._counts))
        entries.append((TAG_STRIP_OFFSETS, offset_type, self._offsets))
        entries.sort(key=lambda e: e[0])
        bo = self._bo
        if bigtiff:
            entry_size, count_fmt, inline, next_fmt = 20, "Q", 8, "Q"
        else:
            entry_size, count_fmt, inline, next_fmt = 12, "I", 4, "I"
        pos = data_end
        if pos & 1:
            self._f.write(b"\x00")
            pos += 1
        ifd_off = pos
        n_tags = len(entries)
        ifd_size = (8 if bigtiff else 2) + n_tags * entry_size + struct.calcsize(next_fmt)
        overflow_off = ifd_off + ifd_size
        overflow: List[bytes] = []
        out = bytearray()
        out += struct.pack(bo + ("Q" if self.bigtiff else "H"), n_tags)
        for tag, ftype, values in entries:
            if ftype == TYPE_ASCII:
                raw = values[0].encode("latin1") + b"\x00"
                count = len(raw)
            else:
                raw = struct.pack(bo + _TYPE_FMT[ftype] * len(values), *values)
                count = len(values)
            if len(raw) <= inline:
                inline_bytes = raw.ljust(inline, b"\x00")
            else:
                p = overflow_off + sum(len(o) + (len(o) & 1) for o in overflow)
                overflow.append(raw)
                inline_bytes = struct.pack(bo + ("Q" if self.bigtiff else "I"), p)
            out += struct.pack(bo + "HH" + count_fmt, tag, ftype, count) + inline_bytes
        out += struct.pack(bo + next_fmt, 0)
        for o in overflow:
            out += o
            if len(o) & 1:
                out += b"\x00"
        self._f.write(bytes(out))
        self._f.seek(0)
        if bigtiff:
            self._f.write(struct.pack(bo + "2sHHHQ", b"II", 43, 8, 0, ifd_off))
        else:
            # bytes 8..16 of the prelude stay zero — legal padding before
            # the first strip; readers follow the header's IFD pointer
            self._f.write(struct.pack(bo + "2sHI", b"II", 42, ifd_off))
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if not self._closed:
            if exc[0] is None:
                self.close()
            else:
                self._f.close()
