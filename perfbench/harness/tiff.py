"""The benchmark's own baseline GeoTIFF codec: enough to write its inputs
(uint8 tiles, masks and scenes: uncompressed, pixel-interleaved strips,
north-up pixel scale and tie point, a projected EPSG code) and to read
back the uncompressed class maps the program writes. Classic little- or
big-endian TIFF; nothing else is accepted."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple

import numpy as np

_SHORT, _LONG, _DOUBLE = 3, 4, 12
_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 6: 1, 7: 1, 8: 2, 9: 4, 11: 4, 12: 8, 16: 8}
STRIP_BYTES = 256 * 1024


def write(path: Path, chw: np.ndarray, transform: Tuple[float, ...], epsg: int) -> None:
    """Write a (C, H, W) uint8 array: ``transform`` is GDAL's six numbers
    (north-up: no rotation)."""
    if chw.dtype != np.uint8 or chw.ndim != 3:
        raise ValueError(f"need a (C, H, W) uint8 array, got {chw.shape} {chw.dtype}")
    c, h, w = chw.shape
    hwc = np.ascontiguousarray(np.moveaxis(chw, 0, 2))
    rps = max(1, min(h, STRIP_BYTES // (w * c)))
    strips = [hwc[r:r + rps].tobytes() for r in range(0, h, rps)]
    ulx, xres, _, uly, _, yres = transform
    geokeys = [1, 1, 0, 3, 1024, 0, 1, 1, 1025, 0, 1, 1, 3072, 0, 1, epsg]
    entries = [  # (tag, type, values), written sorted by tag
        (256, _LONG, [w]), (257, _LONG, [h]), (258, _SHORT, [8] * c), (259, _SHORT, [1]),
        (262, _SHORT, [2 if c >= 3 else 1]), (273, _LONG, [0] * len(strips)),
        (277, _SHORT, [c]), (278, _LONG, [rps]), (279, _LONG, [len(s) for s in strips]),
        (284, _SHORT, [1]), (339, _SHORT, [1] * c),
        (33550, _DOUBLE, [abs(xres), abs(yres), 0.0]),
        (33922, _DOUBLE, [0.0, 0.0, 0.0, ulx, uly, 0.0]),
        (34735, _SHORT, geokeys),
    ]
    if c > 3:
        entries.append((338, _SHORT, [0] * (c - 3)))
    entries.sort()
    fmt = {_SHORT: "H", _LONG: "I", _DOUBLE: "d"}
    ifd_at = 8
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    extra = bytearray()
    placed = []
    for tag, typ, vals in entries:
        payload = struct.pack(f"<{len(vals)}{fmt[typ]}", *vals)
        if len(payload) <= 4:
            placed.append((tag, typ, len(vals), payload.ljust(4, b"\0"), None))
        else:
            placed.append((tag, typ, len(vals), None, extra_at + len(extra)))
            extra += payload
            extra += b"\0" * (len(extra) % 2)
    data_at = extra_at + len(extra)
    offsets, at = [], data_at
    for s in strips:
        offsets.append(at)
        at += len(s)
    out = bytearray(b"II*\0" + struct.pack("<I", ifd_at))
    out += struct.pack("<H", len(entries))
    for tag, typ, n, inline, where in placed:
        if tag == 273:  # the strip offsets, known now
            payload = struct.pack(f"<{n}I", *offsets)
            if inline is not None:
                inline = payload.ljust(4, b"\0")
            else:
                extra[where - extra_at:where - extra_at + len(payload)] = payload
        out += struct.pack("<HHI", tag, typ, n)
        out += inline if inline is not None else struct.pack("<I", where)
    out += struct.pack("<I", 0)
    out += extra
    with open(path, "wb") as f:
        f.write(out)
        for s in strips:
            f.write(s)


def read(path: Path) -> np.ndarray:
    """(C, H, W) of an uncompressed, pixel-interleaved, striped or tiled
    baseline TIFF of unsigned 8-bit samples. Raises ``ValueError`` on
    anything else."""
    data = Path(path).read_bytes()
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None or struct.unpack(order + "H", data[2:4])[0] != 42:
        raise ValueError(f"{path}: not a classic TIFF")
    (ifd,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[ifd:ifd + 2])
    fmt = {1: "B", 3: "H", 4: "I", 16: "Q"}
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack(order + "HHI4s", data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
        size = _SIZES.get(typ, 1) * count
        blob = raw if size <= 4 else data[struct.unpack(order + "I", raw)[0]:][:size]
        if typ in fmt:
            tags[tag] = list(struct.unpack(f"{order}{count}{fmt[typ]}", blob[:size]))
    w, h = tags[256][0], tags[257][0]
    c = tags.get(277, [1])[0]
    if tags.get(259, [1])[0] != 1 or set(tags.get(258, [8])) != {8} \
            or tags.get(339, [1])[0] != 1 or (c > 1 and tags.get(284, [1])[0] != 1):
        raise ValueError(f"{path}: not an uncompressed interleaved uint8 TIFF")
    out = np.empty((h, w, c), np.uint8)
    if 322 in tags:  # tiles
        tw, tl = tags[322][0], tags[323][0]
        across = -(-w // tw)
        for k, (off, cnt) in enumerate(zip(tags[324], tags[325])):
            ty, tx = divmod(k, across)
            tile = np.frombuffer(data, np.uint8, tl * tw * c, off).reshape(tl, tw, c)
            r1, c1 = min(h, (ty + 1) * tl), min(w, (tx + 1) * tw)
            out[ty * tl:r1, tx * tw:c1] = tile[:r1 - ty * tl, :c1 - tx * tw]
    else:
        rps = tags.get(278, [h])[0]
        for k, (off, cnt) in enumerate(zip(tags[273], tags[279])):
            rows = min(rps, h - k * rps)
            out[k * rps:k * rps + rows] = np.frombuffer(
                data, np.uint8, rows * w * c, off).reshape(rows, w, c)
    return np.moveaxis(out, 2, 0)
