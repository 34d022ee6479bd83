"""PyTorch port: its copy of the native tile decoder against the port's
Python codec and against ``unet_tpu.native`` on the same files, the codec
hooks of its TIFF reader and writer, and the loader's two decode paths."""

import numpy as np
import pytest

from unet_tpu import native as jax_native
from unet_tpu_torch import native
from unet_tpu_torch.data.dataset import TileDataset
from unet_tpu_torch.data.loader import TileLoader
from unet_tpu_torch.geo import tiff, write_raster

T = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)


@pytest.fixture
def python_only(monkeypatch):
    """The port's TIFF codec with every native hook off (the pure-Python
    path the hooks fall back to)."""
    monkeypatch.setattr(native, "available", lambda: False)


def _array(rng, dtype, shape):
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(0, min(np.iinfo(dtype).max, 30000), size=shape).astype(dtype)


def _python_read(path, monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        return tiff.read(str(path))[0]


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int16, np.float32])
def test_batch_decode_matches_python_codec_and_jax(tmp_path, rng, monkeypatch, dtype):
    paths, arrays = [], []
    for i in range(5):
        a = _array(rng, dtype, (4, 40, 48))
        write_raster(tmp_path / f"t{i}.tif", a, transform=T)
        paths.append(tmp_path / f"t{i}.tif")
        arrays.append(a)
    raw = native.decode_batch_raw(paths, 40, 48, 4, dtype)
    f32 = native.decode_batch(paths, 40, 48, 4)
    assert raw.dtype == dtype and f32.dtype == np.float32
    np.testing.assert_array_equal(raw, jax_native.decode_batch_raw(paths, 40, 48, 4, dtype))
    for i, (p, a) in enumerate(zip(paths, arrays)):
        np.testing.assert_array_equal(np.moveaxis(raw[i], 2, 0), _python_read(p, monkeypatch))
        np.testing.assert_array_equal(np.moveaxis(raw[i], 2, 0), a)
        np.testing.assert_array_equal(f32[i], np.moveaxis(a, 0, 2).astype(np.float32))


CONTAINERS = [
    {"compress": "lzw"},
    {"compress": "lzw", "tile": (32, 32)},
    {"compress": "packbits"},
    {"compress": "packbits", "tile": (16, 16)},
    {"compress": "deflate", "predictor": True},
    {"compress": "deflate", "tile": (16, 16), "bigtiff": True},
    {"bigtiff": True, "rows_per_strip": 7},
    {"byteorder": ">"},
    {"byteorder": ">", "compress": "lzw", "predictor": True},
]


@pytest.mark.parametrize("kw", CONTAINERS)
def test_containers_and_codecs(tmp_path, rng, monkeypatch, kw):
    """Strips and tiles, BigTIFF, big-endian, LZW / PackBits / deflate with
    predictor: native batch decode == the port's Python codec with and
    without its native hooks == ``unet_tpu.native``."""
    a = rng.integers(0, 50000, size=(3, 70, 45)).astype(np.uint16)
    p = tmp_path / "c.tif"
    tiff.write(str(p), a, transform=T, **kw)
    raw = native.decode_batch_raw([p], 70, 45, 3, np.uint16)[0]
    np.testing.assert_array_equal(np.moveaxis(raw, 2, 0), a)
    np.testing.assert_array_equal(tiff.read(str(p))[0], a)
    np.testing.assert_array_equal(_python_read(p, monkeypatch), a)
    np.testing.assert_array_equal(raw, jax_native.decode_batch_raw([p], 70, 45, 3, np.uint16)[0])


def _jpeg_scene(h=64, w=80, seed=6):
    yy, xx = np.mgrid[0:h, 0:w]
    rng = np.random.default_rng(seed)
    img = np.stack([120 + 80 * np.sin(yy / 7.0 + c) * np.cos(xx / 11.0) for c in range(3)])
    return np.clip(img + rng.normal(0, 4, img.shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kw", [{}, {"tile": (32, 32)}])
def test_jpeg_tiles(tmp_path, monkeypatch, kw):
    """JPEG-in-TIFF: the native batch decode == the port's TIFF reader (whose
    JPEG segments also decode natively, as the JAX package's do) ==
    ``unet_tpu.native``; the pure-Python JPEG decoder is within 2 levels
    (the float IDCT's rounding, as tests/test_jpeg.py holds the two)."""
    a = _jpeg_scene()
    p = tmp_path / "j.tif"
    tiff.write(str(p), a, transform=T, compress="jpeg", quality=90, **kw)
    raw = native.decode_batch_raw([p], 64, 80, 3, np.uint8)[0]
    np.testing.assert_array_equal(np.moveaxis(raw, 2, 0), tiff.read(str(p))[0])
    np.testing.assert_array_equal(raw, jax_native.decode_batch_raw([p], 64, 80, 3, np.uint8)[0])
    pure = _python_read(p, monkeypatch).astype(np.int16)
    assert np.abs(np.moveaxis(raw, 2, 0).astype(np.int16) - pure).max() <= 2


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
def test_masks_decode_like_load_pair(tmp_path, rng, dtype):
    paths, arrays = [], []
    for i in range(3):
        a = (rng.integers(0, 5, size=(40, 48)) + (0.25 if dtype == np.float32 else 0)).astype(dtype)
        write_raster(tmp_path / f"m{i}.tif", a, transform=T)
        paths.append(tmp_path / f"m{i}.tif")
        arrays.append(a)
    masks = native.decode_masks(paths, 40, 48)
    assert masks.dtype == np.int32
    np.testing.assert_array_equal(masks, np.stack(arrays).astype(np.int32))
    np.testing.assert_array_equal(masks, jax_native.decode_masks(paths, 40, 48))


PAYLOADS = [
    b"",
    b"TOBEORNOTTOBEORTOBEORNOT" * 50,
    bytes(np.random.default_rng(0).integers(0, 256, 20000, dtype=np.uint8)),
    bytes(np.random.default_rng(1).integers(0, 3, 120000, dtype=np.uint8)),  # table resets
]


@pytest.mark.parametrize("data", PAYLOADS, ids=["empty", "text", "random", "lowentropy"])
def test_codec_primitives_round_trip(data):
    enc = native.lzw_encode(data)
    assert native.lzw_decode(enc, len(data)) == data
    assert tiff.lzw_decode(enc) == data
    assert native.lzw_decode(tiff.lzw_encode(data), len(data)) == data
    assert enc == jax_native.lzw_encode(data)
    pb = native.packbits_encode(data)
    assert native.packbits_decode(pb, len(data)) == data
    assert tiff.packbits_decode(pb, len(data)) == data
    assert pb == jax_native.packbits_encode(data)


def test_writer_hooks_fall_back_to_python(tmp_path, rng, python_only):
    """Without the library the writer's LZW/PackBits encoders and the reader
    take the Python codec, and the files still read back exactly."""
    a = rng.integers(0, 255, size=(3, 33, 21)).astype(np.uint8)
    for compress in ("lzw", "packbits"):
        p = tmp_path / f"{compress}.tif"
        tiff.write(str(p), a, compress=compress)
        assert native.lzw_decode(b"", 0) is None and native.jpeg_decode(b"") is None
        np.testing.assert_array_equal(tiff.read(str(p))[0], a)


def test_missing_file_and_shape_mismatch_raise(tmp_path, rng):
    a = rng.integers(0, 255, size=(4, 40, 48)).astype(np.uint8)
    write_raster(tmp_path / "a.tif", a, transform=T)
    with pytest.raises(RuntimeError, match="failed on tile 1"):
        native.decode_batch([tmp_path / "a.tif", tmp_path / "nope.tif"], 40, 48, 4)
    with pytest.raises(RuntimeError, match="failed on tile 0"):
        native.decode_batch_raw([tmp_path / "a.tif"], 99, 99, 4, np.uint8)


def test_failed_build_raises_and_is_kept(tmp_path, monkeypatch):
    """A build that fails raises with g++'s message; available() is then
    False and build_error() keeps the message; nothing retries the build."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-fno-such-option"])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building"):
        native.get_lib()
    assert not native.available()
    assert "unrecognized command-line option" in native.build_error()
    assert list(tmp_path.iterdir()) == []  # no half-written library left


def test_library_name_follows_sources_flags_and_cpu(monkeypatch):
    base = native.library_path()
    assert base.parent == native.BUILD_DIR and base.name.startswith("libunet_native-")
    monkeypatch.setattr(native, "_cpu_features", lambda: "another cpu")
    assert native.library_path() != base
    monkeypatch.undo()
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ["-g"])
    assert native.library_path() != base


def _tile_set(root, rng, img_dtype, mask_dtype, n=6, h=24, w=32):
    for split in ("trai", "vali"):
        (root / split / "img_tiles").mkdir(parents=True)
        (root / split / "mask_tiles").mkdir(parents=True)
        for i in range(n):
            img = _array(rng, img_dtype, (3, h, w))
            msk = rng.integers(0, 3, size=(h, w)).astype(mask_dtype)
            write_raster(root / split / "img_tiles" / f"t{i}.tif", img, transform=T,
                         compress="lzw")
            write_raster(root / split / "mask_tiles" / f"t{i}.tif", msk, transform=T)
    return TileDataset(root)


@pytest.mark.parametrize("img_dtype,mask_dtype", [(np.uint8, np.uint8),
                                                  (np.uint16, np.float32),
                                                  (np.float32, np.int16)])
def test_loader_paths_give_identical_batches(tmp_path, rng, img_dtype, mask_dtype):
    """Both decode paths give the same NCHW arrays, dtypes included (float
    class masks become int32 either way), padded last batch too; iterating
    records the chosen path and the first batch's time each way."""
    ds = _tile_set(tmp_path, rng, img_dtype, mask_dtype)
    ld = TileLoader(ds, ds.valid_files, batch_size=4)
    try:
        for paths in (ds.valid_files[:4], ds.valid_files[4:]):
            ni, nm, nv = ld.make_batch_native(paths)
            pi, pm, pv = ld.make_batch_python(paths)
            assert ni.shape == (4, 3, 24, 32) and ni.flags.c_contiguous and nv == pv
            assert ni.dtype == pi.dtype == img_dtype and nm.dtype == pm.dtype
            np.testing.assert_array_equal(ni, pi)
            np.testing.assert_array_equal(nm, pm)
        assert ld.path is None
        batches = list(ld)
        assert ld.path in ("native", "python")
        assert all(isinstance(v, float) and v > 0 for v in ld.first_batch_ms.values())
        np.testing.assert_array_equal(batches[1][0], pi)
        assert [b[2] for b in batches] == [4, 2]
    finally:
        ld.close()


def test_loader_without_the_library_takes_python(tmp_path, rng, python_only):
    ds = _tile_set(tmp_path, rng, np.uint8, np.uint8, n=4)
    ld = TileLoader(ds, ds.train_files, batch_size=2, shuffle=True, drop_last=True)
    try:
        batches = list(ld)
        assert ld.path == "python"
        assert ld.first_batch_ms == {"native": None, "python": None}
        assert len(batches) == 2 and batches[0][0].shape == (2, 3, 24, 32)
        with pytest.raises(RuntimeError, match="unavailable"):
            ld.make_batch_native(ds.train_files[:2])
    finally:
        ld.close()
