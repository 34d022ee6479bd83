"""PyTorch port, whole-scene serving at any size, on the CPU against the JAX
package: the TIFF helpers of the streamed path (``read_window``,
``evict_decoded_rows``, ``StripStreamWriter``; the cases of
``tests/test_streaming.py``, each file also read by JAX's codec), the
on-device finalize against numpy's, the band against a whole mosaic, and
``predict_raster``'s three tiers and ``predict_raster_streamed`` on the
bundle and scene of ``tests/test_torch_serve.py``.

Tolerances: paths of the port that share the banded core batch the same
windows the same way and are equal bit for bit. The whole-scene tier adds
a pixel's windows in another order (``generate_windows``' x-major order
against the core's (y, x) order), so its float32 averages may differ in
the last bit: probabilities within ``rtol=1e-6``, as JAX's own
``tests/test_streaming.py`` holds its tiers, and class maps equal except
where the two largest averaged probabilities lie within 1e-5. Against
JAX's float32 model the port's probabilities differ by up to ~1.5e-5 (the
two frameworks' convolutions): within 1e-4, as ``tests/test_torch_serve.py``
holds them; on JAX's own probabilities the port's streamed path writes
JAX's file bit for bit.
"""

import struct

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_serve import BATCH, CRS, H, N_OUT, PATCH, TRANSFORM, W, served  # noqa: F401
from unet_tpu.geo import tiff as jax_tiff
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.predict import predict as jax_predict
from unet_tpu.predict.merge import finalize_mosaic as jax_finalize
from unet_tpu_torch import geo
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import read_raster, tiff
from unet_tpu_torch.ops import blend as tblend
from unet_tpu_torch.predict import merge as tmerge
from unet_tpu_torch.predict import predict as tp
from unet_tpu_torch.tiling.windows import generate_windows

torch.set_num_threads(2)
MODES = [{}, {"all_classes": True}, {"specific_class": 1}, {"regression": True}]


def _scene(h=100, w=130, c=3, dtype=np.uint8, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return rng.random((c, h, w)).astype(dtype)
    return rng.integers(0, np.iinfo(dtype).max, (c, h, w)).astype(dtype)


# --- the TIFF helpers --------------------------------------------------------


@pytest.mark.parametrize("dtype,kw", [
    (np.uint8, dict()),
    (np.uint8, dict(compress="deflate")),
    (np.uint8, dict(compress="lzw")),
    (np.uint8, dict(compress="packbits")),
    (np.uint8, dict(rows_per_strip=7)),
    (np.uint8, dict(tile=(16, 16))),
    (np.uint8, dict(tile=(32, 16), compress="deflate")),
    (np.uint8, dict(bigtiff=True, rows_per_strip=11)),
    (np.uint8, dict(byteorder=">")),
    (np.float32, dict(compress="deflate", predictor=True, rows_per_strip=13)),
])
def test_read_window_matches_full_read_slices(tmp_path, dtype, kw):
    """Windows of a file the port writes equal JAX's full read, sliced, and
    JAX's own ``read_window``."""
    arr = _scene(dtype=dtype)
    p = str(tmp_path / "s.tif")
    tiff.write(p, arr, transform=(0, 1, 0, 0, 0, -1), **kw)
    full, _ = jax_tiff.read(p)
    np.testing.assert_array_equal(full, arr)
    cache = {}
    for (r0, r1, c0, c1) in [(0, 10, 0, None), (13, 57, 20, 77), (90, 100, 0, None),
                             (0, 100, 0, 130), (42, 43, 129, 130), (20, 61, 5, 99)]:
        win, _ = tiff.read_window(p, r0, r1, c0, c1, _cache=cache)
        np.testing.assert_array_equal(win, full[:, r0:r1, c0:(c1 if c1 is not None else 130)])
        np.testing.assert_array_equal(win, jax_tiff.read_window(p, r0, r1, c0, c1)[0])
    cache["f"].close()


def test_read_window_clamps_out_of_range(tmp_path):
    p = str(tmp_path / "s.tif")
    tiff.write(p, _scene())
    win, _ = tiff.read_window(p, 95, 200)
    assert win.shape == (3, 5, 130)
    np.testing.assert_array_equal(win, jax_tiff.read_window(p, 95, 200)[0])
    assert tiff.read_window(p, 120, 200)[0].shape == (3, 0, 0)


@pytest.mark.parametrize("kw", [dict(rows_per_strip=8), dict(tile=(16, 16)),
                                dict(rows_per_strip=8, compress="deflate")])
def test_read_window_io_is_o_window(tmp_path, kw):
    """A window at the top of a tall scene reads the header, the IFD and
    the strips or tiles it touches, not the file."""
    p = tmp_path / "tall.tif"
    tiff.write(str(p), _scene(h=1024, w=256), **kw)
    cache = {}
    win, _ = tiff.read_window(str(p), 0, 32, _cache=cache)
    np.testing.assert_array_equal(win, jax_tiff.read(str(p))[0][:, :32])
    bytes_read = cache["f"].bytes_read
    cache["f"].close()
    assert bytes_read < p.stat().st_size * 0.15, (bytes_read, p.stat().st_size)


@pytest.mark.parametrize("kw", [dict(rows_per_strip=8), dict(tile=(16, 16))])
def test_evict_decoded_rows(tmp_path, kw):
    """Top-down reads with eviction keep the decoded segments bounded, for
    strip- and tile-organized files."""
    p = str(tmp_path / "e.tif")
    tiff.write(p, _scene(h=128, w=64), **kw)
    full, _ = jax_tiff.read(p)
    cache, max_cached = {}, 0
    for y in range(0, 128, 16):
        win, _ = tiff.read_window(p, y, y + 16, _cache=cache)
        np.testing.assert_array_equal(win, full[:, y:y + 16])
        tiff.evict_decoded_rows(cache, y + 16)
        max_cached = max(max_cached, len(cache["segs"]))
    cache["f"].close()
    assert max_cached <= 12, max_cached
    assert len(cache["segs"]) == 0


def _planar_tiff(path, arr, rps):
    """A minimal classic TIFF with PlanarConfiguration 2 (the writer emits
    chunky data only): one strip per ``rps`` rows per plane."""
    c, h, w = arr.shape
    strips = [arr[b, s * rps:(s + 1) * rps].tobytes() for b in range(c) for s in range(h // rps)]
    n = len(strips)
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8), (259, 3, 1, 1),
               (262, 3, 1, 1), (273, 4, n, 0), (277, 3, 1, c), (278, 4, 1, rps),
               (279, 4, n, 0), (284, 3, 1, 2)]
    off_pos = 8 + 2 + len(entries) * 12 + 4
    cnt_pos = off_pos + 4 * n
    offs = list(np.cumsum([cnt_pos + 4 * n] + [len(st) for st in strips[:-1]]))
    entries = [(273, 4, n, off_pos) if e[0] == 273 else (279, 4, n, cnt_pos) if e[0] == 279
               else e for e in entries]
    body = struct.pack("<H", len(entries))
    for tag, ft, cnt, val in entries:
        body += struct.pack("<HHII", tag, ft, cnt, val)
    body += struct.pack("<I", 0) + struct.pack(f"<{n}I", *offs)
    body += struct.pack(f"<{n}I", *[len(st) for st in strips])
    path.write_bytes(struct.pack("<2sHI", b"II", 42, 8) + body + b"".join(strips))


def test_evict_decoded_rows_planar(tmp_path):
    """Planar-separate strips repeat a plane's layout at a plane offset;
    eviction maps those keys back to rows."""
    arr = _scene(h=16, w=8, c=2)
    p = tmp_path / "planar.tif"
    _planar_tiff(p, arr, 4)
    np.testing.assert_array_equal(jax_tiff.read(str(p))[0], arr)
    cache = {}
    np.testing.assert_array_equal(tiff.read_window(str(p), 0, 4, _cache=cache)[0], arr[:, :4])
    assert len(cache["segs"]) == 2  # one strip a plane
    tiff.read_window(str(p), 4, 8, _cache=cache)
    tiff.evict_decoded_rows(cache, 8)
    assert len(cache["segs"]) == 0
    cache["f"].close()


@pytest.mark.parametrize("compress", [None, "deflate", "lzw", "packbits", "jpeg-lossless"])
def test_strip_stream_writer_roundtrip(tmp_path, compress):
    """Uneven chunks across strips; JAX's codec and the port's read the
    file back, georeference and nodata included."""
    arr = _scene(h=63, w=41, dtype=np.uint16)
    p = str(tmp_path / "out.tif")
    t = (5.0, 0.5, 0.0, 9.0, 0.0, -0.5)
    wr = tiff.StripStreamWriter(p, 63, 41, 3, np.uint16, transform=t, crs="EPSG:25832",
                                nodata=0, compress=compress, rows_per_strip=10)
    hwc, pos = np.moveaxis(arr, 0, 2), 0
    for n in (1, 9, 10, 25, 18):
        wr.append_rows(hwc[pos:pos + n])
        pos += n
    wr.close()
    for read in (jax_tiff.read, tiff.read):
        back, info = read(p)
        np.testing.assert_array_equal(back, arr)
        assert tuple(info.transform) == t and info.crs == "EPSG:25832" and info.nodata == 0


def test_strip_stream_writer_chw_chunks_and_bigtiff(tmp_path):
    arr = _scene(h=30, w=20, c=1, dtype=np.float32)
    p = str(tmp_path / "big.tif")
    with tiff.StripStreamWriter(p, 30, 20, 1, np.float32, bigtiff=True,
                                rows_per_strip=8) as wr:
        wr.append_rows(arr[:, :16])
        wr.append_rows(arr[:, 16:])
    back, info = jax_tiff.read(p)
    np.testing.assert_array_equal(back, arr)
    assert info.tags["_bigtiff"]


def test_strip_stream_writer_incomplete_close_raises(tmp_path):
    wr = tiff.StripStreamWriter(str(tmp_path / "x.tif"), 10, 5, 1, np.uint8)
    wr.append_rows(np.zeros((4, 5, 1), np.uint8))
    with pytest.raises(ValueError, match="4/10 rows"):
        wr.close()


# --- the finalize on tensors and the band ------------------------------------


@pytest.mark.parametrize("mode", MODES, ids=lambda m: next(iter(m), "class_map"))
def test_torch_finalize_equals_numpy_finalize(mode):
    """Bit for bit, with pixels no window reached (count 0) and exact ties
    between classes."""
    rng = np.random.default_rng(1)
    counter = rng.integers(0, 5, (37, 41)).astype(np.float32)
    summed = (rng.uniform(size=(N_OUT, 37, 41)) * counter).astype(np.float32)
    summed[1, :5] = summed[0, :5]  # ties: the first index wins
    summed[:, counter == 0] = 0
    if mode.get("regression"):
        summed = summed[:1] * 7 - 3
    want, want_nodata = jax_finalize(summed, counter, **mode)
    got, nodata = tmerge.finalize_mosaic_torch(torch.from_numpy(summed),
                                               torch.from_numpy(counter), **mode)
    assert got.dtype == {np.dtype(np.uint8): torch.uint8,
                         np.dtype(np.float32): torch.float32}[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)
    assert nodata == want_nodata
    host, _ = tmerge.finalize_mosaic(summed, counter, **mode)
    np.testing.assert_array_equal(got.numpy(), host)


def test_band_equals_full_mosaic_with_wrapping_batches():
    """The served scene's windows in (y, x) order at batch 4 (5 windows a
    window row, so batches wrap rows): the band's finalized rows equal a
    whole mosaic's finish, bit for bit, in every mode, and each row is
    emitted once."""
    windows = generate_windows(H, W, PATCH, 0.2)
    batches, rows = tp.band_plan(windows, 4)
    assert sum(b[0].y != b[-1].y for b in batches) == 3 and rows == 52 + PATCH
    rng = np.random.default_rng(2)
    probs = [torch.from_numpy(rng.uniform(size=(len(b), N_OUT, PATCH, PATCH))
                              .astype(np.float32)) for b in batches]
    for mode in MODES:
        band = tblend.DeviceBand(rows, W, N_OUT, device="cpu")
        full = tblend.DeviceMosaic(H, W, N_OUT, device="cpu")
        parts = []
        for k, (b, p) in enumerate(zip(batches, probs)):
            ys, xs = [w.y for w in b], [w.x for w in b]
            band.add_batch(p, ys, xs)
            full.add_batch(p, ys, xs)
            upto = batches[k + 1][0].y if k + 1 < len(batches) else H
            if upto > band.top:
                parts.append(band.finalize_rows(upto, **mode)[0])
        want, _ = full.finish(**mode)
        np.testing.assert_array_equal(torch.cat(parts, dim=-2).numpy(), want.numpy())
    for upto in (band.top, band.top + rows + 1):
        with pytest.raises(ValueError, match="cannot finalize"):
            band.finalize_rows(upto)


# --- the tiers and the streamed path on the served bundle --------------------


def _kw(**kw):
    kw.setdefault("dtype", torch.float32)
    return dict(patch_size=PATCH, batch_size=BATCH, device="cpu", **kw)


def _stream(served, path, **kw):
    assert tp.predict_raster_streamed(served["bundle"], served["scene"], str(path),
                                      **_kw(**kw)) == str(path)
    back = read_raster(path)
    assert tuple(back.transform) == TRANSFORM and back.crs == CRS
    return back


@pytest.fixture(scope="module")
def jax_pred(served):
    """JAX's predictor for the served bundle, rebuilt at float32 on one
    device."""
    p = jax_predict.Predictor(served["bundle"], batch_size=BATCH, devices=jax.devices()[:1])
    p.model = jax_build_unet("xresnet18", n_out=N_OUT, c_in=3, dtype=jnp.float32,
                             tpu_opt=True)
    return p


@pytest.mark.parametrize("mode", [{}, {"all_classes": True}],
                         ids=["class_map", "all_classes"])
def test_streamed_matches_jax_streamed(served, jax_pred, tmp_path, mode):
    jax_predict.predict_raster_streamed(served["bundle"], served["scene"],
                                        str(tmp_path / "jax.tif"), patch_size=PATCH,
                                        batch_size=BATCH, predictor=jax_pred, **mode)
    want, info = jax_tiff.read(str(tmp_path / "jax.tif"))
    got = _stream(served, tmp_path / "port.tif", **mode)
    assert got.data.dtype == want.dtype and got.data.shape == want.shape
    assert got.nodata == info.nodata
    if mode:
        np.testing.assert_allclose(got.data, want, atol=1e-4)
    else:
        differ = got.data[0] != want[0]
        assert np.all(served["margin"][differ] < 1e-5)


def test_streamed_on_jax_probabilities_writes_jax_file(served, jax_pred, tmp_path):
    """The port's streamed path fed JAX's probabilities of each batch adds,
    divides and writes exactly what JAX's streamed path writes."""
    pred = tp.Predictor(served["bundle"], batch_size=BATCH, device="cpu",
                        dtype=torch.float32)
    pred.predict_batch_device = lambda images: torch.from_numpy(
        np.array(jax_pred.predict_batch_device(images))).permute(0, 3, 1, 2)
    for mode in ({}, {"all_classes": True}):
        jax_predict.predict_raster_streamed(served["bundle"], served["scene"],
                                            str(tmp_path / "jax.tif"), patch_size=PATCH,
                                            batch_size=BATCH, predictor=jax_pred, **mode)
        got = _stream(served, tmp_path / "port.tif", predictor=pred, **mode)
        np.testing.assert_array_equal(got.data, jax_tiff.read(str(tmp_path / "jax.tif"))[0])


@pytest.mark.parametrize("mode", MODES + [{"class_zero": True}],
                         ids=["class_map", "all_classes", "specific_class", "regression",
                              "class_zero"])
def test_three_tiers_agree(served, tmp_path, mode):
    """Banded in RAM == streamed, bit for bit; the whole-scene tier equal
    but for the order of float32 adds; the scene records name each tier."""
    pred = tp.Predictor(served["bundle"], batch_size=BATCH, device="cpu",
                        dtype=torch.float32)
    full, t, crs = tp.predict_raster(served["bundle"], served["scene"],
                                     **_kw(predictor=pred, **mode))
    banded, _, _ = tp.predict_raster(served["bundle"], served["scene"],
                                     **_kw(predictor=pred, device_budget_bytes=0, **mode))
    streamed = _stream(served, tmp_path / "s.tif", predictor=pred, **mode).data
    np.testing.assert_array_equal(banded, streamed if banded.ndim == 3 else streamed[0])
    assert [s["tier"] for s in pred.scenes] == ["full", "banded", "streamed"]
    n = len(generate_windows(H, W, PATCH, 0.2))
    assert all(s["windows"] == n and s["batches"] == -(-n // BATCH) for s in pred.scenes)
    # the 3 batches that wrap rows are added in two parts each
    assert [s["adds"] for s in pred.scenes] == [5, 8, 8]
    assert pred.scenes[1]["wrapping_batches"] == 3 and pred.scenes[1]["band_rows"] == 116
    assert tuple(t) == TRANSFORM and crs == CRS
    if full.dtype == np.uint8:
        differ = full != banded
        assert np.all(served["margin"][differ] < 1e-5)
    else:
        np.testing.assert_allclose(banded, full, rtol=1e-6)


def test_host_budget_routes_to_the_stream(served, tmp_path):
    out = tmp_path / "o.tif"
    arr, t, crs = tp.predict_raster(served["bundle"], served["scene"], str(out),
                                    **_kw(host_budget_bytes=1))
    assert arr is None and tuple(t) == TRANSFORM and crs == CRS
    want = _stream(served, tmp_path / "s.tif")
    np.testing.assert_array_equal(read_raster(out).data, want.data)
    with pytest.raises(ValueError, match="pass output_path"):
        tp.predict_raster(served["bundle"], served["scene"], **_kw(host_budget_bytes=1))


def test_stream_never_reads_the_whole_scene(served, tmp_path, monkeypatch):
    want = _stream(served, tmp_path / "a.tif").data

    def refuse(*a, **k):
        raise AssertionError("the streamed path read the whole scene")

    for mod, name in ((tp, "read_raster"), (geo, "read_raster"), (tiff, "read")):
        monkeypatch.setattr(mod, name, refuse)
    tp.predict_raster_streamed(served["bundle"], served["scene"], str(tmp_path / "b.tif"),
                               **_kw())
    monkeypatch.undo()
    np.testing.assert_array_equal(read_raster(tmp_path / "b.tif").data, want)


def test_stream_class_zero_and_jpeg_check(served, tmp_path):
    plain = _stream(served, tmp_path / "a.tif").data
    shifted = _stream(served, tmp_path / "b.tif", class_zero=True).data
    np.testing.assert_array_equal(shifted, jax_predict._apply_class_zero(plain, None))
    with pytest.raises(ValueError, match="requires uint8 class-map"):
        tp.predict_raster_streamed(served["bundle"], served["scene"], str(tmp_path / "c.tif"),
                                   out_compress="jpeg", all_classes=True, **_kw())
    assert not (tmp_path / "c.tif").exists()


def test_scene_smaller_than_one_patch(served, tmp_path):
    """A 40 × 56 crop: one window, clipped to the scene, in every tier."""
    small = tmp_path / "small.tif"
    geo.write_raster(small, served["img"][:, :40, :56], transform=TRANSFORM, crs=CRS)
    pred = tp.Predictor(served["bundle"], batch_size=BATCH, device="cpu",
                        dtype=torch.float32)
    full, _, _ = tp.predict_raster(served["bundle"], str(small), **_kw(predictor=pred))
    banded, _, _ = tp.predict_raster(served["bundle"], str(small),
                                     **_kw(predictor=pred, device_budget_bytes=0))
    tp.predict_raster_streamed(served["bundle"], str(small), str(tmp_path / "s.tif"),
                               **_kw(predictor=pred))
    assert full.shape == (40, 56) and full.max() < N_OUT
    np.testing.assert_array_equal(full, banded)
    np.testing.assert_array_equal(read_raster(tmp_path / "s.tif").data[0], banded)
    assert [(s["windows"], s["batches"]) for s in pred.scenes] == [(1, 1)] * 3


def test_cli_stream_stats(served, tmp_path):
    """``serve --stream`` reports the streamed tier, the core's batches and
    the finalize; the CPU launches no kernel."""
    import json

    out, stats = tmp_path / "o.tif", tmp_path / "st.json"
    assert cli(["serve", served["bundle"], served["scene"], str(out), "--stream",
                "--patch-size", str(PATCH), "--batch-size", str(BATCH), "--device", "cpu",
                "--stats-json", str(stats)]) == 0
    st = json.loads(stats.read_text())
    (scene,) = st["scenes"]
    assert scene["tier"] == "streamed" and scene["finalize_s"] >= 0
    assert st["batches"] == scene["batches"] == len(st["forward_ms"]) == 5
    assert st["launches"] == {"blend_count": 0} and st["peak_device_bytes"] is None


def test_serve_scenes_picks_a_tier_for_each_scene(served, tmp_path):
    """The budgets pass through ``serve_scenes``: under a 100 kB device
    budget the 40 × 56 crop takes the whole-scene mosaic and the served
    scene the band; each map equals that scene's own banded serve."""
    small = tmp_path / "small.tif"
    geo.write_raster(small, served["img"][:, :40, :56], transform=TRANSFORM, crs=CRS)
    pred = tp.Predictor(served["bundle"], batch_size=BATCH, device="cpu",
                        dtype=torch.float32)
    outs = tp.serve_scenes(served["bundle"], [served["scene"], str(small)], tmp_path / "out",
                           **_kw(predictor=pred, device_budget_bytes=100_000))
    assert [s["tier"] for s in pred.scenes] == ["banded", "full"]
    for out, scene in zip(outs, (served["scene"], str(small))):
        want, _, _ = tp.predict_raster(served["bundle"], scene,
                                       **_kw(predictor=pred, device_budget_bytes=0))
        np.testing.assert_array_equal(read_raster(out).data[0], want)
