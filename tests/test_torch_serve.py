"""PyTorch port, the slice end to end: whole-scene serving on the CPU
against the JAX package's serve path, plus the port's package rules."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.geo import tiff as jax_tiff
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.models.unet import TPU_OPT_TOPOLOGY_VERSION
from unet_tpu.ops.blend import blend_and_count as jax_blend_and_count
from unet_tpu.predict import predict as jax_predict
from unet_tpu.predict.merge import finalize_mosaic as jax_finalize
from unet_tpu.tiling.windows import generate_windows as jax_windows
from unet_tpu.train.checkpoint import export_bundle as jax_export_bundle
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.predict import predict as tp

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
H, W, PATCH, BATCH, N_OUT = 200, 232, 64, 4, 3
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CRS = "EPSG:25832"


def _randomize_stats(variables, rng):
    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "mean":
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, variables))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A tiny tpu_opt bundle written by JAX, a 200×232 uint8 scene written
    by the port's geo copy, and JAX's float32 reference mosaic sums."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    model = jax_build_unet("xresnet18", n_out=N_OUT, c_in=3, dtype=jnp.float32,
                           tpu_opt=True)
    v = model.init(jax.random.PRNGKey(0), np.zeros((1, PATCH, PATCH, 3), np.float32),
                   train=False)
    v = _randomize_stats(v, rng)
    manifest = {"ARCHITECTURE": "xresnet18", "n_out": N_OUT, "number_of_bands": 3,
                "patch_size": PATCH, "enable_regression": False,
                "dtype_str": "uint8", "normalize": "unit", "self_attention": False,
                "tpu_opt": True, "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION}
    jax_export_bundle(root / "m", "m", v, manifest)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([127 + 100 * np.sin(yy / 9.0 + c) * np.cos(xx / 13.0 - c)
                    + rng.normal(0, 10, yy.shape) for c in range(3)])
    img = np.clip(img, 0, 255).astype(np.uint8)
    write_raster(root / "scene.tif", img, transform=TRANSFORM, crs=CRS)

    # JAX: make_probs_fn + generate_windows + blend_and_count, float32
    probs_fn = jax.jit(jax_predict.make_probs_fn(model, False))
    hwc = np.moveaxis(img, 0, 2)
    wins = jax_windows(H, W, PATCH, 0.2)
    buf = jnp.zeros((H, W * N_OUT), jnp.float32)
    cnt = jnp.zeros((H, W), jnp.float32)
    margin = np.full((H, W), np.inf, np.float32)
    for s in range(0, len(wins), BATCH):
        chunk = wins[s:s + BATCH]
        x = np.stack([hwc[w.indices()] for w in chunk]).astype(np.float32) / 255.0
        p = probs_fn(v, x)
        buf, cnt = jax_blend_and_count(
            buf, cnt, p.reshape(len(chunk), PATCH, PATCH * N_OUT),
            jnp.asarray([w.y for w in chunk], jnp.int32),
            jnp.asarray([w.x for w in chunk], jnp.int32), PATCH, PATCH)
    summed = np.moveaxis(np.asarray(buf).reshape(H, W, N_OUT), 2, 0)
    counter = np.asarray(cnt)
    avg = np.sort(summed / counter, axis=0)
    margin = avg[-1] - avg[-2]
    return {"root": root, "bundle": str(root / "m"), "scene": str(root / "scene.tif"),
            "img": img, "summed": summed, "counter": counter, "margin": margin,
            "model": model, "variables": v}


def _port(served, **kw):
    kw.setdefault("dtype", torch.float32)
    return tp.predict_raster(served["bundle"], served["scene"], patch_size=PATCH,
                             batch_size=BATCH, device="cpu", **kw)


def test_class_map_matches_jax_except_near_ties(served, tmp_path):
    want, _ = jax_finalize(served["summed"], served["counter"])
    out = tmp_path / "out.tif"
    got, transform, crs = _port(served, output_path=str(out))
    assert got.dtype == np.uint8 and got.shape == (H, W)
    differ = got != want
    assert np.all(served["margin"][differ] < 1e-5)
    assert differ.mean() <= 1e-3
    back = read_raster(out)
    np.testing.assert_array_equal(back.data[0], got)
    assert tuple(back.transform) == TRANSFORM and back.crs == CRS
    assert tuple(transform) == TRANSFORM and crs == CRS


def test_output_modes_match_jax_finalize(served):
    """all_classes / specific_class / regression / class_zero on the same
    sums (probabilities within 1e-4: float32 sums in another order)."""
    summed, counter = served["summed"], served["counter"]
    stack, _ = jax_finalize(summed, counter, all_classes=True)
    got, _, _ = _port(served, all_classes=True)
    np.testing.assert_allclose(got, stack, atol=1e-4)
    got, _, _ = _port(served, specific_class=1)
    np.testing.assert_allclose(got, stack[1], atol=1e-4)
    reg, _ = jax_finalize(summed, counter, regression=True)
    got, _, _ = _port(served, regression=True)
    np.testing.assert_allclose(got, reg, atol=1e-4)
    cmap, _ = jax_finalize(summed, counter)
    got, _, _ = _port(served, class_zero=True)
    ok = served["margin"] >= 1e-5
    np.testing.assert_array_equal(got[ok], jax_predict._apply_class_zero(cmap, None)[ok])


def test_bf16_serve_agrees_with_jax_bf16_predictor(served):
    want, _, _ = jax_predict.predict_raster(served["bundle"], served["scene"],
                                            patch_size=PATCH, batch_size=BATCH)
    got, _, _ = _port(served, dtype=torch.bfloat16)
    assert (np.asarray(want) == got).mean() >= 0.99


def test_tta_and_finish_probs_match_jax(served):
    x = np.moveaxis(served["img"], 0, 2)[None, :PATCH, :PATCH].astype(np.float32) / 255
    probs_fn = jax_predict.tta_probs_fn(jax_predict.make_probs_fn(served["model"], False))
    want = np.asarray(probs_fn(served["variables"], x))
    pred = tp.Predictor(served["bundle"], device="cpu", dtype=torch.float32, tta=True)
    got = pred.predict_batch(np.moveaxis(served["img"], 0, 2)[None, :PATCH, :PATCH])
    np.testing.assert_allclose(got, want, atol=1e-4)
    p = np.random.default_rng(5).dirichlet(np.ones(N_OUT), size=(2, 6, 5)).astype(np.float32)
    pt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(p, 3, 1)))
    for kw in ({"argmax_u8": True}, {"quantize_int8": True, "folded": True},
               {"folded": True}):
        np.testing.assert_array_equal(tp.finish_probs(pt, **kw).numpy(),
                                      np.asarray(jax_predict.finish_probs(jnp.asarray(p), **kw)))


def test_uint16_tiles_cross_in_storage_dtype(served):
    pred = tp.Predictor(served["bundle"], device="cpu", dtype=torch.float32)
    x8 = np.moveaxis(served["img"], 0, 2)[None, :PATCH, :PATCH]
    want = pred.predict_batch(x8)
    got = pred.predict_batch(x8.astype(np.uint16))
    np.testing.assert_array_equal(got, want)


def test_cli_serve_on_cpu(served, tmp_path):
    out, stats = tmp_path / "cli.tif", tmp_path / "stats.json"
    rc = cli(["serve", served["bundle"], served["scene"], str(out),
              "--patch-size", str(PATCH), "--batch-size", str(BATCH),
              "--device", "cpu", "--stats-json", str(stats)])
    assert rc == 0
    got, _, _ = _port(served, dtype=torch.bfloat16)
    np.testing.assert_array_equal(read_raster(out).data[0], got)
    st = json.loads(stats.read_text())
    assert st["windows"] == len(jax_windows(H, W, PATCH, 0.2))
    assert st["batches"] == len(st["forward_ms"]) == -(-st["windows"] // BATCH)
    assert st["launches"] == {"blend_count": 0}  # the CPU never launches it


@pytest.mark.parametrize("flag", [["--stream"], ["--spatial", "2"]])
def test_cli_unported_options_fail_clearly(served, tmp_path, flag, capsys):
    rc = cli(["serve", served["bundle"], served["scene"], str(tmp_path / "o.tif"),
              "--device", "cpu", *flag])
    assert rc == 2
    assert "not yet ported" in capsys.readouterr().err


def test_entry_points_need_cuda_unless_cpu_is_asked(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.Predictor(served["bundle"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.predict_raster(served["bundle"], served["scene"])
    assert cli(["serve", served["bundle"], served["scene"], "o.tif"]) == 2


@pytest.mark.parametrize("compress", [None, "deflate", "lzw", "packbits"])
def test_geo_copy_writes_what_jax_reads(tmp_path, compress):
    """The port's geo copy writes GeoTIFFs the JAX package reads back
    unchanged, georeference included."""
    a = np.random.default_rng(7).integers(0, 60, (3, 37, 53)).astype(np.uint8)
    write_raster(tmp_path / "a.tif", a, transform=TRANSFORM, crs=CRS,
                 compress=compress)
    data, info = jax_tiff.read(str(tmp_path / "a.tif"))
    np.testing.assert_array_equal(data, a)
    assert tuple(info.transform) == TRANSFORM and info.crs == CRS
    np.testing.assert_array_equal(read_raster(tmp_path / "a.tif").data, a)


BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "unet_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_unet_tpu():
    # chip_smoke.py and tools/torch_gate_seeds.py load the quality gate's
    # scene from tests/aerial_fixture.py
    files = sorted((ROOT / "unet_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "aerial_fixture.py",
        ROOT / "tools" / "torch_gate_seeds.py"]
    assert len(files) > 15
    bad = [(f.relative_to(ROOT), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in BANNED]
    assert not bad, bad
