"""PyTorch port: ``import-model`` (a fastai DynamicUnet state_dict → a
parity bundle) against the JAX package's importer, and parity bundles
served by the port against the JAX package's serve path, on the CPU.

The fastai replica is ``make_torch_unet`` of ``tests/test_unet_import.py``
(the reference's DynamicUnet, module for module, with random weights and,
with self-attention, a converged power iteration)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from test_torch_parity import jax_variables
from test_unet_import import make_torch_unet
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.models.torch_import import import_model_cli as jax_import_model_cli
from unet_tpu.ops.blend import blend_and_count as jax_blend_and_count
from unet_tpu.predict import predict as jax_predict
from unet_tpu.predict.merge import finalize_mosaic as jax_finalize
from unet_tpu.tiling.windows import generate_windows as jax_windows
from unet_tpu.train.checkpoint import export_bundle as jax_export_bundle
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.models.torch_import import import_model_cli
from unet_tpu_torch.predict import predict as tp
from unet_tpu_torch.train.checkpoint import load_bundle

torch.set_num_threads(2)
H, W, PATCH, BATCH, N_OUT = 120, 136, 64, 4, 3
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CRS = "EPSG:25832"


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "self_attention"])
def imported(request, tmp_path_factory):
    """The replica's .pth imported by both packages into bundles of the
    same name (the JAX importer's template init is the slow part)."""
    sa = request.param
    root = tmp_path_factory.mktemp("import")
    m = make_torch_unet(c_in=3, n_out=N_OUT, self_attention=sa, seed=5 if sa else 4)
    pth = root / "model_sd.pth"
    torch.save(m.state_dict(), pth)
    kw = dict(patch_size=PATCH, codes=["a", "b", "c"], dtype_str="uint8")
    jax_import_model_cli(str(pth), str(root / "jax" / "imported"), **kw)
    import_model_cli(str(pth), str(root / "port" / "imported"), device="cpu", **kw)
    return {"sa": sa, "replica": m, "pth": pth, "root": root,
            "jax": root / "jax" / "imported", "port": root / "port" / "imported"}


def test_import_model_bundle_equals_jax_leaf_for_leaf(imported):
    jax_tree = serialization.msgpack_restore(
        (imported["jax"] / "imported.msgpack").read_bytes())
    port_tree = serialization.msgpack_restore(
        (imported["port"] / "imported.msgpack").read_bytes())
    want, got = dict(_leaves(jax_tree)), dict(_leaves(port_tree))
    assert got.keys() == want.keys()
    assert any(k[-1] == "query_u" for k in got) == imported["sa"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert json.loads((imported["port"] / "imported.json").read_text()) == \
        json.loads((imported["jax"] / "imported.json").read_text())


def test_port_logits_match_the_fastai_replica(imported):
    """The imported bundle in the port (float32) against the replica's own
    forward: rtol 1e-3, atol 2e-3, the bar of tests/test_unet_import.py."""
    model, manifest = load_bundle(imported["port"], dtype=torch.float32)
    assert manifest["tpu_opt"] is False and manifest["self_attention"] == imported["sa"]
    assert (model.up_1.sa is not None) == imported["sa"]
    x = np.random.default_rng(8).normal(size=(2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        want = imported["replica"](torch.from_numpy(x)).numpy()
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-3)


def test_cli_import_model_on_cpu(imported, tmp_path, monkeypatch, capsys):
    out = tmp_path / "cli_bundle"
    assert cli(["import-model", str(imported["pth"]), str(out), "--patch-size", "256",
                "--codes", "x", "y", "z", "--dtype", "uint8", "--device", "cpu"]) == 0
    assert "DynamicUnet" in capsys.readouterr().out
    m = json.loads((out / "cli_bundle.json").read_text())
    assert m["patch_size"] == 256 and m["CODES"] == ["x", "y", "z"] and not m["tpu_opt"]
    assert (out / "cli_bundle.msgpack").read_bytes() == \
        (imported["port"] / "imported.msgpack").read_bytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli(["import-model", str(imported["pth"]), str(tmp_path / "o")]) == 2
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        import_model_cli(str(imported["pth"]), str(tmp_path / "o"))


def test_import_model_rejects_what_is_not_a_dynamic_unet(tmp_path):
    torch.save({"0.0.weight": torch.zeros(32, 3, 3, 3)}, tmp_path / "enc.pth")
    with pytest.raises(ValueError, match="Not a DynamicUnet state_dict"):
        import_model_cli(str(tmp_path / "enc.pth"), str(tmp_path / "b"), device="cpu")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A parity + self-attention bundle written by JAX (random numpy weights,
    γ = 0.5), a 120×136 uint8 scene, and JAX's float32 mosaic sums."""
    root = tmp_path_factory.mktemp("serve_parity")
    rng = np.random.default_rng(0)
    model = jax_build_unet("xresnet18", n_out=N_OUT, c_in=3, self_attention=True,
                           dtype=jnp.float32, tpu_opt=False)
    v = jax_variables(model, np.zeros((1, PATCH, PATCH, 3), np.float32), rng, train=False)
    manifest = {"ARCHITECTURE": "xresnet18", "n_out": N_OUT, "number_of_bands": 3,
                "patch_size": PATCH, "enable_regression": False, "dtype_str": "uint8",
                "normalize": "unit", "self_attention": True, "tpu_opt": False,
                "tpu_opt_topology": None}
    jax_export_bundle(root / "m", "m", v, manifest)
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.stack([127 + 100 * np.sin(yy / 9.0 + c) * np.cos(xx / 13.0 - c)
                    + rng.normal(0, 10, yy.shape) for c in range(3)])
    img = np.clip(img, 0, 255).astype(np.uint8)
    write_raster(root / "scene.tif", img, transform=TRANSFORM, crs=CRS)
    probs_fn = jax.jit(jax_predict.make_probs_fn(model, False))
    hwc = np.moveaxis(img, 0, 2)
    wins = jax_windows(H, W, PATCH, 0.2)
    buf = jnp.zeros((H, W * N_OUT), jnp.float32)
    cnt = jnp.zeros((H, W), jnp.float32)
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
    return {"bundle": str(root / "m"), "scene": str(root / "scene.tif"), "img": img,
            "summed": summed, "counter": counter, "margin": avg[-1] - avg[-2]}


def test_port_serves_a_jax_parity_sa_bundle_like_jax(served, tmp_path):
    """The class map equals JAX's except where the top two classes are
    within 1e-5 (float32 sums in another order), at most 0.1% of pixels;
    the probabilities within 1e-4; the georeference kept. The bar of
    tests/test_torch_serve.py."""
    want, _ = jax_finalize(served["summed"], served["counter"])
    out = tmp_path / "out.tif"
    got, transform, _ = tp.predict_raster(served["bundle"], served["scene"], str(out),
                                          patch_size=PATCH, batch_size=BATCH,
                                          device="cpu", dtype=torch.float32)
    assert got.dtype == np.uint8 and got.shape == (H, W)
    differ = got != want
    assert np.all(served["margin"][differ] < 1e-5) and differ.mean() <= 1e-3
    assert tuple(read_raster(out).transform) == TRANSFORM and tuple(transform) == TRANSFORM
    stack, _ = jax_finalize(served["summed"], served["counter"], all_classes=True)
    probs, _, _ = tp.predict_raster(served["bundle"], served["scene"], patch_size=PATCH,
                                    batch_size=BATCH, device="cpu", dtype=torch.float32,
                                    all_classes=True)
    np.testing.assert_allclose(probs, stack, atol=1e-4)


def test_bf16_parity_serve_agrees_with_jax_bf16_predictor(served):
    want, _, _ = jax_predict.predict_raster(served["bundle"], served["scene"],
                                            patch_size=PATCH, batch_size=BATCH)
    got, _, _ = tp.predict_raster(served["bundle"], served["scene"], patch_size=PATCH,
                                  batch_size=BATCH, device="cpu", dtype=torch.bfloat16)
    assert (np.asarray(want) == got).mean() >= 0.99


def test_parity_probs_and_regression_branch_match_jax(served):
    """make_probs_fn on full-resolution logits: the class softmax, and the
    first channel for regression, as JAX's branch computes them (1e-5)."""
    jm = jax_build_unet("xresnet18", n_out=N_OUT, c_in=3, self_attention=True,
                        dtype=jnp.float32, tpu_opt=False)
    from unet_tpu.train.checkpoint import load_bundle as jax_load_bundle

    _, v, _ = jax_load_bundle(served["bundle"])
    model, _ = load_bundle(served["bundle"], dtype=torch.float32)
    x = np.moveaxis(served["img"], 0, 2)[None, :PATCH, :PATCH].astype(np.float32) / 255
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, 3, 1)))
    for regression in (False, True):
        want = np.asarray(jax.jit(jax_predict.make_probs_fn(jm, regression))(v, x))
        with torch.no_grad():
            got = tp.make_probs_fn(model, regression)(xt).permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape == (1, PATCH, PATCH, 1 if regression else N_OUT)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_cli_serves_the_imported_bundle(imported, tmp_path):
    """``serve`` takes the imported bundle as it is (no flag): a class map
    of the scene, classes below n_out, the georeference kept."""
    img = np.random.default_rng(3).integers(0, 256, (3, 80, 72)).astype(np.uint8)
    write_raster(tmp_path / "s.tif", img, transform=TRANSFORM, crs=CRS)
    out = tmp_path / "o.tif"
    assert cli(["serve", str(imported["port"]), str(tmp_path / "s.tif"), str(out),
                "--batch-size", "2", "--device", "cpu"]) == 0
    r = read_raster(out)
    assert r.data.dtype == np.uint8 and r.data.shape == (1, 80, 72)
    assert int(r.data.max()) < N_OUT and tuple(r.transform) == TRANSFORM
