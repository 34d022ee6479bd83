"""PyTorch port: serving artifacts (``predict/artifact.py``, ``export``)
against the JAX package's on the CPU.

Random-init bundles written with JAX's ``export_bundle`` (xresnet18, 3
bands, 64² tiles, 3 classes; tpu_opt, and parity with self-attention at
γ = 0.5): the port's artifact against JAX's artifact of the same bundle
(both float32: atol 1e-4 and >= 99% classes), against the port's live
``Predictor`` (1e-6; the same ATen ops run), the
int8 values and scales against JAX's ``_quantize_leaf`` leaf for leaf, the
symbolic batch, each package refusing the other's format, loading without
model-building code, and the CLI's ``export``, ``serve`` and ``predict``.
"""

import copy
import io
import json
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_parity import jax_variables
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.models.unet import TPU_OPT_TOPOLOGY_VERSION
from unet_tpu.predict import artifact as jart
from unet_tpu.train.checkpoint import export_bundle as jax_export_bundle
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.models import unet as tunet
from unet_tpu_torch.predict import artifact as tart
from unet_tpu_torch.predict import predict as tp
from unet_tpu_torch.tiling import split_raster
from unet_tpu_torch.train import checkpoint as tckpt
from unet_tpu_torch.train.checkpoint import to_flax_variables

torch.set_num_threads(2)
PATCH, N_OUT, BATCH = 64, 3, 4
TOPOLOGIES = {"tpu_opt": dict(tpu_opt=True, self_attention=False),
              "parity_sa": dict(tpu_opt=False, self_attention=True)}
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
CRS = "EPSG:25832"


def _tiles(seed, n=5):
    return np.random.default_rng(seed).integers(0, 256, (n, PATCH, PATCH, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """One JAX-written bundle per topology and the port's float32 artifact
    of each (exported on the CPU)."""
    root = tmp_path_factory.mktemp("artifact")
    rng = np.random.default_rng(0)
    out = {"root": root}
    for name, kw in TOPOLOGIES.items():
        model = jax_build_unet("xresnet18", n_out=N_OUT, c_in=3, dtype=jnp.float32, **kw)
        v = jax_variables(model, np.zeros((1, PATCH, PATCH, 3), np.float32), rng, train=False)
        manifest = {"ARCHITECTURE": "xresnet18", "n_out": N_OUT, "number_of_bands": 3,
                    "patch_size": PATCH, "enable_regression": False, "dtype_str": "uint8",
                    "normalize": "unit", "codes": ["a", "b", "c"], **kw,
                    "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION}
        jax_export_bundle(root / name, name, v, manifest)
        art = tart.export_artifact(str(root / name), str(root / f"{name}.uta"),
                                   dtype=torch.float32, device="cpu")
        out[name] = {"bundle": str(root / name), "art": str(art), "variables": v}
    return out


@pytest.fixture(scope="module")
def jax_arts(bundles):
    """JAX's artifacts of each bundle for the CPU: float32 (its
    ``export_artifact`` with the model its ``load_bundle`` returns cloned
    to float32) and its default bf16, one export of each per topology."""
    from unet_tpu.train import checkpoint as jckpt

    load = jckpt.load_bundle

    def load32(*a, **k):
        model, variables, manifest = load(*a, **k)
        return model.clone(dtype=jnp.float32), variables, manifest

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jckpt, "load_bundle", load32)
        for name in TOPOLOGIES:
            path = bundles["root"] / f"{name}_jax32.uta"
            jart.export_artifact(bundles[name]["bundle"], str(path), platforms=["cpu"])
            out[name] = str(path)
    for name in TOPOLOGIES:
        path = bundles["root"] / f"{name}_jax_bf16.uta"
        jart.export_artifact(bundles[name]["bundle"], str(path), platforms=["cpu"])
        out[name, "bf16"] = str(path)
    return out


@pytest.fixture(scope="module")
def loaded(bundles):
    """The port's float32 artifact of each bundle, loaded once on the CPU,
    and the live float32 ``Predictor`` of the bundle beside it."""
    return {name: (tart.load_artifact(bundles[name]["art"], batch_size=BATCH, device="cpu"),
                   _live(bundles[name]["bundle"]))
            for name in TOPOLOGIES}


@pytest.fixture(scope="module")
def int8_art(bundles):
    b = bundles["tpu_opt"]
    return str(tart.export_artifact(b["bundle"], str(bundles["root"] / "q.uta"),
                                    quantize="int8", dtype=torch.float32, device="cpu"))


def _live(bundle, **kw):
    return tp.Predictor(bundle, batch_size=BATCH, device="cpu", dtype=torch.float32, **kw)


def _members(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _rewrite(path, out, header=None, program=None):
    m = _members(path)
    if header is not None:
        m["__utaot__"] = np.frombuffer(json.dumps(header).encode(), np.uint8)
    if program is not None:
        m["__program__"] = np.frombuffer(program, np.uint8)
    with open(out, "wb") as f:
        np.savez(f, **m)
    return str(out)


@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_port_artifact_matches_jax_artifact(bundles, jax_arts, loaded, topology):
    """(i) JAX's artifact of the bundle (its StableHLO program, exported and
    loaded by ``unet_tpu.predict.artifact``, computing in float32) against
    the port's float32 artifact: atol 1e-4 and >= 99% of the classes equal.
    Printed beside (ROADMAP §3): JAX's default bf16 program and the port's
    live bf16 ``Predictor``, each against the port's float32 artifact on
    the same tiles; on these random weights both are 2e-2 or more from
    float32, from bf16 rounding alone."""
    x = _tiles(1, 2)
    want = jart.load_artifact(jax_arts[topology], batch_size=2).predict_batch(x)
    got = loaded[topology][0].predict_batch(x)
    assert got.shape == want.shape == (2, PATCH, PATCH, N_OUT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    others = {"JAX bf16 artifact": jart.load_artifact(jax_arts[topology, "bf16"],
                                                      batch_size=2).predict_batch(x),
              "port bf16 Predictor": tp.Predictor(bundles[topology]["bundle"], batch_size=2,
                                                  device="cpu").predict_batch(x)}
    for name, p in others.items():
        print(f"{topology}: {name} vs port float32 artifact: max |dp| "
              f"{np.abs(p - got).max():.4f}, classes "
              f"{100 * (p.argmax(-1) == got.argmax(-1)).mean():.2f}%")


@pytest.mark.parametrize("topology,tta", [("tpu_opt", False), ("tpu_opt", True),
                                          ("parity_sa", False)])
def test_port_artifact_matches_live_predictor(bundles, loaded, topology, tta):
    """(ii) The float32 artifact against the live float32 ``Predictor`` on
    the same tiles, with and without TTA: within 1e-6, and every finished
    form (class map, int8 stretch) equal. The module's loaded artifact
    serves, with TTA through a shallow copy whose ``tta`` is set (the
    flips compose outside the program)."""
    art, live = loaded[topology]
    if tta:
        art = copy.copy(art)
        art.tta = True
        live = _live(bundles[topology]["bundle"], tta=True)
    x = _tiles(2, BATCH)
    n_before = len(art.forward_ms())
    np.testing.assert_allclose(art.predict_batch(x), live.predict_batch(x), rtol=0, atol=1e-6)
    for kw in ({"argmax_u8": True}, {"quantize_int8": True}):
        assert torch.equal(art.predict_batch_device(x, **kw), live.predict_batch_device(x, **kw))
    assert len(art.forward_ms()) == n_before + 3 and art.dtype == torch.float32


def test_symbolic_batch_runs_any_size(loaded):
    """(iv) Batches of 1, 3 and 5 through one program, each equal to the
    live predictor's (the batch dimension is a ``torch.export.Dim``)."""
    art, live = loaded["tpu_opt"]
    for n in (1, 3, 5):
        x = _tiles(10 + n, n)
        got = art.predict_batch(x)
        assert got.shape == (n, PATCH, PATCH, N_OUT)
        np.testing.assert_allclose(got, live.predict_batch(x), rtol=0, atol=1e-6)


def test_int8_leaves_match_jax_quantize_leaf(bundles, int8_art):
    """(iii) Every int8 value and scale of the port's artifact, mapped onto
    the flax tree (``to_flax_variables``), equals JAX's ``_quantize_leaf``
    of the same flax leaf bit for bit; the same leaves are quantized in
    both (the conv and attention kernels) and every other leaf (BatchNorm,
    biases, γ, the u vectors) stays float32 and equal to the bundle's."""
    m = _members(int8_art)
    header = json.loads(bytes(m["__utaot__"]).decode())
    assert header["format"] == tart.MAGIC and header["quantize"] == "int8"
    names, quantized = header["leaves"], header["quantized"]
    leaves = [m[f"w{i:05d}"] for i in range(header["n_leaves"])]
    scales = dict(zip(quantized, (m[f"s{j:05d}"] for j in range(len(quantized)))))
    q_sd = {names[i]: leaves[i].astype(np.float32) for i in quantized}
    s_sd = {names[i]: np.broadcast_to(scales[i], leaves[i].shape).astype(np.float32)
            for i in quantized}
    got_q, got_s = to_flax_variables(q_sd)["params"], to_flax_variables(s_sd)["params"]
    want = bundles["tpu_opt"]["variables"]
    n_quant = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want["params"])[0]:
        keys = [p.key for p in path]
        if not jart._quantizable(leaf):
            continue
        n_quant += 1
        wq, ws = jart._quantize_leaf(leaf)
        gq, gs = got_q, got_s
        for k in keys:
            gq, gs = gq[k], gs[k]
        np.testing.assert_array_equal(gq, wq.astype(np.float32), err_msg=str(keys))
        np.testing.assert_array_equal(gs, np.broadcast_to(ws, wq.shape), err_msg=str(keys))
    assert n_quant == len(quantized) > 0
    for i, (name, a) in enumerate(zip(names, leaves)):
        assert (a.dtype == np.int8) == (i in quantized), name
        if i not in quantized:
            assert a.dtype == np.float32, name
    assert any(n.endswith("running_var") for n in names)


def test_int8_artifact_equals_dequantized_live_model(bundles, int8_art):
    """(iii) The int8 artifact against the live model loaded with the
    dequantized weights: within 1e-5."""
    m = _members(int8_art)
    header = json.loads(bytes(m["__utaot__"]).decode())
    it = iter(m[f"s{j:05d}"] for j in range(len(header["quantized"])))
    sd = {}
    for i, name in enumerate(header["leaves"]):
        a = m[f"w{i:05d}"]
        sd[name] = torch.from_numpy(a.astype(np.float32) * next(it)
                                    if i in header["quantized"] else a.copy())
    live = _live(bundles["tpu_opt"]["bundle"])
    live.model.load_state_dict(sd, strict=True)
    x = _tiles(3, BATCH)
    got = tart.load_artifact(int8_art, device="cpu").predict_batch(x)
    np.testing.assert_allclose(got, live.predict_batch(x), rtol=0, atol=1e-5)
    assert Path(int8_art).stat().st_size < 0.35 * Path(bundles["tpu_opt"]["art"]).stat().st_size


def test_each_package_refuses_the_others_format(bundles, jax_arts):
    """(v) JAX's loader refuses a port artifact by its format tag; the
    port's refuses a JAX artifact, naming its own ``export``; both
    recognize either as an artifact."""
    b = bundles["tpu_opt"]
    jax_path = jax_arts["tpu_opt"]
    with pytest.raises(ValueError, match="unknown artifact format 'utaot-torch-v1'"):
        jart.load_artifact(b["art"])
    with pytest.raises(ValueError, match="python -m unet_tpu_torch export"):
        tart.load_artifact(str(jax_path), device="cpu")
    for path in (b["art"], str(jax_path)):
        assert tart.is_artifact(path) and jart.is_artifact(path)
    assert not tart.is_artifact(b["bundle"])


def test_loads_and_serves_without_model_building_code(bundles, monkeypatch, tmp_path):
    """(vi) With ``build_unet`` and ``load_bundle`` made to raise, the
    artifact still loads and serves a scene through ``predict_raster``."""
    def boom(*a, **k):
        raise AssertionError("model-building code called")

    for mod in (tunet, tckpt, tp):
        for name in ("build_unet", "load_bundle"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, boom)
    art = tart.load_artifact(bundles["tpu_opt"]["art"], batch_size=BATCH, device="cpu")
    img = np.random.default_rng(4).integers(0, 256, (3, 96, 128)).astype(np.uint8)
    write_raster(tmp_path / "s.tif", img, transform=TRANSFORM, crs=CRS)
    out, transform, crs = tp.predict_raster(None, str(tmp_path / "s.tif"), patch_size=PATCH,
                                            predictor=art, device="cpu")
    assert out.shape == (96, 128) and out.dtype == np.uint8 and crs == CRS


def test_header_platforms_and_archive_checks(bundles, tmp_path):
    """The header records the format, torch version, compute dtype and
    platforms; loading on a device the header does not list raises, as does
    an export for an unknown platform and a program archive that carries
    pickled sample inputs."""
    b = bundles["tpu_opt"]
    m = _members(b["art"])
    header = json.loads(bytes(m["__utaot__"]).decode())
    assert header["platforms"] == ["cpu", "cuda"] and header["dtype"] == "float32"
    assert header["torch_version"] == torch.__version__ and header["n_out"] == N_OUT
    only_cuda = _rewrite(b["art"], tmp_path / "cuda.uta", header={**header,
                                                                   "platforms": ["cuda"]})
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        tart.load_artifact(only_cuda, device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        tart.export_artifact(b["bundle"], str(tmp_path / "x.uta"), platforms=["tpu"],
                             device="cpu")
    src = zipfile.ZipFile(io.BytesIO(bytes(m["__program__"])))
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:
        for name in src.namelist():
            data = src.read(name)
            z.writestr(name, b"payload" if "/data/sample_inputs/" in name else data)
    bad = _rewrite(b["art"], tmp_path / "bad.uta", program=buf.getvalue())
    with pytest.raises(ValueError, match="sample inputs"):
        tart.load_artifact(bad, device="cpu")


def test_cli_export_then_serve_and_predict(bundles, tmp_path, capsys):
    """(vii) ``export`` through the CLI (bf16, the default), then ``serve``
    (whole tier and ``--stream``) and ``predict --merge --device-merge``
    with the ``.uta`` on the CPU: every output equal to the bundle's through
    the same commands."""
    b = bundles["tpu_opt"]
    uta = tmp_path / "m.uta"
    assert cli(["export", b["bundle"], str(uta), "--device", "cpu"]) == 0
    assert "Artifact written to" in capsys.readouterr().out
    img = np.random.default_rng(5).integers(0, 256, (3, 96, 120)).astype(np.uint8)
    write_raster(tmp_path / "s.tif", img, transform=TRANSFORM, crs=CRS)
    split_raster(str(tmp_path / "s.tif"), None, str(tmp_path / "t"), PATCH, 0.2,
                 max_empty=1.0)
    tiles = next((tmp_path / "t").rglob("img_tiles"))
    outs = {}
    for model, tag in ((b["bundle"], "bundle"), (str(uta), "uta")):
        for extra in ([], ["--stream"]):
            out = tmp_path / f"{tag}{len(extra)}.tif"
            assert cli(["serve", model, str(tmp_path / "s.tif"), str(out), "--patch-size",
                        str(PATCH), "--batch-size", str(BATCH), "--device", "cpu",
                        *extra]) == 0
            outs[tag, len(extra)] = read_raster(out)
        assert cli(["predict", model, str(tiles), "--merge", "--device-merge", "--aoi",
                    tag, "--year", "2026", "--batch-size", str(BATCH), "--device",
                    "cpu"]) == 0
        outs[tag, "merge"] = read_raster(next(tiles.parent.glob(f"{tag}_2026_*.tif")))
    for key in (0, 1, "merge"):
        got, want = outs["uta", key], outs["bundle", key]
        np.testing.assert_array_equal(got.data, want.data)
        assert tuple(got.transform) == tuple(want.transform) and got.crs == want.crs


def test_artifact_needs_cuda_unless_cpu_is_asked(bundles, tmp_path, monkeypatch, capsys):
    """(viii) Without a card and without ``device='cpu'`` / ``--device
    cpu``, loading, exporting and serving an artifact raise
    ``RuntimeError`` (the CLI exits 2 naming CUDA)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = bundles["tpu_opt"]
    with pytest.raises(RuntimeError, match="CUDA"):
        tart.load_artifact(b["art"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tart.export_artifact(b["bundle"], str(tmp_path / "x.uta"))
    assert cli(["serve", b["art"], "s.tif", str(tmp_path / "o.tif")]) == 2
    assert cli(["export", b["bundle"], str(tmp_path / "y.uta")]) == 2
    assert "CUDA" in capsys.readouterr().err
