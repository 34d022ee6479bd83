"""PyTorch port: the reference's own entry point (``api.Params``, ``main``,
``main_multi``, ``params_from_json``, ``run``) against the JAX package's on
the CPU: the parameter surface field for field, the extra-parameter gate,
the multi-run call sequence, the refusals of unported fields before any
stage, and one ``run`` of the three stages end to end."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from unet_tpu import api as jax_api
from unet_tpu.__main__ import cli as jax_cli
from unet_tpu.train.checkpoint import load_bundle as jax_load_bundle
from unet_tpu.utils import multirun as jax_multirun
from unet_tpu.utils import params_json as jax_params_json
from unet_tpu_torch import api
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.models import TPU_OPT_TOPOLOGY_VERSION, build_unet, init_weights
from unet_tpu_torch.parallel import mesh
from unet_tpu_torch.train import checkpoint as ckpt
from unet_tpu_torch.utils import multirun, params_json

torch.set_num_threads(2)
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
PORT_ONLY = {"device"}


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _plain(v):
    """Dataclasses (the augmentation config) as dicts, sequences as lists."""
    if dataclasses.is_dataclass(v):
        v = dataclasses.asdict(v)
    if isinstance(v, dict):
        return {k: _plain(a) for k, a in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(a) for a in v]
    return v


def test_params_has_every_jax_field_with_its_default():
    got, want = _fields(api.Params()), _fields(jax_api.Params())
    assert set(got) - set(want) == PORT_ONLY and got["device"] == "cuda"
    for k, v in want.items():
        assert _plain(got[k]) == _plain(v), k


@pytest.mark.parametrize("enabled", [False, True])
def test_extra_parameter_gate_matches_jax(enabled):
    kw = dict(enable_extra_parameters=enabled, ENCODER_FACTOR=3.0, LR_FINDER="valley",
              VALID_SCENES=["v2"], loss_func="focal", monitor="valid_loss",
              all_classes=True, specific_class=2, enable_regression=True, large_file=True,
              max_empty=0.5, ARCHITECTURE="xresnet18", self_attention=True)
    with pytest.warns(UserWarning) if enabled else _nothing():
        got = api.apply_extra_parameter_gate(api.Params(**kw))
    with pytest.warns(UserWarning) if enabled else _nothing():
        want = jax_api.apply_extra_parameter_gate(jax_api.Params(**kw))
    g, w = _fields(got), _fields(want)
    assert {k: _plain(v) for k, v in g.items() if k not in PORT_ONLY} == \
        {k: _plain(v) for k, v in w.items()}


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_trainer_config_matches_jax_field_for_field():
    """Every field of JAX's ``trainer_config`` but its device list; the port
    adds the device."""
    kw = dict(data_path="d", model_path="m", description="x", BATCH_SIZE=8, EPOCHS=3,
              LEARNING_RATE=3e-4, ARCHITECTURE="xresnet50", CODES=["a", "b"],
              enable_regression=True, CLASS_WEIGHTS=[0.3, 0.7], ENCODER_FACTOR=5.0,
              LR_FINDER="steep", loss_func="mse", monitor="rmse", self_attention=True,
              VALID_SCENES=["v"], transforms=False, split_idx=None, n_transform_imgs=0.5,
              existing_model="e", pretrained_weights="w.pth", export_model_summary=False,
              visualize_data_example=False, info="i", class_zero=True, normalize="unit",
              reference_quirks=True, tpu_opt=False, bf16=False, seed=5, checkpoint_every=2,
              resume=True, grad_accum=2)
    got = _fields(api.trainer_config(api.Params(device="cpu", **kw)))
    want = _fields(jax_api.trainer_config(jax_api.Params(**kw)))
    assert got.pop("device") == "cpu" and want.pop("devices") is None
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert _plain(got[k]) == _plain(v), k


@pytest.mark.parametrize("values,n", [(3, 2), ([1], 3), (["a", "b"], 2), ((1, 2, 3), 3)])
def test_broadcast_matches_jax(values, n):
    assert multirun.broadcast(values, n) == jax_multirun.broadcast(values, n)
    assert multirun.check_and_fill([[1], [1, 2]], 2) == jax_multirun.check_and_fill([[1], [1, 2]], 2)


def test_mismatched_lists_raise_in_both():
    for mod in (multirun, jax_multirun):
        with pytest.raises(ValueError, match="has 3 elements; expected 2"):
            mod.broadcast([1, 2, 3], 2)


def test_params_json_helpers_match_jax(tmp_path):
    (tmp_path / "p.json").write_text(json.dumps({"a": 1, "b": [1, 2]}))
    assert params_json.load_json_params(str(tmp_path / "p.json")) == \
        jax_params_json.load_json_params(str(tmp_path / "p.json"))
    assert params_json.load_split_raster_params is params_json.load_json_params
    pts = np.array([1.0, 1.1, 0.9, 1.05, 9.0])
    np.testing.assert_array_equal(params_json.is_outlier(pts), jax_params_json.is_outlier(pts))
    with pytest.raises(FileNotFoundError):
        params_json.load_json_params(str(tmp_path / "absent.json"))


def test_params_from_json_round_trip_and_unknown_key(tmp_path):
    p = api.Params(Train=True, BATCH_SIZE=8, CODES=["x", "y"], device="cpu",
                   aug_pipe=api.AugmentConfig(rot90_p=0.5))
    raw = {k: _plain(v) for k, v in _fields(p).items()}
    (tmp_path / "c.json").write_text(json.dumps(raw))
    back = api.params_from_json(tmp_path / "c.json")
    assert {k: _plain(v) for k, v in _fields(back).items()} == raw
    del raw["device"]
    (tmp_path / "j.json").write_text(json.dumps(raw))
    jback = jax_api.params_from_json(tmp_path / "j.json")
    assert {k: _plain(v) for k, v in _fields(jback).items()} == raw
    (tmp_path / "bad.json").write_text(json.dumps({"Train": True, "EPOCHS_": 3}))
    for load in (api.params_from_json, jax_api.params_from_json):
        with pytest.raises(ValueError, match="Unknown parameters.*EPOCHS_"):
            load(tmp_path / "bad.json")


@pytest.fixture
def recorded(monkeypatch):
    """The three stages of both packages' api replaced by recorders."""
    calls = {"port": [], "jax": []}
    for key, mod in (("port", api), ("jax", jax_api)):
        monkeypatch.setattr(mod, "split_raster",
                            lambda _k=key, **kw: calls[_k].append(("tile", kw)))
        monkeypatch.setattr(mod, "train_model",
                            lambda cfg, _k=key: calls[_k].append(("train", _fields(cfg))))
    import unet_tpu.predict as jax_predict
    import unet_tpu_torch.predict.predict as port_predict

    for key, mod in (("port", port_predict), ("jax", jax_predict)):
        monkeypatch.setattr(mod, "save_predictions",
                            lambda *a, _k=key, **kw: calls[_k].append(("predict", a, kw)))
    return calls


MULTI = dict(Create_tiles=True, Train=True, Predict=True,
             image_path=["a.tif", "b.tif"], mask_path=["m.tif"], base_dir=["ta", "tb"],
             patch_size=64, model_path=["ma", "mb"], data_path=["ta", "tb"],
             description=["da", "db"], EPOCHS=[1, 2], CODES=["x", "y"],
             predict_model=["ma/da", "mb/db"], predict_path="p", merge=[True, False],
             AOI="A", year="2026", visualize_data_example=False, validation_vision=False,
             LR_FINDER="valley")


def _same_calls(port, jax_calls):
    assert [c[0] for c in port] == [c[0] for c in jax_calls]
    for got, want in zip(port, jax_calls):
        if got[0] == "tile":
            assert got[1] == want[1]
        elif got[0] == "train":
            g, w = dict(got[1]), dict(want[1])
            assert g.pop("device") == "cpu" and w.pop("devices") is None
            assert {k: _plain(v) for k, v in g.items()} == {k: _plain(v) for k, v in w.items()}
        else:
            assert got[1] == want[1]
            g = dict(got[2])
            assert g.pop("device") == "cpu" and g == want[2]


@pytest.mark.parametrize("multi", [False, True])
def test_stage_call_sequence_matches_jax(recorded, tmp_path, multi):
    """``run [--multi]`` through both CLIs, the stages recorded: the same
    calls with the same arguments in the same order (the gate resets
    LR_FINDER in both; the port adds its device)."""
    cfg = dict(MULTI) if multi else {k: (v[0] if isinstance(v, list) and k != "CODES" else v)
                                      for k, v in MULTI.items()}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    extra = ["--multi"] if multi else []
    assert cli(["run", str(tmp_path / "c.json"), "--device", "cpu", *extra]) == 0
    assert jax_cli(["run", str(tmp_path / "c.json"), *extra]) in (0, None)
    assert len(recorded["port"]) == (6 if multi else 3)
    _same_calls(recorded["port"], recorded["jax"])
    assert all(c[1]["lr_finder"] is None for c in recorded["port"] if c[0] == "train")


@pytest.mark.parametrize("field,value,stages", [
    ("visualize_data_example", True, dict(Train=True)),
    ("validation_vision", True, dict(Predict=True)),
    ("spatial", 2, dict(Create_tiles=True)),
    ("predict_model", "uta", dict(Predict=True, validation_vision=False))])
def test_unported_fields_are_refused_before_any_stage(recorded, tmp_path, field, value,
                                                      stages, monkeypatch):
    """Each field whose feature is not ported is named, before any stage
    runs; a JSON config then exits 2 through ``run``. The two fields
    ported since (``visualize_data_example``, ``validation_vision``) pass
    the check: ``run`` calls the stages with the field set, as JAX's
    does. ``spatial``, ported since, passes it too: ``main``,
    ``main_multi`` and ``run`` hand the whole run to the launcher
    (``mesh.launch``, recorded here) and run no stage themselves; a rank's
    failure raises, and ``run`` exits 2."""
    base = dict(Create_tiles=True, Train=True, Predict=True, visualize_data_example=False,
                validation_vision=False, image_path="a.tif", base_dir="t")
    base.update(stages)
    if value == "uta":
        value = str(tmp_path / "model.uta")
        with open(value, "wb") as f:
            np.savez(f, __utaot__=np.zeros(1))
    base[field] = value
    p = api.Params(device="cpu", **base)
    if field in ("visualize_data_example", "validation_vision"):
        api.check_ported(p)
        (tmp_path / "c.json").write_text(json.dumps(base))
        assert cli(["run", str(tmp_path / "c.json"), "--device", "cpu"]) == 0
        assert jax_cli(["run", str(tmp_path / "c.json")]) in (0, None)
        assert [c[0] for c in recorded["port"]] == ["tile", "train", "predict"]
        _same_calls(recorded["port"], recorded["jax"])
        got = (recorded["port"][1][1]["visualize_data_example"]
               if field == "visualize_data_example" else recorded["port"][2][1][9])
        assert got is True
        return
    if field == "spatial":
        launched, rc = [], [0]

        def launch(n, target, args=(), device="cuda"):
            launched.append((n, target, args[0].spatial, device))
            return rc[0]

        monkeypatch.setattr(mesh, "launch", launch)
        api.check_ported(p)
        api.main(p)
        api.main_multi(p)
        (tmp_path / "c.json").write_text(json.dumps(base))
        assert cli(["run", str(tmp_path / "c.json"), "--device", "cpu"]) == 0
        assert launched == [(2, "unet_tpu_torch.api:main", 2, "cpu"),
                            (2, "unet_tpu_torch.api:main_multi", 2, "cpu"),
                            (2, "unet_tpu_torch.api:main", 2, "cpu")]
        rc[0] = 3
        with pytest.raises(RuntimeError, match="spatial=2: a rank exited with code 3"):
            api.main(p)
        assert cli(["run", str(tmp_path / "c.json"), "--device", "cpu"]) == 2
        assert recorded["port"] == []
        return
    for main in (api.main, api.main_multi):
        with pytest.raises(NotImplementedError, match=f"not yet ported: .*{field.split('_')[0]}"):
            main(p)
    assert recorded["port"] == []
    (tmp_path / "c.json").write_text(json.dumps(base))
    assert cli(["run", str(tmp_path / "c.json"), "--device", "cpu"]) == 2
    assert recorded["port"] == []


def test_run_needs_cuda_unless_cpu_is_asked(recorded, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "c.json").write_text(json.dumps({"Create_tiles": True, "image_path": "a.tif",
                                                 "base_dir": "t"}))
    assert cli(["run", str(tmp_path / "c.json")]) == 2
    assert "CUDA" in capsys.readouterr().err and recorded["port"] == []
    assert cli(["run", str(tmp_path / "c.json"), "--device", "cpu"]) == 0
    assert [c[0] for c in recorded["port"]] == ["tile"]


def _tree(base: Path) -> dict:
    return {str(p.relative_to(base)): p.read_bytes()
            for p in sorted(base.rglob("*")) if p.is_file() and "_tiles" in str(p.parent)}


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_run_end_to_end_matches_jax(tmp_path):
    """``run`` with Create_tiles, Train and Predict on a 256² scene: 64²
    tiles, xresnet18 for 1 epoch from one starting bundle
    (``existing_model``), transforms off, float32, the tiles merged. The
    tile trees are byte-equal; the weights' updates from the shared start
    differ between the packages by a median of at most 10% and a worst
    leaf of at most 35% relative L2 (both compute in float32; Adam moves
    each weight by about the LR whatever its gradient's size, so rounding
    in small gradients shows there: ``tests/test_torch_resume.py``); the
    merged class maps agree on at least 99% of their pixels."""
    rng = np.random.default_rng(0)
    img = np.kron(rng.integers(0, 256, (3, 32, 32)), np.ones((8, 8), np.int64)).astype(np.uint8)
    mask = np.where(img[0] > 160, 1, np.where(img[1] > 160, 2, 0)).astype(np.uint8)
    write_raster(tmp_path / "scene.tif", img, transform=TRANSFORM, crs="EPSG:25832")
    write_raster(tmp_path / "mask.tif", mask[None], transform=TRANSFORM, crs="EPSG:25832")
    model = init_weights(build_unet("xresnet18", n_out=3, c_in=3),
                         torch.Generator().manual_seed(0))
    ckpt.export_bundle(tmp_path / "init", "init", ckpt.to_flax_variables(model.state_dict()),
                       {"ARCHITECTURE": "xresnet18", "tpu_opt": True, "self_attention": False,
                        "n_out": 3, "number_of_bands": 3, "patch_size": 64,
                        "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION})
    out = {}
    for pkg, run in (("port", lambda c: cli(["run", c, "--device", "cpu"])),
                     ("jax", lambda c: jax_cli(["run", c]))):
        d = tmp_path / pkg
        cfg = dict(Create_tiles=True, Train=True, Predict=True,
                   image_path=str(tmp_path / "scene.tif"), mask_path=str(tmp_path / "mask.tif"),
                   base_dir=str(d / "tiles"), patch_size=64, split=[0.8, 0.2],
                   data_path=str(d / "tiles"), model_path=str(d / "models"), description="r",
                   existing_model=str(tmp_path / "init"), BATCH_SIZE=4, EPOCHS=1,
                   LEARNING_RATE=1e-3, visualize_data_example=False,
                   export_model_summary=False, CODES=["background", "a", "b"],
                   predict_path=str(d / "tiles" / "vali" / "img_tiles"),
                   predict_model=str(d / "models" / "r"), AOI="A", year="2026", merge=True,
                   validation_vision=False, enable_extra_parameters=True,
                   ARCHITECTURE="xresnet18", transforms=False, max_empty=1.0, bf16=False,
                   normalize="unit", seed=0, predict_batch_size=4)
        (tmp_path / f"{pkg}.json").write_text(json.dumps(cfg))
        with pytest.warns(UserWarning, match="Extra parameters are enabled"):
            assert run(str(tmp_path / f"{pkg}.json")) in (0, None)
        out[pkg] = d
    port_tiles, jax_tiles = _tree(out["port"] / "tiles"), _tree(out["jax"] / "tiles")
    assert len(port_tiles) == 32 and port_tiles == jax_tiles
    got = dict(_leaves(ckpt.load_weights(out["port"] / "models" / "r" / "r.msgpack")))
    _, want_tree, _ = jax_load_bundle(out["jax"] / "models" / "r")
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, want_tree)))
    init = dict(_leaves(ckpt.load_weights(tmp_path / "init" / "init.msgpack")))
    assert got.keys() == want.keys()
    rel = {k: np.linalg.norm(got[k] - w) / max(np.linalg.norm(w - init[k]), 1e-30)
           for k, w in want.items() if k.startswith("params/")}
    assert np.median(list(rel.values())) <= 0.1
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 0.35, (worst, rel[worst])
    maps = [read_raster(out[pkg] / "tiles" / "vali" / "A_2026_r_prediction.tif")
            for pkg in ("port", "jax")]
    assert maps[0].data.dtype == np.uint8 and maps[0].data.shape == maps[1].data.shape
    assert tuple(maps[0].transform) == tuple(maps[1].transform)
    assert (maps[0].data == maps[1].data).mean() >= 0.99


def test_run_with_the_reference_figure_defaults(tmp_path, capsys):
    """``run`` with JAX's ``Params`` defaults for ``visualize_data_example``
    and ``validation_vision`` (True, left out of the JSON): the three stages
    on a 128² scene cut into 32² tiles, xresnet18 for 1 epoch, the
    validation tiles predicted tile by tile. The batch's two lines and
    histograms, the loss plot, the matrix and the report come out, and the
    validation figures sit beside the predicted tiles."""
    assert api.Params().visualize_data_example and api.Params().validation_vision
    rng = np.random.default_rng(1)
    img = np.kron(rng.integers(0, 256, (3, 16, 16)), np.ones((8, 8), np.int64)).astype(np.uint8)
    mask = np.where(img[0] > 160, 1, np.where(img[1] > 160, 2, 0)).astype(np.uint8)
    write_raster(tmp_path / "scene.tif", img, transform=TRANSFORM, crs="EPSG:25832")
    write_raster(tmp_path / "mask.tif", mask[None], transform=TRANSFORM, crs="EPSG:25832")
    tiles = tmp_path / "tiles"
    cfg = dict(Create_tiles=True, Train=True, Predict=True,
               image_path=str(tmp_path / "scene.tif"), mask_path=str(tmp_path / "mask.tif"),
               base_dir=str(tiles), patch_size=32, split=[0.75, 0.25], data_path=str(tiles),
               model_path=str(tmp_path / "models"), description="d", BATCH_SIZE=4,
               EPOCHS=1, LEARNING_RATE=1e-3, export_model_summary=False,
               CODES=["background", "a", "b"], predict_path=str(tiles / "vali" / "img_tiles"),
               predict_model=str(tmp_path / "models" / "d"), enable_extra_parameters=True,
               ARCHITECTURE="xresnet18", max_empty=1.0, bf16=False, seed=0,
               predict_batch_size=4)
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    with pytest.warns(UserWarning, match="Extra parameters are enabled"):
        assert cli(["run", str(tmp_path / "c.json"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Input shape: (4, 32, 32, 3), Output shape: (4, 32, 32)" in out
    assert "Confusion Matrix:" in out and "Classification Report:" in out
    bundle = tmp_path / "models" / "d"
    for name in ("d_image_plot.png", "d_mask_plot.png", "d_history.png", "d_history.csv"):
        assert (bundle / name).is_file(), name
    valid = tiles / "vali" / "predicted_tiles_d" / "Valid_figures"
    assert sorted(p.name for p in valid.glob("*.png")) == ["Confusion_Matrix.png",
                                                           "classification_report.png"]
