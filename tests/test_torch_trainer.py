"""PyTorch port, the slice end to end: ``python -m unet_tpu_torch train`` on
the CPU, the bundle it exports read back by the JAX package and served by
the port, the training flags, and the options that are not ported yet."""

import csv
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.train import loop as jax_loop
from unet_tpu.train.checkpoint import load_bundle as jax_load_bundle
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.data import AugmentConfig
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.train import loop
from unet_tpu_torch.train.checkpoint import load_bundle

torch.set_num_threads(2)
TILE, N_TRAIN, N_VALID = 32, 8, 3
CODES = ["background", "building", "vegetation"]
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)


def _scene(rng, h, w):
    """3-band uint8 blocks; class 1 where band 0 is bright, class 2 where
    band 1 is, else 0 — a function of the image."""
    blocks = rng.integers(0, 256, (3, h // 8, w // 8)).astype(np.uint8)
    img = np.kron(blocks, np.ones((8, 8), np.uint8))
    mask = np.where(img[0] > 160, 1, np.where(img[1] > 160, 2, 0)).astype(np.uint8)
    return img, mask


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    for scene, n in (("trai", N_TRAIN), ("vali", N_VALID)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / "tiles" / scene / sub).mkdir(parents=True)
        for i in range(n):
            img, mask = _scene(rng, TILE, TILE)
            write_raster(root / "tiles" / scene / "img_tiles" / f"{i}.tif", img,
                         transform=TRANSFORM, crs="EPSG:25832")
            write_raster(root / "tiles" / scene / "mask_tiles" / f"{i}.tif", mask[None],
                         transform=TRANSFORM, crs="EPSG:25832")
    img, _ = _scene(rng, 72, 80)
    write_raster(root / "scene.tif", img, transform=TRANSFORM, crs="EPSG:25832")
    args = [str(root / "tiles"), "--model-path", str(root / "models"),
            "--description", "run", "--codes", *CODES, "--arch", "xresnet18",
            "--batch-size", "4", "--epochs", "2", "--lr", "1e-3", "--seed", "0",
            "--device", "cpu"]
    rc = cli(["train", *args, "--stats-json", str(root / "stats.json")])
    return {"root": root, "rc": rc, "args": args, "bundle": root / "models" / "run",
            "stats": json.loads((root / "stats.json").read_text())}


def test_cli_train_on_cpu_exports_the_bundle(trained):
    assert trained["rc"] == 0
    b = trained["bundle"]
    for name in ("run.json", "run.msgpack", "best-model.msgpack", "run_history.csv"):
        assert (b / name).is_file(), name
    st = trained["stats"]
    assert st["device"] == "cpu" and st["steps"] == 2 * (N_TRAIN // 4)
    assert len(st["step_ms"]) == st["steps"]
    assert st["launches"] == {"bn_sum_sumsq": 0, "bn_bwd_sums": 0, "flip_scale": 0}
    # SaveModelCallback: the exported weights are the best epoch's
    assert (b / "run.msgpack").read_bytes() == (b / "best-model.msgpack").read_bytes()


def test_cli_train_stats_report_the_loader_path(trained):
    """The train loader decoded its first batch both ways and kept one."""
    loader = trained["stats"]["loader"]
    assert loader["path"] in ("native", "python")
    assert set(loader["first_batch_ms"]) == {"native", "python"}
    assert all(v > 0 for v in loader["first_batch_ms"].values())


def test_history_csv_has_the_jax_columns(trained):
    with open(trained["bundle"] / "run_history.csv") as f:
        rows = list(csv.DictReader(f))
    assert list(rows[0]) == ["epoch", "train_loss", "valid_loss", "dice_multi", "time"]
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    for r in rows:
        for k in ("train_loss", "valid_loss", "dice_multi"):
            assert math.isfinite(float(r[k]))
        assert 0.0 <= float(r["dice_multi"]) <= 1.0
    assert rows == [{k: str(v) for k, v in r.items()} for r in trained["stats"]["history"]]


def test_manifest_equals_the_jax_trainers(trained):
    """The same configuration gives the manifest ``unet_tpu train`` writes."""
    cfg = jax_loop.TrainerConfig(
        data_path=trained["root"] / "tiles", model_path=trained["root"] / "models",
        description="run", codes=CODES, arch="xresnet18", batch_size=4, epochs=2,
        lr=1e-3, seed=0, loader_threads=2)
    jt = jax_loop.Trainer(cfg)
    try:
        want = jt.manifest()
    finally:
        jt.close()
    got = json.loads((trained["bundle"] / "run.json").read_text())
    assert got.pop("bn_variant") is None  # the port's own key: plain BatchNorm
    assert got == json.loads(json.dumps(want))


def test_jax_load_bundle_reads_it_and_forwards_equal(trained):
    """JAX's load_bundle reads the exported weights; JAX's float32 forward
    on them equals the port's: rtol 1e-4, atol 1e-4·max|jax| (float32
    convolutions in another order)."""
    _, variables, manifest = jax_load_bundle(trained["bundle"])
    assert manifest["tpu_opt"] and manifest["ARCHITECTURE"] == "xresnet18"
    x = np.random.default_rng(1).uniform(0, 1, (2, TILE, TILE, 3)).astype(np.float32)
    jm = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float32, tpu_opt=True)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    model, _ = load_bundle(trained["bundle"], dtype=torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    leaves = jax.tree_util.tree_leaves(variables["batch_stats"])
    assert leaves and all(np.all(np.isfinite(a)) for a in leaves)


def test_trainer_starts_from_flax_variables_and_exports_them(trained, tmp_path):
    """init_state takes a flax tree (from_flax_variables); export writes it
    back (to_flax_variables) so that JAX's load_bundle returns the same
    arrays, bit for bit."""
    x = np.zeros((1, TILE, TILE, 3), np.float32)
    jm = jax_build_unet("xresnet18", n_out=3, c_in=3, tpu_opt=True)
    v = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3), x, train=False))
    t = loop.Trainer(loop.TrainerConfig(data_path=trained["root"] / "tiles",
                                        model_path=tmp_path, description="same",
                                        codes=CODES, arch="xresnet18", batch_size=4,
                                        device="cpu"))
    try:
        t.init_state(v)
        t.export()
    finally:
        t.close()
    _, back, _ = jax_load_bundle(tmp_path / "same")
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(back)[0],
                                 jax.tree_util.tree_flatten_with_path(v)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))


def test_port_serves_the_trained_bundle(trained, tmp_path):
    out = tmp_path / "out.tif"
    rc = cli(["serve", str(trained["bundle"]), str(trained["root"] / "scene.tif"),
              str(out), "--patch-size", str(TILE), "--batch-size", "4", "--device", "cpu"])
    assert rc == 0
    r = read_raster(out)
    assert r.data.dtype == np.uint8 and r.data.shape == (1, 72, 80)
    assert int(r.data.max()) < len(CODES) and tuple(r.transform) == TRANSFORM


def test_training_repeats_bit_for_bit_with_its_seed(trained, tmp_path):
    """Seeded shuffle and flip flags: a second run gives the same history
    and weights."""
    args = list(trained["args"])
    args[args.index("--model-path") + 1] = str(tmp_path)
    assert cli(["train", *args]) == 0
    again = tmp_path / "run"
    assert (again / "run_history.csv").read_text().split("\n")[1].split(",")[:4] == \
        (trained["bundle"] / "run_history.csv").read_text().split("\n")[1].split(",")[:4]
    assert (again / "run.msgpack").read_bytes() == \
        (trained["bundle"] / "run.msgpack").read_bytes()


@pytest.mark.parametrize("flag", [
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"], ["--process-id", "0"]])
def test_unported_train_options_fail_clearly(trained, flag, capsys):
    """The multi-process flags are ported (tests/test_torch_distributed.py);
    one of them without the other two exits 2 and names what is missing,
    before any process group or training starts."""
    assert cli(["train", *trained["args"], *flag]) == 2
    err = capsys.readouterr().err
    assert f"{flag[0]} given without" in err and "needs all three" in err
    assert "not yet ported" not in err


@pytest.mark.parametrize("flag,want", [
    (["--lr-finder", "valley"], {"lr_finder": "valley"}),
    (["--existing-model", "m"], {"existing_model": "m"}),
    (["--pretrained-weights", "w.pth"], {"pretrained_weights": "w.pth"}),
    (["--grad-accum", "2"], {"grad_accum": 2}),
    (["--regression"], {"regression": True}),
    (["--no-tpu-opt", "--grad-accum", "2"], {"tpu_opt": False, "grad_accum": 2}),
    (["--self-attention", "--regression"], {"self_attention": True, "regression": True}),
    (["--profile-dir", "prof"], {"profile_dir": "prof"}),
    (["--reference-quirks"], {"reference_quirks": True})])
def test_train_options_reach_the_trainer_config(trained, flag, want, monkeypatch):
    """Each training flag of the JAX CLI parses into the TrainerConfig
    field ``unet_tpu train`` sets from it; the other fields keep the
    values of the base arguments. (The runs themselves are held against
    JAX in tests/test_torch_{losses,regression,lr_find,pretrained,
    trainer_surface}.py.)"""
    seen = []

    class Capture:
        def __init__(self, cfg):
            seen.append(cfg)
            self.device = torch.device("cpu")

    monkeypatch.setattr(loop, "Trainer", Capture)
    monkeypatch.setattr(loop, "train_model", lambda cfg, trainer: "bundle")
    assert cli(["train", *trained["args"], *flag]) == 0
    (cfg,) = seen
    base = loop.TrainerConfig(data_path=trained["root"] / "tiles", codes=CODES)
    for name, value in want.items():
        assert getattr(cfg, name) == value, name
    for name in ("lr_finder", "existing_model", "pretrained_weights", "grad_accum",
                 "regression", "profile_dir", "reference_quirks", "self_attention"):
        if name not in want:
            assert getattr(cfg, name) == getattr(base, name), name
    assert (cfg.arch, cfg.batch_size, cfg.device) == ("xresnet18", 4, "cpu")


def test_unported_trainer_settings_raise(trained):
    """The settings beyond the default path build a trainer as JAX's does:
    rot90 in the manifest's augmentation map, the dice loss, and the
    r2_score monitor maximized (the JAX rule); a batch that does not
    split into grad_accum microbatches raises in both."""
    base = dict(data_path=trained["root"] / "tiles", codes=CODES, arch="xresnet18",
                batch_size=4, epochs=1)
    jt = jax_loop.Trainer(jax_loop.TrainerConfig(
        aug=jax_loop.AugmentConfig(rot90_p=0.5), loss_func="dice", monitor="r2_score",
        loader_threads=2, **base))
    t = loop.Trainer(loop.TrainerConfig(aug=AugmentConfig(rot90_p=0.5), loss_func="dice",
                                        monitor="r2_score", loader_threads=2,
                                        device="cpu", **base))
    try:
        got = t.manifest()
        assert got.pop("bn_variant") is None  # the port's own key: plain BatchNorm
        assert got == jt.manifest()
        assert (t.monitor, t.comp) == (jt.monitor, jt.comp) == ("r2_score", np.greater)
        rng = np.random.default_rng(9)
        logits = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
        y = rng.integers(0, 3, (2, 8, 8))
        want = float(jt.loss_fn(jnp.asarray(logits), jnp.asarray(y)))
        got = t.loss_fn(torch.from_numpy(np.moveaxis(logits, 3, 1).copy()), torch.from_numpy(y))
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)  # float32 sum order
    finally:
        t.close()
        jt.close()
    for trainer in (loop.Trainer, jax_loop.Trainer):
        cfg = (loop.TrainerConfig(device="cpu", grad_accum=3, **base)
               if trainer is loop.Trainer else jax_loop.TrainerConfig(grad_accum=3, **base))
        with pytest.raises(ValueError, match="grad_accum"):
            trainer(cfg)


def test_train_needs_cuda_unless_cpu_is_asked(trained, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in trained["args"] if a not in ("--device", "cpu")]
    assert cli(["train", *args]) == 2
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.Trainer(loop.TrainerConfig(data_path=trained["root"] / "tiles", codes=CODES))
