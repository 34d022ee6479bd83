"""PyTorch port: training the parity topology with self-attention on the
CPU, against the JAX package.

One training-mode step of the parity+SA U-Net (loss, every gradient, the
running statistics and the power-iteration vectors) against JAX at
float64; ``python -m unet_tpu_torch train --no-tpu-opt --self-attention``
end to end with the bundle read back by JAX; and the fallback to the
parity topology for tiles whose sides are not divisible by 4.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_parity import jax_variables, nchw
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.train import loop as jax_loop
from unet_tpu.train import losses as jl
from unet_tpu.train.checkpoint import load_bundle as jax_load_bundle
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.train import loop
from unet_tpu_torch.train import losses as tl
from unet_tpu_torch.train.checkpoint import (from_flax_variables, load_weights,
                                             to_flax_variables)

torch.set_num_threads(2)
TILE, N_TRAIN, N_VALID = 32, 8, 3
CODES = ["background", "building", "vegetation"]
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)


def test_parity_sa_train_step_matches_jax_float64():
    """xresnet18 parity + self-attention, 48², batch 2, 3 classes, train
    mode, weighted CE on the full-resolution logits, backward. The port
    runs at float32, JAX at float64 (its float32 gradients are not a tight
    reference on the CPU, tests/test_torch_train.py). At 48² the attention
    runs on a 6×6 grid and the odd grids (3 → 6) take the resize path; at
    32² and 64² the float32 gradients of this random net, JAX's own
    included, drift up to 5e-2 (relative to each tensor's largest) from
    float64 at these seeds, at 48² the port's stay within 5e-5. Loss within rtol
    1e-5; each gradient within atol 1e-4·max|grad| + rtol 1e-3; the updated
    batch_stats within 1e-5, the new u vectors within 1e-6."""
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, size=(2, 48, 48, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=(2, 48, 48)).astype(np.int32)
    weight = np.array([0.2, 0.5, 0.3], np.float32)
    init = jax_build_unet("xresnet18", n_out=3, c_in=3, self_attention=True,
                          dtype=jnp.float32, tpu_opt=False)
    v = jax_variables(init, x, rng, train=False)
    with jax.enable_x64():
        jmodel = jax_build_unet("xresnet18", n_out=3, c_in=3, self_attention=True,
                                dtype=jnp.float64, tpu_opt=False)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        loss_fn = jl.build_loss(None, False, jnp.asarray(weight, jnp.float64))

        def forward_loss(params, batch_stats, images, masks):
            logits, updates = jmodel.apply({"params": params, "batch_stats": batch_stats},
                                           images, train=True, fold_logits=True,
                                           mutable=["batch_stats"])
            assert logits.shape[1] == masks.shape[1]  # full resolution: no folding
            return loss_fn(logits, masks), updates["batch_stats"]

        (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(
            forward_loss, has_aux=True))(v64["params"], v64["batch_stats"],
                                         jnp.asarray(x, jnp.float64), jnp.asarray(y))
        want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
        want_stats = jax.tree_util.tree_map(np.asarray, want_stats)

    model = build_unet("xresnet18", n_out=3, c_in=3, self_attention=True,
                       dtype=torch.float32, tpu_opt=False).train()
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in from_flax_variables(v).items()}, strict=True)
    logits = model(nchw(x), fold_logits=True)
    assert logits.shape == (2, 3, 48, 48)
    loss = tl.cross_entropy(logits, torch.from_numpy(y), torch.from_numpy(weight))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)

    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    got = to_flax_variables(sd)
    flat = jax.tree_util.tree_flatten_with_path
    assert jax.tree_util.tree_structure(got["params"]) == \
        jax.tree_util.tree_structure(want_grads)
    for (path, g), (_, w_) in zip(flat(got["params"])[0], flat(want_grads)[0]):
        np.testing.assert_allclose(g, w_, rtol=1e-3, atol=1e-4 * np.abs(w_).max(),
                                   err_msg=jax.tree_util.keystr(path))
    assert np.abs(got["params"]["up_1"]["sa"]["gamma"]).max() > 0
    for (path, s), (_, w_) in zip(flat(got["batch_stats"])[0], flat(want_stats)[0]):
        name = path[-1].key
        tol = 1e-6 if name.endswith("_u") else 1e-5
        np.testing.assert_allclose(s, w_, rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))
    moved = got["batch_stats"]["up_1"]["sa"]["value_u"] - v["batch_stats"]["up_1"]["sa"]["value_u"]
    assert np.abs(moved).max() > 1e-6


def _scene(rng, h, w):
    """3-band uint8 blocks; class 1 where band 0 is bright, class 2 where
    band 1 is, else 0 — a function of the image."""
    blocks = rng.integers(0, 256, (3, -(-h // 8), -(-w // 8))).astype(np.uint8)
    img = np.kron(blocks, np.ones((8, 8), np.uint8))[:, :h, :w]
    mask = np.where(img[0] > 160, 1, np.where(img[1] > 160, 2, 0)).astype(np.uint8)
    return img, mask


def _tiles(root, tile, seed=0):
    rng = np.random.default_rng(seed)
    for scene, n in (("trai", N_TRAIN), ("vali", N_VALID)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            img, mask = _scene(rng, tile, tile)
            write_raster(root / scene / "img_tiles" / f"{i}.tif", img,
                         transform=TRANSFORM, crs="EPSG:25832")
            write_raster(root / scene / "mask_tiles" / f"{i}.tif", mask[None],
                         transform=TRANSFORM, crs="EPSG:25832")
    return root


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity_train")
    _tiles(root / "tiles", TILE)
    img, _ = _scene(np.random.default_rng(1), 72, 80)
    write_raster(root / "scene.tif", img, transform=TRANSFORM, crs="EPSG:25832")
    args = [str(root / "tiles"), "--model-path", str(root / "models"),
            "--description", "par", "--codes", *CODES, "--arch", "xresnet18",
            "--batch-size", "4", "--epochs", "1", "--lr", "1e-3", "--seed", "0",
            "--no-tpu-opt", "--self-attention", "--device", "cpu"]
    rc = cli(["train", *args, "--stats-json", str(root / "stats.json")])
    return {"root": root, "rc": rc, "args": args, "bundle": root / "models" / "par",
            "stats": json.loads((root / "stats.json").read_text())}


def test_cli_trains_parity_with_self_attention(trained):
    assert trained["rc"] == 0
    b = trained["bundle"]
    for name in ("par.json", "par.msgpack", "best-model.msgpack", "par_history.csv"):
        assert (b / name).is_file(), name
    st = trained["stats"]
    assert st["steps"] == N_TRAIN // 4
    assert st["launches"] == {"bn_sum_sumsq": 0, "bn_bwd_sums": 0, "flip_scale": 0}
    for row in st["history"]:
        assert all(math.isfinite(row[k]) for k in ("train_loss", "valid_loss", "dice_multi"))
    m = json.loads((b / "par.json").read_text())
    assert m["tpu_opt"] is False and m["tpu_opt_topology"] is None
    assert m["self_attention"] is True


def test_trained_u_vectors_moved_from_their_init(trained):
    """Training mode advanced the power iteration, and the export carries
    the u buffers (``batch_stats``)."""
    model = build_unet("xresnet18", n_out=3, c_in=3, self_attention=True, tpu_opt=False)
    init = to_flax_variables(init_weights(model, torch.Generator().manual_seed(0))
                             .state_dict())["batch_stats"]["up_1"]["sa"]
    got = load_weights(trained["bundle"] / "par.msgpack")["batch_stats"]["up_1"]["sa"]
    for name in ("query_u", "key_u", "value_u"):
        assert got[name].shape == init[name].shape
        assert abs(float(np.linalg.norm(got[name])) - 1) < 1e-5
        assert np.abs(got[name] - init[name]).max() > 1e-4, name


def test_manifest_equals_the_jax_trainers(trained):
    cfg = jax_loop.TrainerConfig(
        data_path=trained["root"] / "tiles", model_path=trained["root"] / "models",
        description="par", codes=CODES, arch="xresnet18", batch_size=4, epochs=1,
        lr=1e-3, seed=0, tpu_opt=False, self_attention=True, loader_threads=2)
    jt = jax_loop.Trainer(cfg)
    try:
        want = jt.manifest()
    finally:
        jt.close()
    got = json.loads((trained["bundle"] / "par.json").read_text())
    assert got == json.loads(json.dumps(want))


def test_jax_load_bundle_reads_it_and_forwards_equal(trained):
    """JAX's load_bundle rebuilds the parity+SA model from the port's
    bundle; its float32 logits equal the port's (rtol 1e-4, atol
    1e-4·max|JAX|)."""
    jm, variables, manifest = jax_load_bundle(trained["bundle"])
    assert not manifest["tpu_opt"] and manifest["self_attention"]
    x = np.random.default_rng(2).uniform(0, 1, (2, TILE, TILE, 3)).astype(np.float32)
    jm = jax_build_unet("xresnet18", n_out=3, c_in=3, self_attention=True,
                        dtype=jnp.float32, tpu_opt=False)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x))
    from unet_tpu_torch.train.checkpoint import load_bundle

    model, _ = load_bundle(trained["bundle"], dtype=torch.float32)
    with torch.no_grad():
        got = model(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_port_serves_the_parity_bundle(trained, tmp_path):
    out = tmp_path / "out.tif"
    rc = cli(["serve", str(trained["bundle"]), str(trained["root"] / "scene.tif"),
              str(out), "--patch-size", str(TILE), "--batch-size", "4", "--device", "cpu"])
    assert rc == 0
    r = read_raster(out)
    assert r.data.dtype == np.uint8 and r.data.shape == (1, 72, 80)
    assert int(r.data.max()) < len(CODES) and tuple(r.transform) == TRANSFORM


def test_tiles_not_divisible_by_4_fall_back_to_parity(tmp_path, capsys):
    """30² tiles: the trainer prints JAX's note, builds the parity topology
    before the model exists, stamps it in the manifest (as JAX's trainer
    does for the same tiles), and a train step runs."""
    tiles = _tiles(tmp_path / "tiles", 30, seed=3)
    cfg = dict(data_path=tiles, model_path=tmp_path / "m", description="odd",
               codes=CODES, arch="xresnet18", batch_size=2, epochs=1, lr=1e-3)
    t = loop.Trainer(loop.TrainerConfig(device="cpu", **cfg))
    try:
        assert "using the parity topology" in capsys.readouterr().out
        assert not t.cfg.tpu_opt and not t.model.tpu_opt
        got = t.manifest()
        t.init_state()
        images, masks, _ = next(iter(t.train_loader))
        loss = t.train_step(images, masks)
        assert math.isfinite(loss.item())
    finally:
        t.close()
    jt = jax_loop.Trainer(jax_loop.TrainerConfig(loader_threads=2, **cfg))
    try:
        want = jt.manifest()
    finally:
        jt.close()
    assert got["tpu_opt"] is False and got["tpu_opt_topology"] is None
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def test_parity_paths_need_cuda_unless_cpu_is_asked(trained, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in trained["args"] if a not in ("--device", "cpu")]
    assert cli(["train", *args]) == 2
    assert "CUDA" in capsys.readouterr().err
    assert cli(["serve", str(trained["bundle"]), str(trained["root"] / "scene.tif"),
                "o.tif"]) == 2
    assert "CUDA" in capsys.readouterr().err
