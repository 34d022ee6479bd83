"""PyTorch port: regression training against the JAX package on the CPU.

The streaming rmse / R² sums and foreground_acc, the monitor rule, one
regression train step and one evaluation from the same weights (JAX's
step at float64, as ``tests/test_torch_train.py`` takes it, with its
bars), and a bundle the port trained with ``--regression`` served by both
packages' ``predict_raster`` in float32.
"""

import json
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_parity import jax_variables
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.predict import predict as jax_predict
from unet_tpu.train import loop as jax_loop
from unet_tpu.train import losses as jl
from unet_tpu.train import metrics as jm
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.predict import predict as tp
from unet_tpu_torch.train import loop
from unet_tpu_torch.train import metrics as tm
from unet_tpu_torch.train.checkpoint import to_flax_variables

torch.set_num_threads(2)
TILE = 64
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def test_streaming_regression_metrics_match_jax():
    """Four batches, the last padded (n_valid 2 of 5): the five float32
    sums, rmse and R² within 1e-6 relative (float32 sums in another
    order)."""
    rng = np.random.default_rng(0)
    sj, st = jm.regression_init(), tm.regression_init()
    for n_valid in (5, 5, 5, 2):
        preds = rng.normal(0.5, 0.3, size=(5, 16, 12)).astype(np.float32)
        y = rng.uniform(0, 1, size=(5, 16, 12)).astype(np.float32)
        mask = np.arange(5) < n_valid
        sj = jm.regression_update(sj, jnp.asarray(preds), jnp.asarray(y), jnp.asarray(mask))
        st = tm.regression_update(st, torch.from_numpy(preds), torch.from_numpy(y),
                                  torch.from_numpy(mask))
    for k in sj:
        np.testing.assert_allclose(st[k].item(), float(sj[k]), rtol=1e-6, err_msg=k)
    assert st["count"].item() == 17 * 16 * 12
    np.testing.assert_allclose(tm.rmse_value(st).item(), float(jm.rmse_value(sj)), rtol=1e-6)
    np.testing.assert_allclose(tm.r2_value(st).item(), float(jm.r2_value(sj)), rtol=1e-6)


def test_r2_of_a_constant_target_uses_the_floor():
    """SS_tot = 0: both divide by the 1e-12 floor."""
    s = tm.regression_update(tm.regression_init(), torch.full((2, 3), 0.5),
                             torch.full((2, 3), 0.5))
    j = jm.regression_update(jm.regression_init(), jnp.full((2, 3), 0.5),
                             jnp.full((2, 3), 0.5))
    assert tm.r2_value(s).item() == float(jm.r2_value(j)) == 1.0


def test_foreground_acc_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(3, 9, 7, 4)).astype(np.float32)
    y = rng.integers(0, 4, size=(3, 9, 7))
    for bkg in (0, 2):
        want = float(jm.foreground_acc(jnp.asarray(logits), jnp.asarray(y), bkg))
        got = tm.foreground_acc(_nchw(logits), torch.from_numpy(y), bkg).item()
        assert got == pytest.approx(want, rel=1e-7)


@pytest.mark.parametrize("monitor", [None, "dice_multi", "r2_score", "rmse", "valid_loss",
                                     "train_loss", "foreground_acc"])
@pytest.mark.parametrize("regression", [False, True])
def test_monitor_rule_matches_jax(monitor, regression):
    """The default is r2_score for regression and dice_multi otherwise;
    the losses are minimized, every other monitor maximized (rmse
    included, as the JAX trainer has it), an unknown one with a warning."""
    with warnings.catch_warnings(record=True) as w_jax:
        warnings.simplefilter("always")
        want = jax_loop._monitor_defaults(monitor, regression)
    with warnings.catch_warnings(record=True) as w_port:
        warnings.simplefilter("always")
        got = loop._monitor_defaults(monitor, regression)
    assert got == want
    assert [str(w.message) for w in w_port] == [str(w.message) for w in w_jax]
    assert bool(w_port) == (monitor == "foreground_acc")
    if monitor == "rmse":
        assert got[1] is np.greater


def _tile_tree(root):
    """64² 3-band uint8 tiles with float32 targets (a smooth function of
    the image): 4 trai, 3 vali (the last validation batch of 2 padded)."""
    rng = np.random.default_rng(2)
    for scene, n in (("trai", 4), ("vali", 3)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            img = np.kron(rng.integers(0, 256, (3, TILE // 8, TILE // 8)),
                          np.ones((8, 8), np.int64)).astype(np.uint8)
            y = (img.astype(np.float32).mean(0) / 255)[None]
            for sub, a in (("img_tiles", img), ("mask_tiles", y)):
                write_raster(root / scene / sub / f"{i}.tif", a, transform=TRANSFORM,
                             crs="EPSG:25832")
    return root


@pytest.fixture(scope="module")
def reg_tiles(tmp_path_factory):
    return _tile_tree(tmp_path_factory.mktemp("reg_tiles"))


def _cfg(tiles, **kw):
    return dict(data_path=tiles, codes=("value",), arch="xresnet18", batch_size=2,
                regression=True, bf16=False, transforms=False, loader_threads=4, **kw)


def test_regression_step_and_evaluation_match_jax(reg_tiles):
    """From the same random flax weights (xresnet18 tpu_opt, one
    output channel): the port trainer's loss_and_grads on a 2 × 64² batch
    (MSE on channel 0 of the folded logits) against JAX's forward_loss at
    float64 — loss within rtol 1e-5, each gradient within atol 1e-4·max
    + rtol 1e-3, the updated batch_stats within 1e-5; then each trainer's
    evaluate() over the validation tiles (3, the last batch padded) —
    valid_loss, rmse and r2_score within 1e-5 relative (float32
    convolutions in another order)."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, size=(2, TILE, TILE, 3)).astype(np.float32)
    y = rng.uniform(0, 1, size=(2, TILE, TILE)).astype(np.float32)
    init = jax_build_unet("xresnet18", n_out=1, c_in=3, dtype=jnp.float32, tpu_opt=True)
    v = jax_variables(init, x, rng, train=False)
    with jax.enable_x64():
        jmodel = jax_build_unet("xresnet18", n_out=1, c_in=3, dtype=jnp.float64, tpu_opt=True)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        loss_fn = jl.build_loss(None, True)

        def forward_loss(params, batch_stats, images, masks):
            logits, updates = jmodel.apply({"params": params, "batch_stats": batch_stats},
                                           images, train=True, fold_logits=True,
                                           mutable=["batch_stats"])
            logits, masks = jl.fold_loss_layout(logits, masks)
            return loss_fn(logits[..., 0], masks), updates["batch_stats"]

        (want_loss, want_stats), want_grads = jax.jit(jax.value_and_grad(
            forward_loss, has_aux=True))(
            v64["params"], v64["batch_stats"], jnp.asarray(x, jnp.float64),
            jnp.asarray(y, jnp.float64))
        want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
        want_stats = jax.tree_util.tree_map(np.asarray, want_stats)

    t = loop.Trainer(loop.TrainerConfig(device="cpu", **_cfg(reg_tiles)))
    jt = jax_loop.Trainer(jax_loop.TrainerConfig(**_cfg(reg_tiles)))
    try:
        assert t.n_out == jt.n_out == 1 and t.monitor == jt.monitor == "r2_score"
        t.set_weights(v)
        loss = t.loss_and_grads(_nchw(x), torch.from_numpy(y))
        np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
        sd = dict(t.model.state_dict())
        sd.update({n: p.grad for n, p in t.model.named_parameters()})
        got = to_flax_variables(sd)
        for (path, g), (_, w_) in zip(jax.tree_util.tree_flatten_with_path(got["params"])[0],
                                      jax.tree_util.tree_flatten_with_path(want_grads)[0]):
            np.testing.assert_allclose(g, w_, rtol=1e-3, atol=1e-4 * np.abs(w_).max(),
                                       err_msg=jax.tree_util.keystr(path))
        for (path, s), (_, w_) in zip(
                jax.tree_util.tree_flatten_with_path(got["batch_stats"])[0],
                jax.tree_util.tree_flatten_with_path(want_stats)[0]):
            np.testing.assert_allclose(s, w_, rtol=1e-5, atol=1e-5,
                                       err_msg=jax.tree_util.keystr(path))

        t.set_weights(v)
        got_eval = t.evaluate()
        jt.init_variables = lambda: v
        state = jt.init_state()
        want_eval = jt.evaluate(state, jt._build_steps(jt.tx)[1])
    finally:
        t.close()
        jt.close()
    assert list(got_eval) == list(want_eval) == ["valid_loss", "rmse", "r2_score"]
    for k in want_eval:
        np.testing.assert_allclose(got_eval[k], want_eval[k], rtol=1e-5, err_msg=k)


def test_port_trained_regression_bundle_serves_alike_in_both(reg_tiles, tmp_path):
    """``train --regression`` for one epoch on the CPU; the history has
    rmse and r2_score; the bundle says regression; JAX's predict_raster
    (its model at float32) and the port's (float32) serve a 150 × 170
    scene: float32 maps within 1e-4 of each other, relative to their
    largest value, -9999 nowhere."""
    assert cli(["train", str(reg_tiles), "--model-path", str(tmp_path), "--description",
                "reg", "--codes", "value", "--arch", "xresnet18", "--batch-size", "2",
                "--epochs", "1", "--regression", "--device", "cpu"]) == 0
    bundle = tmp_path / "reg"
    manifest = json.loads((bundle / "reg.json").read_text())
    assert manifest["enable_regression"] is True and manifest["n_out"] == 1
    assert manifest["monitor"] == "r2_score"
    header = (bundle / "reg_history.csv").read_text().splitlines()[0]
    assert header == "epoch,train_loss,valid_loss,rmse,r2_score,time"
    img = np.random.default_rng(5).integers(0, 256, (3, 150, 170)).astype(np.uint8)
    write_raster(tmp_path / "scene.tif", img, transform=TRANSFORM, crs="EPSG:25832")
    pred = jax_predict.Predictor(str(bundle), batch_size=4)
    pred.model = jax_build_unet("xresnet18", n_out=1, c_in=3, dtype=jnp.float32, tpu_opt=True)
    want, _, _ = jax_predict.predict_raster(str(bundle), str(tmp_path / "scene.tif"),
                                            patch_size=TILE, batch_size=4, predictor=pred)
    got, _, _ = tp.predict_raster(str(bundle), str(tmp_path / "scene.tif"),
                                  str(tmp_path / "port.tif"), patch_size=TILE, batch_size=4,
                                  device="cpu", dtype=torch.float32)
    want = np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (150, 170)
    assert not (got == -9999).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(read_raster(tmp_path / "port.tif").data[0], got)
