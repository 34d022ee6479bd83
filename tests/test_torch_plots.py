"""PyTorch port: the training plots (``utils/plots.py``) and
``visualize_data_example`` against the JAX package's on the CPU.

Each plot function writes a PNG byte-equal to ``unet_tpu.utils.plots``'s
on the same numpy inputs (the same matplotlib, Agg). A one-epoch fit of
xresnet18 on 32² tiles with ``visualize_data_example`` and a short LR
sweep writes the batch histograms, the loss plot and the sweep's plot,
each equal to JAX's figure of the same data; its loader's order after
``one_batch`` is JAX's. Without matplotlib, training still writes the
bundle and the CSVs and names each PNG it skipped.
"""

import contextlib
import io
import sys

import numpy as np
import pytest
import torch

from unet_tpu.data.dataset import TileDataset as JaxTileDataset
from unet_tpu.data.loader import TileLoader as JaxTileLoader
from unet_tpu.utils import plots as jax_plots
from unet_tpu_torch.data import TileDataset, TileLoader
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.train import loop
from unet_tpu_torch.utils import plots

torch.set_num_threads(2)
TILE, N_TRAIN, N_VALID, BATCH = 32, 8, 4, 4
CODES = ["background", "a", "b"]
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)


def _tiles(root, seed=0):
    """3-band uint8 blocks; class 1 where band 0 is bright, 2 where band 1
    is, else 0."""
    rng = np.random.default_rng(seed)
    for scene, n in (("trai", N_TRAIN), ("vali", N_VALID)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            img = np.kron(rng.integers(0, 256, (3, TILE // 8, TILE // 8)),
                          np.ones((8, 8), np.int64)).astype(np.uint8)
            mask = np.where(img[0] > 160, 1, np.where(img[1] > 160, 2, 0)).astype(np.uint8)
            write_raster(root / scene / "img_tiles" / f"{i}.tif", img, transform=TRANSFORM,
                         crs="EPSG:25832")
            write_raster(root / scene / "mask_tiles" / f"{i}.tif", mask[None],
                         transform=TRANSFORM, crs="EPSG:25832")
    return root


def _inputs():
    """Seeded numpy inputs of the plots: a mask batch, a sweep, and a
    history."""
    rng = np.random.default_rng(7)
    masks = rng.integers(0, 3, (4, 16, 16)).astype(np.uint8)
    lrs = np.geomspace(1e-7, 10.0, 60)
    losses = 2.0 - np.log10(lrs + 1e-3) * 0.1 + rng.normal(0, 0.05, 60)
    losses[-5:] = [5.0, 9.0, np.inf, 30.0, 1e9]
    suggestions = {"minimum": 1e-3, "steep": 3e-5, "valley": 2e-4, "slide": 5e-4}
    history = [{"epoch": e, "train_loss": 1.2 / (e + 1) + 0.1, "valid_loss": 0.9 / (e + 1),
                "dice_multi": 0.5 + 0.1 * e, "time": "00:01"} for e in range(5)]
    return masks, lrs, losses, suggestions, history


def _draw(mod, what, out):
    masks, lrs, losses, suggestions, history = _inputs()
    if what == "mask":
        return mod.visualize_data(masks, out / "m.msgpack")
    if what == "lr_find":
        return mod.plot_lr_find(lrs, losses, suggestions, out / "lr.png")
    if what == "annot_min":
        import matplotlib.pyplot as plt

        plt.figure(figsize=(5, 4))
        plt.plot(losses[:20])
        mod.annot_min(losses[:20])
        plt.savefig(out / "annot.png")
        plt.close()
        return out / "annot.png"
    return mod.plot_training_overview(history, what, out / "h.png")


@pytest.mark.parametrize("what", ["mask", "lr_find", "annot_min", "dice_multi", "valid_loss"])
def test_plot_is_byte_equal_to_jax(what, tmp_path):
    """``dice_multi`` / ``valid_loss``: the overview with both curves
    (annotated on the train loss) or the validation curve alone. (An image
    batch's histograms: ``test_visualize_data_example_writes_jax_histograms``.)"""
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = _draw(plots, what, tmp_path / "port")
    want = _draw(jax_plots, what, tmp_path / "jax")
    assert got.name == want.name
    assert got.read_bytes() == want.read_bytes()
    assert got.stat().st_size > 5000  # a drawn figure, not an empty one


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """One epoch with ``visualize_data_example`` and a 4-step LR sweep; the
    printed lines."""
    root = tmp_path_factory.mktemp("plots")
    tiles = _tiles(root / "tiles")
    cfg = loop.TrainerConfig(data_path=tiles, model_path=root / "models", description="v",
                             codes=CODES, arch="xresnet18", batch_size=BATCH, epochs=1,
                             lr=1e-3, seed=0, bf16=False, lr_finder="valley",
                             visualize_data_example=True, loader_threads=2, device="cpu")
    t = loop.Trainer(cfg)
    sweep = t.lr_find
    t.lr_find = lambda method: sweep(method, num_it=4)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loop.train_model(cfg, trainer=t)
    return {"root": root, "tiles": tiles, "bundle": root / "models" / "v", "trainer": t,
            "out": buf.getvalue()}


def _jax_loader(tiles):
    ds = JaxTileDataset(tiles)
    return JaxTileLoader(ds, ds.train_files, BATCH, shuffle=True, drop_last=True, seed=0,
                         n_threads=4)


def test_visualize_data_example_writes_jax_histograms(fitted, tmp_path):
    """The two histograms and the two lines JAX's ``train_model`` gives for
    its loader's ``one_batch`` of the same tiles and seed (NHWC)."""
    jl = _jax_loader(fitted["tiles"])
    try:
        images, masks, _ = jl.one_batch()
    finally:
        jl.close()
    assert f"Input shape: {images.shape}, Output shape: {masks.shape}\n" in fitted["out"]
    assert (f"Examplary value range INPUT: {images.min()} to {images.max()}\n"
            in fitted["out"])
    for batch, name in ((images, "v_image_plot.png"), (masks, "v_mask_plot.png")):
        want = jax_plots.visualize_data(batch, tmp_path / "v.msgpack")
        assert want.name == name
        assert (fitted["bundle"] / name).read_bytes() == want.read_bytes()


def test_loss_and_lr_find_plots_equal_jax(fitted, tmp_path):
    """``<desc>_history.png`` of the run's history and monitor, and
    ``<desc>_lr_find.png`` of its sweep with the four suggestions, as JAX
    draws them; the CSVs beside them."""
    t, bundle = fitted["trainer"], fitted["bundle"]
    assert len(t.history) == 1 and t.monitor == "dice_multi"
    want = jax_plots.plot_training_overview(t.history, t.monitor, tmp_path / "h.png")
    assert (bundle / "v_history.png").read_bytes() == want.read_bytes()
    r = t.lr_find_result
    assert r["iterations"] == 4 and set(r["suggestions"]) == {"minimum", "steep", "valley",
                                                              "slide"}
    want = jax_plots.plot_lr_find(r["lrs"], r["losses"], r["suggestions"], tmp_path / "l.png")
    assert (bundle / "v_lr_find.png").read_bytes() == want.read_bytes()
    for name in ("v_history.csv", "v_lr_find.csv", "v.json", "v.msgpack"):
        assert (bundle / name).is_file()


def test_loader_order_after_one_batch_is_jax(fitted):
    """``one_batch`` draws the first permutation, as JAX's does: the batch
    and the next two epochs equal JAX's loader's, in order."""
    ds = TileDataset(fitted["tiles"])
    port = TileLoader(ds, ds.train_files, BATCH, shuffle=True, drop_last=True, seed=0,
                      n_threads=2)
    jl = _jax_loader(fitted["tiles"])
    try:
        got, want = port.one_batch(), jl.one_batch()
        np.testing.assert_array_equal(np.moveaxis(got[0], 1, -1), want[0])
        np.testing.assert_array_equal(got[1], want[1])
        for _ in range(2):
            pairs = list(zip(port, jl))
            assert len(pairs) == N_TRAIN // BATCH
            for g, w in pairs:
                np.testing.assert_array_equal(np.moveaxis(g[0], 1, -1), w[0])
                np.testing.assert_array_equal(g[1], w[1])
    finally:
        port.close()
        jl.close()


def test_training_without_matplotlib_skips_each_png(fitted, tmp_path, monkeypatch, capsys):
    """matplotlib hidden: the bundle and the CSVs are written, and one line
    names each PNG skipped; the batch's two lines still print."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    cfg = loop.TrainerConfig(data_path=fitted["tiles"], model_path=tmp_path / "m",
                             description="n", codes=CODES, arch="xresnet18",
                             batch_size=BATCH, epochs=1, lr=1e-3, seed=0, bf16=False,
                             visualize_data_example=True, loader_threads=2, device="cpu")
    bundle = loop.train_model(cfg)
    out = capsys.readouterr().out
    assert "Input shape: (4, 32, 32, 3), Output shape: (4, 32, 32)" in out
    for name in ("n_image_plot.png", "n_mask_plot.png", "n_history.png"):
        assert f"{bundle / name}: skipped, matplotlib is not installed\n" in out
        assert not (bundle / name).exists()
    for name in ("n.json", "n.msgpack", "best-model.msgpack", "n_history.csv"):
        assert (bundle / name).is_file()
