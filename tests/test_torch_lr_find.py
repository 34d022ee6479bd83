"""PyTorch port: the LR finder against the JAX package on the CPU.

The sweep's learning rates, the smoothing and the four suggesters are host
float64 and bit-equal to JAX's; the sweep's stop rule and its windows of
fetched losses are held against JAX's ``Trainer.lr_find`` on scripted
loss sequences; a 6-step sweep of the xresnet18 tpu_opt U-Net from the
same weights (float32, no augmentation, LR up to 1e-2) gives JAX's
losses within 1e-4 relative; and ``fit`` after a sweep starts from the seed's weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.train import loop as jax_loop
from unet_tpu.train import schedule as js
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.train import loop
from unet_tpu_torch.train import schedule as ts

torch.set_num_threads(2)
TILE = 32
CODES = ("a", "b", "c")


def _curves():
    rng = np.random.default_rng(0)
    lrs = js.lr_finder_lrs(1e-7, 10.0, 100)
    valley = 3 - 2 * np.exp(-((np.log10(lrs) + 3) ** 2) / 2) + 0.01 * np.arange(100) ** 0.5
    yield "valley-shaped", lrs, valley
    yield "diverging", lrs[:63], np.concatenate([np.linspace(2.3, 0.7, 50),
                                                 0.7 * 1.4 ** np.arange(13)])
    yield "flat", lrs[:12], np.full(12, 1.5)
    for i in range(5):
        n = int(rng.integers(12, 101))
        yield f"random {i}", lrs[:n], rng.uniform(0.1, 5, n).cumsum()[::-1] * rng.uniform(0.9, 1.1, n)


@pytest.mark.parametrize("case", list(_curves()), ids=lambda c: c[0])
def test_suggesters_bit_equal_to_jax(case):
    _, lrs, losses = case
    np.testing.assert_array_equal(ts._smooth(losses), js._smooth(losses))
    for method in ts.SUGGESTERS:
        assert ts.suggest_lr(lrs, losses, method) == js.suggest_lr(lrs, losses, method), method


@pytest.mark.parametrize("args", [(), (1e-7, 10.0, 100), (1e-6, 1.0, 37), (1e-5, 1e-1, 2)])
def test_sweep_lrs_bit_equal_to_jax(args):
    np.testing.assert_array_equal(ts.lr_finder_lrs(*args), js.lr_finder_lrs(*args))


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp("lr_tiles")
    rng = np.random.default_rng(1)
    for scene, n in (("trai", 8), ("vali", 3)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            img = np.kron(rng.integers(0, 256, (3, TILE // 8, TILE // 8)),
                          np.ones((8, 8), np.int64)).astype(np.uint8)
            mask = np.where(img[0] > 150, 1, np.where(img[1] > 150, 2, 0)).astype(np.uint8)
            for sub, a in (("img_tiles", img), ("mask_tiles", mask[None])):
                write_raster(root / scene / sub / f"{i}.tif", a,
                             transform=(0.0, 0.2, 0.0, 0.0, 0.0, -0.2), crs="EPSG:25832")
    return root


def _cfg_kw(tiles, tmp_path, **kw):
    return dict(data_path=tiles, model_path=tmp_path, description="lr", codes=CODES,
                arch="xresnet18", batch_size=4, epochs=1, lr=1e-3, seed=0, bf16=False,
                transforms=False, loader_threads=4, **kw)


SCRIPTS = {
    "steady": (25, list(np.linspace(3.0, 1.0, 25))),
    "diverges in the second window": (40, [2.0] * 10 + [1.0, 0.9, 0.8, 5.0, 0.7] + [9.0] * 25),
    "non-finite early": (14, [2.0, float("nan"), 1.5, float("inf")] + [1.2] * 10),
    "non-finite late": (20, [2.0] * 11 + [float("nan")] + [1.0] * 8),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_stop_rule_and_windows_match_jax(tiles, tmp_path, name, monkeypatch):
    """Both trainers' steps replaced by a script of losses: the same
    number of steps run (whole windows of 10 until the stop, which drops
    the rest of its window), the same recorded losses (non-finite → 1e9),
    the same suggestion."""
    num_it, script = SCRIPTS[name]
    jt = jax_loop.Trainer(jax_loop.TrainerConfig(**_cfg_kw(tiles, tmp_path)))
    t = loop.Trainer(loop.TrainerConfig(**_cfg_kw(tiles, tmp_path), device="cpu"))
    try:
        j_calls, t_calls = [], []

        def jax_step(state, images, masks, key):
            j_calls.append(1)
            return state, jnp.float32(script[len(j_calls) - 1])

        monkeypatch.setattr(jt, "init_variables", lambda: {"params": {}, "batch_stats": {}})
        monkeypatch.setattr(jt, "_build_steps", lambda tx: (jax_step, None))
        monkeypatch.setattr(t, "set_weights", lambda variables=None: None)

        def port_step(images, masks, optimizer=None, generator=None):
            t_calls.append(1)
            return torch.tensor(script[len(t_calls) - 1], dtype=torch.float32)

        monkeypatch.setattr(t, "train_step", port_step)
        want = jt.lr_find("valley", num_it=num_it)
        got = t.lr_find("valley", num_it=num_it)
        w_lrs, w_losses = jt._lr_find_curve
        r = t.lr_find_result
        assert len(t_calls) == len(j_calls) == r["steps"]
        np.testing.assert_array_equal(np.float32(r["losses"]), np.float32(w_losses))
        np.testing.assert_array_equal(r["lrs"], w_lrs)
        assert got == want == r["suggestions"]["valley"]
        assert r["suggestions"] == jt._lr_find_suggestions
        assert r["diverged"] == (len(w_losses) < num_it)
    finally:
        t.close()
        jt.close()


def test_six_step_sweep_matches_jax_from_the_same_weights(tiles, tmp_path, monkeypatch):
    """The xresnet18 tpu_opt U-Net, float32, no augmentation, batch 4 ×
    32², from JAX's init: six steps of the constant-schedule Adam with
    the LR rising from 1e-7 to 1e-2, the same batches in the same order.
    Each loss within 1e-4 relative of JAX's. (The default top of 10 puts
    an LR of 0.25 into the fifth step and the sixth loss near 3e11: a
    diverged network, where the two packages' float32 roundings end 1.2%
    apart; the first five losses agree within 6e-5 there too.)"""
    jt = jax_loop.Trainer(jax_loop.TrainerConfig(**_cfg_kw(tiles, tmp_path)))
    t = loop.Trainer(loop.TrainerConfig(**_cfg_kw(tiles, tmp_path), device="cpu"))
    try:
        variables = jax.tree_util.tree_map(np.asarray, jt.init_variables())
        monkeypatch.setattr(jt, "init_variables", lambda: variables)
        monkeypatch.setattr(t, "init_variables", lambda: variables)
        jt.lr_find("valley", num_it=6, end_lr=1e-2)
        t.lr_find("valley", num_it=6, end_lr=1e-2)
        _, want = jt._lr_find_curve
        got = t.lr_find_result["losses"]
        assert len(got) == len(want) == 6
        np.testing.assert_allclose(got, want, rtol=1e-4)
        assert got[-1] != got[0]
    finally:
        t.close()
        jt.close()


def test_fit_after_a_sweep_starts_from_the_seeds_weights(tiles, tmp_path, monkeypatch):
    """fit with lr_finder: the sweep (cut to 4 steps) moves the model, then
    the run restarts from init_variables(): every tensor equal to what a
    run without the finder starts from, and one-cycle at the suggested LR
    (epochs=0, so fit stops there)."""
    t = loop.Trainer(loop.TrainerConfig(**_cfg_kw(tiles, tmp_path, lr_finder="minimum"),
                                        device="cpu"))
    try:
        t.init_state()
        start = {k: v.clone() for k, v in t.model.state_dict().items()}
        sweep = t.lr_find
        moved = []

        def short_sweep(method):
            lr = sweep(method, num_it=4)
            moved.append(any(not torch.equal(v, start[k])
                             for k, v in t.model.state_dict().items()))
            return lr

        monkeypatch.setattr(t, "lr_find", short_sweep)
        t.cfg.epochs = 0
        t.fit()
        assert moved == [True]
        for k, v in t.model.state_dict().items():
            assert torch.equal(v, start[k]), k
        peak = max(t.optimizer.lr_fn(s) for s in range(t.total_steps + 1))
        assert peak == pytest.approx(t.lr_find_result["suggestions"]["minimum"])
        assert t.step_ms() == []  # the sweep's steps are not the fit's
    finally:
        t.close()
