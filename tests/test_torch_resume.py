"""PyTorch port: step checkpoints, resume and the model summary, against the
JAX package on the CPU.

The port writes its own checkpoints (``train/checkpoint.py``: one msgpack
file an epoch, where ``unet_tpu`` writes orbax directories), so each
package resumes from its own; the semantics are JAX's: the restore follows
the LR sweep, the run goes on from the checkpoint's epoch with a history of
only the epochs it runs, and the loader's permutations, the augmentation
draws, the smoothed loss and the best metric start again from the seed.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax

from unet_tpu.train import loop as jax_loop
from unet_tpu.train.checkpoint import load_bundle as jax_load_bundle
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.models import TPU_OPT_TOPOLOGY_VERSION, build_unet, init_weights
from unet_tpu_torch.train import checkpoint as ckpt
from unet_tpu_torch.train import loop

torch.set_num_threads(2)
TILE = 64
CODES = ["background", "building", "vegetation"]
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """8 trai and 3 vali 64² tiles, and an xresnet18 tpu_opt bundle of the
    port's init weights that both packages start from (``existing_model``)."""
    root = tmp_path_factory.mktemp("resume")
    rng = np.random.default_rng(0)
    for scene, n in (("trai", 8), ("vali", 3)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / "tiles" / scene / sub).mkdir(parents=True)
        for i in range(n):
            img = np.kron(rng.integers(0, 256, (3, TILE // 8, TILE // 8)),
                          np.ones((8, 8), np.int64)).astype(np.uint8)
            mask = np.where(img[0] > 160, 1, np.where(img[1] > 160, 2, 0)).astype(np.uint8)
            for sub, a in (("img_tiles", img), ("mask_tiles", mask[None])):
                write_raster(root / "tiles" / scene / sub / f"{i}.tif", a,
                             transform=TRANSFORM, crs="EPSG:25832")
    model = init_weights(build_unet("xresnet18", n_out=3, c_in=3),
                         torch.Generator().manual_seed(0))
    ckpt.export_bundle(root / "init", "init", ckpt.to_flax_variables(model.state_dict()),
                       {"ARCHITECTURE": "xresnet18", "tpu_opt": True, "self_attention": False,
                        "n_out": 3, "number_of_bands": 3, "patch_size": TILE,
                        "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION})
    return root


def _kw(setup, model_path, **kw):
    base = dict(data_path=setup / "tiles", model_path=str(model_path), description="r",
                codes=CODES, arch="xresnet18", batch_size=4, epochs=2, lr=1e-3,
                transforms=False, bf16=False, normalize="unit", loader_threads=4,
                existing_model=str(setup / "init"))
    base.update(kw)
    return base


def _cfg(setup, model_path, **kw):
    return loop.TrainerConfig(device="cpu", **_kw(setup, model_path, **kw))


def _leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _record_order(trainer, seen):
    """Record the file order of every training batch the trainer builds."""
    make = trainer.train_loader._make_batch

    def recorded(paths, *rest):
        seen.append([p.name for p in paths])
        return make(paths, *rest)

    trainer.train_loader._make_batch = recorded


def test_checkpoint_round_trip_is_bit_exact(setup, tmp_path):
    """Weights, running statistics, Adam's moments and its step count come
    back bit for bit, into a fresh trainer."""
    t = loop.Trainer(_cfg(setup, tmp_path))
    try:
        t.init_state()
        images, masks, _ = next(iter(t.train_loader))
        for _ in range(2):
            t.train_step(images, masks)
        path = ckpt.save_checkpoint(t.checkpoint_dir(), 1, t.checkpoint_state(1))
        assert path == tmp_path / "r" / "checkpoints" / "1" / "state.msgpack"
        want_sd = {k: v.clone() for k, v in t.model.state_dict().items()}
        want_mu = [m.clone() for m in t.optimizer.mu]
        want_nu = [m.clone() for m in t.optimizer.nu]
    finally:
        t.close()
    t2 = loop.Trainer(_cfg(setup, tmp_path))
    try:
        t2.init_state()
        state = ckpt.load_checkpoint(t2.checkpoint_dir(), 1)
        assert int(state["epoch"]) == 1 and int(state["step"]) == 2
        t2.restore_checkpoint(state)
        for k, v in t2.model.state_dict().items():
            assert torch.equal(v, want_sd[k]), k
        for got, want in zip(t2.optimizer.mu + t2.optimizer.nu, want_mu + want_nu):
            assert torch.equal(got, want)
        assert any(bool(m.abs().sum() > 0) for m in t2.optimizer.mu)
        assert t2.optimizer.count == 2
    finally:
        t2.close()
    shutil.rmtree(tmp_path / "r" / "checkpoints")


def test_only_the_newest_two_are_kept(tmp_path):
    state = {"params": {"w": np.arange(3, dtype=np.float32)}, "step": np.int64(0)}
    for epoch in (1, 2, 3, 4):
        ckpt.save_checkpoint(tmp_path, epoch, {**state, "epoch": np.int64(epoch)})
    assert ckpt.checkpoint_epochs(tmp_path) == [3, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["3", "4"]
    assert ckpt.latest_checkpoint(tmp_path) == 4
    assert ckpt.latest_checkpoint(tmp_path / "absent") is None


def test_a_checkpoint_killed_mid_write_is_never_latest(tmp_path, monkeypatch):
    """A write that dies before its rename leaves only a temporary file,
    which neither ``latest_checkpoint`` nor the pruning counts; the next
    save of that epoch completes it."""
    state = {"params": {"w": np.ones(1000, np.float32)}, "step": np.int64(1),
             "epoch": np.int64(1)}
    ckpt.save_checkpoint(tmp_path, 1, state)

    def killed(fd):
        raise OSError("killed")

    monkeypatch.setattr(os, "fsync", killed)
    with pytest.raises(OSError, match="killed"):
        ckpt.save_checkpoint(tmp_path, 2, {**state, "epoch": np.int64(2)})
    leftovers = [p.name for p in (tmp_path / "2").iterdir()]
    assert len(leftovers) == 1 and leftovers[0].startswith("state.msgpack.tmp-")
    (tmp_path / "2" / leftovers[0]).write_bytes(b"\x82\xa6params")  # a torn file
    assert ckpt.latest_checkpoint(tmp_path) == 1
    monkeypatch.undo()
    ckpt.save_checkpoint(tmp_path, 2, {**state, "epoch": np.int64(2)})
    assert ckpt.latest_checkpoint(tmp_path) == 2
    assert int(ckpt.load_checkpoint(tmp_path, 2)["epoch"]) == 2


@pytest.fixture(scope="module")
def resumed(setup, tmp_path_factory):
    """Both packages: a 2-epoch run with a checkpoint an epoch, the second
    checkpoint taken away (the run killed after its first; the port's is
    kept in ``complete``), then the run again with ``resume`` and the model
    summary, each through the package's ``train_model``. Records every
    training batch's file order."""
    out = {"setup": setup}
    for pkg, lp, kw in (("port", loop, dict(device="cpu")), ("jax", jax_loop, {})):
        root = tmp_path_factory.mktemp(f"resume_{pkg}")
        orders = {"first": [], "resumed": []}
        for run, extra in (("first", dict(checkpoint_every=1)),
                           ("resumed", dict(checkpoint_every=1, resume=True,
                                            export_model_summary=True))):
            cfg = lp.TrainerConfig(**_kw(setup, root, **extra), **kw)
            trainer = lp.Trainer(cfg)
            _record_order(trainer, orders[run])
            original = lp.Trainer
            lp.Trainer = lambda c, _t=trainer: _t  # train_model takes this trainer
            try:
                bundle = lp.train_model(cfg)
            finally:
                lp.Trainer = original
            if run == "first":
                second = root / "r" / "checkpoints" / "2"
                if pkg == "port":
                    out[pkg] = {"first_checkpoints": ckpt.checkpoint_epochs(second.parent),
                                "complete": root / "complete"}
                    (root / "complete" / "r" / "checkpoints").mkdir(parents=True)
                    second.rename(root / "complete" / "r" / "checkpoints" / "2")
                else:
                    out[pkg] = {}
                    shutil.rmtree(second)
        out[pkg].update(bundle=bundle, orders=orders, history=trainer.history,
                        summary=(bundle / "r_model_summary.txt").read_text())
    yield out
    for pkg in ("port", "jax"):  # several hundred MB each
        shutil.rmtree(out[pkg]["bundle"] / "checkpoints", ignore_errors=True)
    shutil.rmtree(out["port"]["complete"], ignore_errors=True)


def test_resume_at_epochs_runs_no_epoch(resumed):
    """As ``tests/test_train_loop.py``'s resume test: a run resumed at its
    last epoch runs none, and exports the restored weights. The checkpoint
    is the second of the port's uninterrupted first run."""
    root = resumed["port"]["complete"]
    assert resumed["port"]["first_checkpoints"] == [1, 2]
    saved = ckpt.load_checkpoint(root / "r" / "checkpoints", 2)
    t2 = loop.Trainer(_cfg(resumed["setup"], root, checkpoint_every=1, resume=True))
    out = loop.train_model(t2.cfg, t2)
    assert t2.history == [] and t2.best_state is None
    exported = ckpt.load_weights(out / "r.msgpack")
    for (k, a), (_, b) in zip(_leaves(exported),
                              _leaves({"params": saved["params"],
                                       "batch_stats": saved["batch_stats"]})):
        assert np.array_equal(a, b), k


def test_resume_follows_jax(resumed):
    """Killed after epoch 1 of 2 and resumed: the run trains epoch 1 only,
    its loader starts again from the seed's first permutation (JAX's
    semantics; it is not the uninterrupted run's second epoch), and the
    exported weights are JAX's resumed run's: the two packages' updates
    from the shared start differ by a median of at most 10% and a worst
    leaf of at most 35% relative L2 (measured: 3.9% and 21%). Both compute
    in float32, and Adam moves every weight by about the LR whatever its
    gradient's size, so float32 rounding in small gradients (JAX's own
    float32 gradients of the folded stem are ~4e-2 off float64) shows in
    the update; a wrong start, step count or batch order moves the
    updates by their whole size."""
    port, jx = resumed["port"], resumed["jax"]
    assert [r["epoch"] for r in port["history"]] == [r["epoch"] for r in jx["history"]] == [1]
    for key in ("train_loss", "valid_loss", "dice_multi"):
        np.testing.assert_allclose(port["history"][0][key], jx["history"][0][key], rtol=2e-3,
                                   err_msg=key)
    first, again = port["orders"]["first"], port["orders"]["resumed"]
    assert again == jx["orders"]["resumed"] and first == jx["orders"]["first"]
    assert len(first) == 4 and again == first[:2] and again != first[2:]
    got = dict(_leaves(ckpt.load_weights(port["bundle"] / "r.msgpack")))
    _, want_tree, _ = jax_load_bundle(jx["bundle"])
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, want_tree)))
    assert got.keys() == want.keys()
    init = dict(_leaves(ckpt.load_weights(resumed["setup"] / "init" / "init.msgpack")))
    rel = {k: np.linalg.norm(got[k] - w) / max(np.linalg.norm(w - init[k]), 1e-30)
           for k, w in want.items() if k.startswith("params/")}
    assert np.median(list(rel.values())) <= 0.1, sorted(rel.items(), key=lambda t: t[1])[-3:]
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 0.35, (worst, rel[worst])


def test_model_summary_lines_equal_jax(resumed):
    """Class weights, architecture, input, total and per-module parameter
    counts equal JAX's; the port's layer table follows."""
    port, jx = resumed["port"]["summary"], resumed["jax"]["summary"]
    head = port.split("\n\n")[:2]
    assert head == jx.split("\n\n")[:2]
    assert head[0].startswith("Class_weights: ") and "Total parameters: " in head[0]
    table = port.split("\n\n")[2].splitlines()
    assert table[0].split() == ["module", "type", "output", "shape", "params"]
    assert any(line.startswith("encoder.stem_0 ") and "(1, 128, 16, 16)" in line
               for line in table)
