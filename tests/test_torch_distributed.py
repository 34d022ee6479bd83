"""PyTorch port: data parallelism over processes on the CPU (two ranks over
gloo), against one process and against the JAX package's step on the
global batch.

What JAX computes under GSPMD on a sharded batch is the step of the global
batch: BatchNorm statistics and loss normalizers over every sample. Two
ranks of the port each hold half of every (micro)batch, all-reduce their
``bn_stats`` sums and their loss denominators, and sum their gradients once
a step (``parallel/mesh.py``). The cases: xresnet18 tpu_opt at 64² with
weighted cross-entropy whose Σw differs between the shards, weighted focal,
dice, MSE (regression), and weighted CE at ``grad_accum=2``; the parity
topology at 48² (ROADMAP §3). The weights are the init with random
BatchNorm parameters and statistics, as in
``tests/test_torch_trainer_surface.py``; JAX runs at float64 (its own
float32 gradients of the folded stem are ~4e-2 off its float64 ones;
``tests/test_torch_train.py``).

Bars. The ranks' results are bit-equal to each other. Against one process
and against JAX: the loss within rtol 1e-5 and the running statistics
within 1e-5 (the forward is smooth); each gradient within 5e-2 relative L2
of its leaf, with a floor of 1e-2 of all the gradients' RMS (the bars of
``chip_smoke.py``'s kernel-against-plain steps). The gradients are not held
element by element: at these sizes they jump with the ReLU decisions of
the 4×4 and 2×2 stages, so summing each BatchNorm's statistics in two
halves (what two ranks do) moves a tpu_opt gradient leaf by up to 2e-3 of
its largest element (0.16% relative L2), and a 1e-7 relative change of the
input moves one by 2% relative L2, in one process alone (measured on this
case's inputs).

The ranks run in spawned processes: JAX is imported only inside the tests
that use it, so the children import this module without it. After the
steps each rank runs ``train --coordinator --num-processes --process-id``
through the CLI's entry function (a 1-epoch fit); the one-process steps,
the one-process fit of the same command and JAX's steps run in this
process meanwhile.
"""

import contextlib
import functools
import io
import json
import multiprocessing as mp
import shutil
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.data import AugmentConfig, TileDataset, TileLoader, augment_batch
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.parallel import mesh
from unet_tpu_torch.train import checkpoint as ckpt
from unet_tpu_torch.train import loop
from unet_tpu_torch.train.checkpoint import to_flax_variables
from unet_tpu_torch.utils import doctor

torch.set_num_threads(2)
TILE, PARITY_TILE, B, WORLD = 64, 48, 4, 2
CODES = ("background", "building", "vegetation")
WEIGHT = [0.2, 0.5, 0.3]
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
# name: (TrainerConfig overrides, tile side, seed of the weights and inputs);
# the three classification losses share a model, weights and batch
CASES = {
    "ce": (dict(class_weights=WEIGHT), TILE, 0),
    "focal": (dict(class_weights=WEIGHT, loss_func="focal"), TILE, 0),
    "dice": (dict(loss_func="dice"), TILE, 0),
    "mse": (dict(regression=True), TILE, 1),
    "accum": (dict(class_weights=WEIGHT, grad_accum=2), TILE, 2),
    "parity": (dict(class_weights=WEIGHT, tpu_opt=False), PARITY_TILE, 3),
}
STEPS = 3
JOIN_S = 300


def _write(path, a):
    write_raster(path, a, transform=TRANSFORM, crs="EPSG:25832")


def _tiles(root: Path, regression: bool) -> Path:
    """8 trai and 3 vali 64² uint8 tiles (3 vali: the last validation batch
    is padded, so the ranks' shares hold 2 and 1 real samples)."""
    rng = np.random.default_rng(0)
    for scene, n in (("trai", 8), ("vali", 3)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            img = np.kron(rng.integers(0, 256, (3, TILE // 8, TILE // 8)),
                          np.ones((8, 8), np.int64)).astype(np.uint8)
            mask = (img[0] / 255.0).astype(np.float32) if regression else \
                np.where(img[0] > 160, 1, np.where(img[1] > 160, 2, 0)).astype(np.uint8)
            _write(root / scene / "img_tiles" / f"{i}.tif", img)
            _write(root / scene / "mask_tiles" / f"{i}.tif", mask[None])
    return root


def _cfg(tiles, **kw) -> loop.TrainerConfig:
    base = dict(data_path=tiles["mse" if kw.get("regression") else "cls"], codes=CODES,
                arch="xresnet18", batch_size=B, bf16=False, transforms=False,
                loader_threads=2, device="cpu", lr=1e-3)
    base.update(kw)
    return loop.TrainerConfig(**base)


@functools.lru_cache(maxsize=None)
def _randomized(n_out: int, tpu_opt: bool, seed: int) -> dict:
    """The init's weights with random BatchNorm parameters and statistics
    and conv biases (numpy only; cached: the cases of one seed share them)."""
    model = init_weights(build_unet("xresnet18", n_out=n_out, c_in=3, tpu_opt=tpu_opt),
                         torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)

    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(to_flax_variables(model.state_dict()))


def _inputs(name: str, side: int, seed: int):
    """A batch of B float images and its targets; the classification
    targets of the first rank's share lack class 1, so the shards' Σw[y]
    differ."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, 3, side, side)).astype(np.float32)
    if name == "mse":
        return x, rng.uniform(0, 1, (B, side, side)).astype(np.float32)
    y = rng.integers(0, 3, (B, side, side)).astype(np.int64)
    y[:2][y[:2] == 1] = 2
    return x, y


def _state(trainer) -> dict:
    """The flax tree of the model's gradients (as ``params``) and running
    statistics."""
    sd = dict(trainer.model.state_dict())
    sd.update({n: p.grad for n, p in trainer.model.named_parameters()})
    return to_flax_variables(sd)


def _step(trainer, v, x, y, idx=None):
    trainer.set_weights(v)
    if idx is not None:
        x, y = x[idx], y[idx]
    loss = trainer.loss_and_grads(torch.from_numpy(x), torch.from_numpy(y))
    return {"loss": loss.item(), **_state(trainer)}


def _host_batch(seed: int):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 3, TILE, TILE)).astype(np.uint8)
    return images, (images[:, 0] > 128).astype(np.uint8)


def _case(name: str):
    """(overrides, weights, images, targets) of a case, from its seed."""
    kw, side, seed = CASES[name]
    v = _randomized(1 if kw.get("regression") else 3, kw.get("tpu_opt", True), seed)
    return (kw, v, *_inputs(name, side, 10 + seed))


def _cli_args(tiles, out_dir, description, port=None, rank=None):
    """``train`` of 1 epoch on the classification tiles, on the CPU; with
    ``port``, rank ``rank`` of WORLD processes."""
    args = ["train", str(tiles["cls"]), "--model-path", str(out_dir / "models"),
            "--description", description, "--codes", *CODES, "--arch", "xresnet18",
            "--batch-size", str(B), "--epochs", "1", "--lr", "1e-3", "--device", "cpu",
            "--stats-json", str(out_dir / f"{description}{'' if rank is None else rank}.json")]
    if port is not None:
        args += ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(WORLD),
                 "--process-id", str(rank)]
    return args


def _cli_fit(args) -> dict:
    """``cli(args)`` in this process with a checkpoint an epoch (a
    ``Params`` field, which only ``run`` reaches) and in float32 (the CLI
    trains in bf16, whose rounding would hide a 1e-5 disagreement between
    the ranks' history and one process's): its exit code, its standard
    output, the bundles and checkpoints it wrote and its trainer's
    history."""
    writes, histories = {"bundles": 0, "checkpoints": 0}, []
    export, save = ckpt.export_bundle, ckpt.save_checkpoint
    config, train_model = loop.TrainerConfig, loop.train_model

    def counted(key, fn):
        def wrapper(*a, **k):
            writes[key] += 1
            return fn(*a, **k)
        return wrapper

    def recorded(cfg, trainer=None):
        out = train_model(cfg, trainer)
        histories.append(trainer.history)
        return out

    ckpt.export_bundle = counted("bundles", export)
    ckpt.save_checkpoint = counted("checkpoints", save)
    loop.TrainerConfig = lambda **kw: config(checkpoint_every=1, bf16=False, **kw)
    loop.train_model = recorded
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli(args)
    finally:
        ckpt.export_bundle, ckpt.save_checkpoint = export, save
        loop.TrainerConfig, loop.train_model = config, train_model
    return {"rc": rc, "out": out.getvalue(), "writes": writes, "history": histories[0]}


def _run_rank(rank, ports, tiles, out_dir):
    """One rank: every case's step on its share, three optimizer steps, an
    indivisible batch and doctor's mesh check inside the group; then
    ``train --coordinator --num-processes --process-id`` through the CLI,
    which builds and leaves its own group."""
    torch.set_num_threads(1)
    res = {}
    try:
        mesh.init_distributed(f"127.0.0.1:{ports[0]}", WORLD, rank, device="cpu")
        for name in CASES:
            kw, v, x, y = _case(name)
            t = loop.Trainer(_cfg(tiles, **kw))
            try:
                res[name] = {**_step(t, v, x, y, t.train_shard), "shard": t.train_shard}
            finally:
                t.close()
        t = loop.Trainer(_cfg(tiles, transforms=True, class_weights=WEIGHT))
        try:
            t.init_state(_case("ce")[1])
            images, masks = _host_batch(3)
            idx = t.train_shard
            losses = [t.train_step(images[idx], masks[idx]).item() for _ in range(STEPS)]
            res["steps"] = {"losses": losses, **to_flax_variables(t.model.state_dict())}
        finally:
            t.close()
        try:
            loop.Trainer(_cfg(tiles, batch_size=6, grad_accum=2))
            res["indivisible"] = None
        except ValueError as e:
            res["indivisible"] = str(e)
        res["mesh"] = doctor._mesh("cpu")
        mesh.close_distributed()
        res["fit"] = _cli_fit(_cli_args(tiles, out_dir, "fit", ports[1], rank))
    except Exception:
        res["error"] = traceback.format_exc()
    finally:
        mesh.close_distributed()
        torch.save(res, out_dir / f"rank{rank}.pt")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' results, and the one-process steps and fit and JAX's
    steps on the same inputs (computed here while the ranks run)."""
    root = tmp_path_factory.mktemp("dist")
    tiles = {"cls": _tiles(root / "cls", False), "mse": _tiles(root / "mse", True)}
    ctx = mp.get_context("spawn")
    ports = [mesh.free_port()]
    while len(ports) < 2:
        ports += [p for p in [mesh.free_port()] if p != ports[0]]
    procs = [ctx.Process(target=_run_rank, args=(r, ports, tiles, root)) for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        one = {}
        for name in CASES:
            kw, v, x, y = _case(name)
            t = loop.Trainer(_cfg(tiles, **kw))
            try:
                one[name] = _step(t, v, x, y)
            finally:
                t.close()
        t = loop.Trainer(_cfg(tiles, transforms=True, class_weights=WEIGHT))
        try:
            t.init_state(_case("ce")[1])
            images, masks = _host_batch(3)
            one["steps"] = {"losses": [t.train_step(images, masks).item()
                                       for _ in range(STEPS)]}
        finally:
            t.close()
        (root / "one").mkdir()
        one["fit"] = _cli_fit(_cli_args(tiles, root / "one", "fit"))
        jax_refs = _jax_refs({name: _case(name) for name in JAX_CASES})
    finally:
        for p in procs:
            p.join(JOIN_S)
        alive = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not any(alive), "a rank did not finish"
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for r in range(WORLD):
        (root / f"rank{r}.pt").unlink()  # every case's gradients: hundreds of MB
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    return {"ranks": ranks, "one": one, "jax": jax_refs, "root": root, "tiles": tiles}


def _flat(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


GRAD_REL_L2, GRAD_FLOOR = 5e-2, 1e-2


def _close(got: dict, want: dict, loss_want: float):
    np.testing.assert_allclose(got["loss"], loss_want, rtol=1e-5)
    want_g, want_s = dict(_flat(want["params"])), dict(_flat(want["batch_stats"]))
    got_g, got_s = dict(_flat(got["params"])), dict(_flat(got["batch_stats"]))
    assert got_g.keys() == want_g.keys() and got_s.keys() == want_s.keys()
    rms = np.sqrt(np.mean(np.concatenate([w.ravel() for w in want_g.values()]) ** 2))
    for k, w in want_g.items():
        err = np.linalg.norm(got_g[k] - w)
        scale = max(np.linalg.norm(w), GRAD_FLOOR * rms * np.sqrt(w.size))
        assert err <= GRAD_REL_L2 * scale, (k, err / scale)
    for k, w in want_s.items():
        np.testing.assert_allclose(got_s[k], w, rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_two_rank_step_equals_one_process_step(run, name):
    """The ranks end bit-equal (gradients, loss, running statistics); their
    step equals one process's step on the whole batch."""
    r0, r1 = run["ranks"][0][name], run["ranks"][1][name]
    assert r0["loss"] == r1["loss"]
    for (k, a), (_, b) in zip(_flat({"p": r0["params"], "s": r0["batch_stats"]}),
                              _flat({"p": r1["params"], "s": r1["batch_stats"]})):
        assert np.array_equal(a, b), k
    _close(r0, run["one"][name], run["one"][name]["loss"])


def _jax_references(names, v: dict, x: np.ndarray, y: np.ndarray) -> dict:
    """JAX's steps on the global batch at float64 for the cases ``names``,
    which share a model, weights and batch and differ in the loss, as its
    trainer's ``forward_loss`` and microbatch scan compute them
    (``unet_tpu/train/loop.py``): per case the loss, the gradients
    (averaged over microbatches) and the running statistics after the
    step. One forward a microbatch (under a scan for ``grad_accum`` > 1);
    one backward a loss."""
    import jax
    import jax.numpy as jnp

    from unet_tpu.models import build_unet as jax_build_unet
    from unet_tpu.train import losses as jl

    kw = CASES[names[0]][0]
    regression = kw.get("regression", False)
    accum = kw.get("grad_accum", 1)
    with jax.enable_x64():
        jm = jax_build_unet("xresnet18", n_out=1 if regression else 3, c_in=3,
                            dtype=jnp.float64, tpu_opt=kw.get("tpu_opt", True))
        loss_fns = [jl.build_loss(CASES[n][0].get("loss_func"), regression,
                                  None if CASES[n][0].get("class_weights") is None
                                  else jnp.asarray(WEIGHT, jnp.float64)) for n in names]

        def loss_of(fn, lg, t):
            if lg.shape[1] != t.shape[1]:
                lg, t = jl.fold_loss_layout(lg, t)
            return fn(lg[..., 0] if regression else lg, t)

        @jax.jit
        def step(params, stats, images, masks):
            def micro(carry, batch):
                stats, losses, grads = carry
                xx, yy = batch

                def forward(p):
                    logits, up = jm.apply({"params": p, "batch_stats": stats}, xx, train=True,
                                          fold_logits=True, mutable=["batch_stats"])
                    return logits, up["batch_stats"]

                logits, vjp, stats = jax.vjp(forward, params, has_aux=True)
                vals = [jax.value_and_grad(lambda lg, fn=fn: loss_of(fn, lg, yy))(logits)
                        for fn in loss_fns]
                gs = [vjp(c)[0] for _, c in vals]
                grads = jax.tree_util.tree_map(lambda a, *g: a + jnp.stack(g), grads, *gs)
                return (stats, losses + jnp.stack([l for l, _ in vals]), grads), None

            zeros = jax.tree_util.tree_map(
                lambda a: jnp.zeros((len(loss_fns),) + a.shape, a.dtype), params)
            carry = (stats, jnp.zeros(len(loss_fns), jnp.float64), zeros)
            if accum == 1:  # a scan of one would cost the loop's compile and run
                (stats, losses, grads), _ = micro(carry, (images, masks))
            else:
                (stats, losses, grads), _ = jax.lax.scan(micro, carry, tuple(
                    a.reshape(accum, a.shape[0] // accum, *a.shape[1:])
                    for a in (images, masks)))
            return losses / accum, jax.tree_util.tree_map(lambda a: a / accum, grads), stats

        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        losses, grads, stats = jax.tree_util.tree_map(np.asarray, step(
            v64["params"], v64["batch_stats"],
            jnp.asarray(np.moveaxis(x, 1, 3), jnp.float64),
            jnp.asarray(y, jnp.float64 if regression else jnp.int32)))
    return {n: {"loss": float(losses[i]), "batch_stats": stats,
                "params": jax.tree_util.tree_map(lambda a, i=i: a[i], grads)}
            for i, n in enumerate(names)}


JAX_CASES = ("ce", "focal", "dice", "mse", "accum")  # the parity case: one process only


def _jax_refs(cases: dict) -> dict:
    groups = {}
    for name in JAX_CASES:
        groups.setdefault(CASES[name][2], []).append(name)
    refs = {}
    for names in groups.values():
        _, v, x, y = cases[names[0]]
        refs.update(_jax_references(names, v, x, y))
    return refs


@pytest.mark.parametrize("name", JAX_CASES)
def test_two_rank_step_equals_jax_on_the_global_batch(run, name):
    """What GSPMD computes on the sharded batch: JAX's step on all B
    samples (float64), against the port's two ranks (float32)."""
    _close(run["ranks"][0][name], run["jax"][name], run["jax"][name]["loss"])


def test_shards_follow_the_microbatches(run):
    """Rank r holds its half of each microbatch: [0, 1] and [2, 3] of a
    batch of 4; under grad_accum 2, samples 0 and 2, then 1 and 3."""
    for r in range(WORLD):
        assert list(run["ranks"][r]["ce"]["shard"]) == [2 * r, 2 * r + 1]
        assert list(run["ranks"][r]["accum"]["shard"]) == [r, 2 + r]
    assert list(mesh.shard_indices(16, 4, 2, 1)) == [2, 3, 6, 7, 10, 11, 14, 15]


def test_ranks_stay_bit_equal_over_optimizer_steps(run):
    """Three steps with flips (every rank draws the whole batch's flags):
    the ranks' weights and running statistics are bit-equal, and their
    losses are one process's within rtol 1e-5."""
    a, b = run["ranks"][0]["steps"], run["ranks"][1]["steps"]
    assert a["losses"] == b["losses"]
    for (k, x), (_, y) in zip(_flat({"p": a["params"], "s": a["batch_stats"]}),
                              _flat({"p": b["params"], "s": b["batch_stats"]})):
        assert np.array_equal(x, y), k
    np.testing.assert_allclose(a["losses"], run["one"]["steps"]["losses"], rtol=1e-5)


def test_two_rank_fit_writes_one_bundle(run):
    """Only rank 0 exports the bundle and writes the checkpoints; the
    validation history (the ranks' reduced sums) is the same on both."""
    f0, f1 = run["ranks"][0]["fit"], run["ranks"][1]["fit"]
    assert f0["writes"] == {"bundles": 1, "checkpoints": 1}
    assert f1["writes"] == {"bundles": 0, "checkpoints": 0}
    drop = lambda h: [{k: v for k, v in row.items() if k != "time"} for row in h]  # noqa: E731
    assert len(f0["history"]) == 1 and drop(f0["history"]) == drop(f1["history"])
    bundle = run["root"] / "models" / "fit"
    assert (bundle / "fit.msgpack").is_file() and (bundle / "fit_history.csv").is_file()
    assert ckpt.checkpoint_epochs(bundle / "checkpoints") == [1]
    shutil.rmtree(bundle / "checkpoints")


def test_validation_over_ranks_equals_one_process(run):
    """The 2-rank history's validation loss and dice equal one process's fit
    of the same command (rtol 1e-5); its 3 validation tiles split 2 + 1."""
    want = run["one"]["fit"]
    assert want["rc"] == 0 and len(want["history"]) == 1
    shutil.rmtree(run["root"] / "one" / "models" / "fit" / "checkpoints")
    for got, want in zip(run["ranks"][0]["fit"]["history"], want["history"]):
        for k in ("valid_loss", "dice_multi"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_an_indivisible_batch_raises(run):
    """JAX drops chips until the microbatch divides; a process cannot be
    dropped, so the port raises and names the batch, grad_accum and the
    world size."""
    msg = run["ranks"][0]["indivisible"]
    assert msg and "batch_size 6" in msg and "grad_accum=2" in msg and "2 processes" in msg
    with pytest.raises(ValueError, match="over 2 processes"):
        mesh.shard_indices(6, 2, 2, 0)


def test_doctor_mesh_check_on_gloo(run):
    """One process: a gloo group of one on the CPU, built and torn down;
    inside the two ranks' group: that group."""
    ok, detail = doctor._mesh("cpu")
    assert ok and "world of 1 over the CPU, backend gloo" in detail
    assert not mesh.is_primary() or mesh.data_size() == 1  # torn down
    for r in range(WORLD):
        ok, detail = run["ranks"][r]["mesh"]
        assert ok and "world of 2" in detail and "gloo" in detail


def test_loader_shards_partition_each_batch(run):
    """The ranks' loaders decode the samples of their shards of the same
    permutation; the padded validation batch splits 2 + 1 real samples."""
    ds = TileDataset(run["tiles"]["cls"])
    whole = TileLoader(ds, ds.train_files, B, shuffle=True, drop_last=True, seed=3,
                       n_threads=2)
    parts = [TileLoader(ds, ds.train_files, B, shuffle=True, drop_last=True, seed=3,
                        n_threads=2, shard=mesh.shard_indices(B, 2, WORLD, r))
             for r in range(WORLD)]
    try:
        for full, *shares in zip(whole, *parts):
            for r, (images, masks, n_valid) in enumerate(shares):
                idx = mesh.shard_indices(B, 2, WORLD, r)
                assert np.array_equal(images, full[0][idx]) and n_valid == 2
                assert np.array_equal(masks, full[1][idx])
        valid = [TileLoader(ds, ds.valid_files, B, n_threads=2,
                            shard=mesh.shard_indices(B, 1, WORLD, r)) for r in range(WORLD)]
        assert [[n for *_, n in ld] for ld in valid] == [[2], [1]]
        for ld in valid:
            ld.close()
    finally:
        for ld in (whole, *parts):
            ld.close()


def test_augmentation_of_a_shard_is_the_shard_of_the_batch():
    """Every op on: the shard's augmentation equals the rows of the whole
    batch's, drawn from the same generator state."""
    cfg = AugmentConfig(rot90_p=0.5, brightness_contrast_p=0.5, saturation_p=0.5,
                        coarse_dropout_p=0.5)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.integers(0, 256, (B, 3, 16, 16)).astype(np.uint8))
    masks = torch.from_numpy(rng.integers(0, 3, (B, 16, 16)).astype(np.uint8))
    whole = augment_batch(images, masks, cfg, torch.Generator().manual_seed(1), dtype_str="uint8")
    for r in range(WORLD):
        idx = mesh.shard_indices(B, 2, WORLD, r)
        got = augment_batch(images[idx], masks[idx], cfg, torch.Generator().manual_seed(1),
                            dtype_str="uint8", batch_size=B, shard=idx)
        assert torch.equal(got[0], whole[0][idx]) and torch.equal(got[1], whole[1][idx])


def test_backend_and_device_rules(monkeypatch):
    """gloo for the CPU, NCCL for a card; the caller may ask for gloo
    (``backend=``, or ``UNET_TPU_TORCH_BACKEND`` for a command line), and
    nothing is swapped in otherwise: ranks that share one host's card under
    NCCL raise, naming gloo; a missing NCCL raises; rank r takes card
    r % cards."""
    monkeypatch.delenv(mesh.BACKEND_ENV, raising=False)
    assert mesh.default_backend("cpu") == "gloo"
    assert mesh.default_backend("cuda") == "nccl"
    monkeypatch.setenv(mesh.BACKEND_ENV, "gloo")
    assert mesh.default_backend("cuda") == "gloo"
    monkeypatch.delenv(mesh.BACKEND_ENV)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: True)
    for host in ("127.0.0.1", "localhost"):
        with pytest.raises(ValueError, match="share its 1 CUDA device.*backend='gloo'"):
            mesh.init_distributed(f"{host}:1234", 2, 0, device="cuda")
    with pytest.raises(ValueError, match="backend='gloo'"):
        mesh.init_distributed("127.0.0.1:1234", 2, 1, backend="nccl", device="cuda")
    monkeypatch.setattr(torch.distributed, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        mesh.init_distributed("10.0.0.1:1234", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()
    assert mesh.init_distributed() is None and mesh.data_size() == 1  # no-op, as in JAX
    with pytest.raises(ValueError, match="coordinator"):
        mesh.init_distributed("127.0.0.1:1234", None, 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(mesh, "rank", lambda: 6)
    assert mesh.rank_device("cuda") == torch.device("cuda", 2)
    assert mesh.rank_device("cuda:1") == torch.device("cuda", 1)
    assert mesh.rank_device("cpu") == torch.device("cpu")


def test_train_cli_over_two_processes(run):
    """``train --coordinator --num-processes --process-id`` in the two
    ranks on the CPU: both exit 0, one bundle is written and only rank 0
    writes the stats file and prints the rows."""
    out0, out1 = (run["ranks"][r]["fit"]["out"] for r in range(WORLD))
    assert [run["ranks"][r]["fit"]["rc"] for r in range(WORLD)] == [0, 0], (out0, out1)
    assert (run["root"] / "models" / "fit" / "fit.msgpack").is_file()
    stats = json.loads((run["root"] / "fit0.json").read_text())
    assert stats["history"][0]["epoch"] == 0 and not (run["root"] / "fit1.json").exists()
    assert "epoch=0" in out0 and "epoch=0" not in out1
    assert "Model bundle exported" in out0 and "Model bundle exported" not in out1
