"""PyTorch port: spatial partitioning (the tile height sharded over the
ranks of a space group, with halo exchanges) on the CPU, over gloo,
against the unsharded port and the JAX package.

JAX shards the height over a ``space`` mesh axis and GSPMD inserts a halo
exchange at every convolution and pool and all-reduces the BatchNorm
statistics and the loss (``unet_tpu/parallel/mesh.py``). The port does it
by hand over a process group (``parallel/mesh.py``, ``parallel/halo.py``):
rank r of a world of D × S holds rows [s·H/S, (s+1)·H/S), s = r % S, of
the samples of data index r // S.

Bars. The halo ops (3×3/1, 3×3/2, 4×4/4 convolutions, the max pool, the
blur) at S = 2 and 4 against the unsharded op at float64: the forward, the
input gradient and the weight gradient summed over the ranks within
1e-12. The sharded forward of both topologies (xresnet18; tpu_opt, and
parity with self-attention at γ = 0.5) at 64² over S = 2 and 128² over
S = 4 against JAX's unsharded ``build_unet`` forward on the same weights:
float32, atol 1e-5 and rtol 1e-4 (JAX's own bars in
``tests/test_spatial.py``). The train steps at S = 2 and D = 2 × S = 2
against the port's one-process step and JAX's step on the global batch
(float64): the bars of ``tests/test_torch_distributed.py`` (loss rtol
1e-5, running statistics 1e-5, gradients 5e-2 relative L2 with a floor of
1e-2 of the RMS), for weighted cross-entropy, dice and weighted
cross-entropy under ``UNET_TPU_BN=group:32``, and under ``slice:2``
against one process; the ranks bit-equal. The
serve tiers at S = 2 (whole, banded, streamed, and with TTA) and
``save_predictions``: float32 class maps equal to S = 1's. ``serve
--spatial 2 --device cpu`` through the command line (bf16): its map at
least 99% equal to the unsharded one (JAX's bar).

Four ranks run first (S = 4, and D = 2 × S = 2), then two worlds of two:
one trains and runs the halo ops, the other serves and runs ``api.main``;
between the two, outside any group, two of them take the one-process
references. The ranks are spawned processes; this module imports JAX only
inside the code that uses it, so they import it without JAX. The command
line's own two ranks and JAX's references run in this process meanwhile.
"""

import contextlib
import functools
import hashlib
import io
import multiprocessing as mp
import os
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_distributed as td
from unet_tpu_torch import api
from unet_tpu_torch.__main__ import ARTIFACT_SPATIAL, cli
from unet_tpu_torch.geo import read_raster, write_raster
from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.models import layers as L
from unet_tpu_torch.models.unet import TPU_OPT_TOPOLOGY_VERSION, check_spatial_height
from unet_tpu_torch.parallel import halo, mesh
from unet_tpu_torch.predict import predict as tp
from unet_tpu_torch.train import checkpoint as ckpt
from unet_tpu_torch.train import loop

torch.set_num_threads(2)
JOIN_S = 300
HALO_OPS = ("conv3s1", "conv3s2", "conv4s4", "maxpool", "blur")
TOPOLOGIES = {"tpu_opt": dict(tpu_opt=True), "parity_sa": dict(tpu_opt=False,
                                                                self_attention=True)}
SIDE = {2: 64, 4: 128}  # the forward's tile side at each S
STEP_CASES = {2: ("ce", "dice", "group"), 4: ("ce", "dice", "slice")}  # by world size
BN_VARIANTS = {"group": "group:32", "slice": "slice:2"}  # UNET_TPU_BN of the CE cases
JAX_STEPS = ("ce", "dice", "group")  # "slice" is held against one process only
SCENE_H, SCENE_W, PATCH, BATCH = 160, 200, 64, 4
CRS = "EPSG:25832"


# --- inputs, made from seeds ---------------------------------------------------

def _halo_op(name: str):
    """The op at float64: a convolution with random weights, or a pool."""
    if not name.startswith("conv"):
        return {"maxpool": L.max_pool_torch, "blur": L.replication_blur}[name]
    k, s = {"conv3s1": (3, 1), "conv3s2": (3, 2), "conv4s4": (4, 4)}[name]
    conv = L.Conv2d(3, 5, k, s, padding=L.torch_pad(k) if k == 3 else 0).double()
    g = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float64))
    return conv


@functools.lru_cache(maxsize=None)
def _weights(topology: str) -> dict:
    """xresnet18 weights as a flax tree: the init with random BatchNorm
    parameters and statistics that keep the logits O(1) (scale in [0.5,
    1], variance in [1, 2]: at variances down to 0.5 the float32 logits
    reach 70, where the port's and JAX's float32 convolutions drift apart
    by more than the 1e-5 bar whether or not the height is sharded), and
    γ = 0.5 for the attention."""
    kw = TOPOLOGIES[topology]
    model = init_weights(build_unet("xresnet18", n_out=3, c_in=3, **kw),
                         torch.Generator().manual_seed(4))
    for m in model.modules():
        if isinstance(m, L.SelfAttention):
            m.gamma.data.fill_(0.5)
    rng = np.random.default_rng(4)

    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "scale":
                out[k] = rng.uniform(0.5, 1.0, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(1.0, 2.0, v.shape).astype(np.float32)
            elif k == "mean":
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out

    return walk(ckpt.to_flax_variables(model.state_dict()))


def _forward_input(spatial: int) -> np.ndarray:
    side = SIDE[spatial]
    return np.random.default_rng(spatial).normal(size=(2, 3, side, side)).astype(np.float32)


def _port_model(topology: str):
    model = build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32,
                       **TOPOLOGIES[topology])
    sd = ckpt.from_flax_variables(_weights(topology))
    model.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()})
    return model


def _step_case(name: str):
    """(trainer overrides, UNET_TPU_BN, weights, images, targets): a case
    of ``test_torch_distributed``, or its weighted CE under a BatchNorm
    variant (``slice:2``: the statistics of the first two samples, which
    at D = 2 are the first data index's)."""
    kw, v, x, y = td._case("ce" if name in BN_VARIANTS else name)
    return kw, BN_VARIANTS.get(name, ""), v, x, y


@contextlib.contextmanager
def _bn_env(value: str):
    old = os.environ.get(L.BN_ENV)
    os.environ[L.BN_ENV] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[L.BN_ENV]
        else:
            os.environ[L.BN_ENV] = old


def _scene(root: Path) -> dict:
    """A 160×200 uint8 scene and its labels, a bundle of random xresnet18
    tpu_opt weights and four 64² prediction tiles of the scene."""
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:SCENE_H, 0:SCENE_W]
    img = np.stack([127 + 100 * np.sin(yy / 9.0 + c) * np.cos(xx / 13.0 - c)
                    + rng.normal(0, 10, yy.shape) for c in range(3)])
    img = np.clip(img, 0, 255).astype(np.uint8)
    transform = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
    write_raster(root / "scene.tif", img, transform=transform, crs=CRS)
    mask = np.where(img[0] > 150, 2, np.where(img[1] > 120, 1, 0)).astype(np.uint8)
    write_raster(root / "mask.tif", mask[None], transform=transform, crs=CRS)
    model = init_weights(build_unet("xresnet18", n_out=3, c_in=3),
                         torch.Generator().manual_seed(0))
    ckpt.export_bundle(root / "m", "m", ckpt.to_flax_variables(model.state_dict()),
                       {"ARCHITECTURE": "xresnet18", "n_out": 3, "number_of_bands": 3,
                        "patch_size": PATCH, "enable_regression": False,
                        "dtype_str": "uint8", "normalize": "unit", "tpu_opt": True,
                        "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION})
    tiles = root / "tiles" / "img_tiles"
    tiles.mkdir(parents=True)
    for i, (r, c) in enumerate([(0, 0), (0, 48), (48, 0), (96, 136)]):
        t = (transform[0] + c * 0.2, 0.2, 0.0, transform[3] - r * 0.2, 0.0, -0.2)
        write_raster(tiles / f"t{i}.tif", img[:, r:r + PATCH, c:c + PATCH], transform=t,
                     crs=CRS)
    return {"root": root, "bundle": str(root / "m"), "scene": str(root / "scene.tif"),
            "mask": str(root / "mask.tif"), "tiles": tiles}


def _serve_maps(scene: dict, out_dir: Path, spatial: int) -> dict:
    """The class maps of every tier (float32), TTA's, the whole tier's
    probabilities and the predicted tiles and merge of ``save_predictions``,
    at ``spatial``; None on a rank other than 0."""
    out_dir.mkdir(parents=True, exist_ok=True)
    pred = tp.Predictor(scene["bundle"], batch_size=BATCH, device="cpu",
                        dtype=torch.float32, spatial=spatial)
    kw = dict(patch_size=PATCH, batch_size=BATCH, device="cpu", dtype=torch.float32,
              spatial=spatial)
    out = {"whole": tp.predict_raster(scene["bundle"], scene["scene"], predictor=pred, **kw)[0],
           "banded": tp.predict_raster(scene["bundle"], scene["scene"], predictor=pred,
                                       device_budget_bytes=0, **kw)[0],
           "probs": tp.predict_raster(scene["bundle"], scene["scene"], predictor=pred,
                                      all_classes=True, **kw)[0]}
    streamed = out_dir / "streamed.tif"
    tp.predict_raster(scene["bundle"], scene["scene"], str(streamed), predictor=pred,
                      host_budget_bytes=1, **kw)
    tta = tp.Predictor(scene["bundle"], batch_size=BATCH, device="cpu", dtype=torch.float32,
                       spatial=spatial, tta=True)
    out["tta"] = tp.predict_raster(scene["bundle"], scene["scene"], predictor=tta, **kw)[0]
    tiles = out_dir / "img_tiles"
    if not tiles.exists():
        import shutil

        shutil.copytree(scene["tiles"], tiles)
    folder = tp.save_predictions(scene["bundle"], str(tiles), predictor=pred, spatial=spatial)
    merged = tp.save_predictions(scene["bundle"], str(tiles), merge=True, device_merge=True,
                                 predictor=pred, spatial=spatial, AOI="a")
    if not pred.primary:
        return {"paths": (folder, merged), **{k: v for k, v in out.items()}}
    out["streamed"] = read_raster(streamed).data[0]
    out["tiles"] = {p.name: read_raster(p).data for p in sorted(Path(folder).glob("*.tif"))}
    out["merged"] = read_raster(merged).data
    out["paths"] = (folder, merged)
    return out


def _api_params(scene: dict, root: Path) -> api.Params:
    return api.Params(
        Create_tiles=True, Train=True, Predict=True, image_path=scene["scene"],
        mask_path=scene["mask"], base_dir=str(root / "run_tiles"), patch_size=PATCH,
        split=(0.7, 0.3), max_empty=1.0, data_path=str(root / "run_tiles"),
        model_path=str(root / "run_models"), description="sp", BATCH_SIZE=2, EPOCHS=1,
        CODES=["a", "b", "c"], ARCHITECTURE="xresnet18", enable_extra_parameters=True,
        visualize_data_example=False, export_model_summary=False,
        predict_path=str(root / "run_tiles" / "vali" / "img_tiles"),
        predict_model=str(root / "run_models" / "sp"), merge=True, AOI="a",
        validation_vision=False, bf16=False, spatial=2, device="cpu")


# --- in a rank -------------------------------------------------------------------

def _halo_checks(scope) -> dict:
    """Each halo op sharded against whole: the largest differences of the
    forward, the input gradient and the summed weight gradient."""
    res = {}
    for name in HALO_OPS:
        op = _halo_op(name)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn((2, 3, 16 * scope.size, 12), generator=gen, dtype=torch.float64)
        xw = x.clone().requires_grad_(True)
        y = op(xw)
        dy = torch.randn(y.shape, generator=gen, dtype=torch.float64)
        (y * dy).sum().backward()
        params = list(op.parameters()) if isinstance(op, torch.nn.Module) else []
        want_w = [p.grad.clone() for p in params]
        for p in params:
            p.grad = None
        xl = halo.split_rows(x, 2, scope).requires_grad_(True)
        with halo.space_scope(scope):
            yl = op(xl)
        (yl * halo.split_rows(dy, 2, scope)).sum().backward()
        errs = [float((halo.gather_rows(yl.detach(), 2, scope) - y).abs().max()),
                float((halo.gather_rows(xl.grad, 2, scope) - xw.grad).abs().max())]
        for p, w in zip(params, want_w):
            errs.append(float((halo.all_reduce(p.grad, scope) - w).abs().max()))
        res[name] = errs
    return res


def _forwards(scope) -> dict:
    """Each topology's sharded forward at ``SIDE[S]``, its rows gathered."""
    x = torch.from_numpy(_forward_input(scope.size))
    out = {}
    for topology in TOPOLOGIES:
        model = _port_model(topology)
        with torch.no_grad(), halo.space_scope(scope):
            local = model(halo.split_rows(x, 2, scope))
        out[topology] = halo.gather_rows(local, 2, scope).numpy()
    return out


def _steps(tiles: dict, spatial: int, names) -> dict:
    """Each case's step on this rank's rows of its data index's samples."""
    res = {}
    for name in names:
        kw, bn, v, x, y = _step_case(name)
        with _bn_env(bn):
            t = loop.Trainer(td._cfg(tiles, spatial=spatial, **kw))
        try:
            idx = t.train_shard
            xs = halo.split_rows(torch.from_numpy(x[idx]), 2, t.space)
            ys = halo.split_rows(torch.from_numpy(y[idx]), 1, t.space)
            t.set_weights(v)
            loss = t.loss_and_grads(xs, ys)
            res[name] = {"loss": loss.item(), **td._state(t), "shard": list(idx),
                         "space": (mesh.space_rank(), mesh.space_size()),
                         "data": (mesh.data_index(), mesh.data_size())}
            assert mesh.space_group() is t.space.group
        finally:
            t.close()
    return res


def _digest(step: dict) -> str:
    """A hash of a step's loss, gradients and running statistics: ranks
    that agree bit for bit have the same."""
    h = hashlib.sha256(repr(step["loss"]).encode())
    for k, a in td._flat({"p": step["params"], "s": step["batch_stats"]}):
        h.update(k.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _closeness(got: dict, want: dict) -> dict:
    """What ``test_torch_distributed._close`` holds, as numbers: the two
    losses, the worst gradient error relative to its leaf's norm (floored
    at GRAD_FLOOR of the RMS of all of ``want``'s gradients), and the
    worst running-statistics error in units of atol 1e-5 + rtol 1e-5."""
    want_g, want_s = dict(td._flat(want["params"])), dict(td._flat(want["batch_stats"]))
    got_g, got_s = dict(td._flat(got["params"])), dict(td._flat(got["batch_stats"]))
    rms = np.sqrt(np.mean(np.concatenate([w.ravel() for w in want_g.values()]) ** 2))
    grad = max(np.linalg.norm(got_g[k] - w)
               / max(np.linalg.norm(w), td.GRAD_FLOOR * rms * np.sqrt(w.size))
               for k, w in want_g.items())
    stats = max(float(np.max(np.abs(got_s[k] - w) / (1e-5 + 1e-5 * np.abs(w))))
                for k, w in want_s.items())
    return {"loss": (got["loss"], want["loss"]), "grad": float(grad), "stats": stats,
            "same_leaves": got_g.keys() == want_g.keys() and got_s.keys() == want_s.keys()}


def _wait_for(path: Path):
    """The object this process's parent saves at ``path`` (it appears whole,
    by rename), within JOIN_S."""
    deadline = time.monotonic() + JOIN_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.2)
    return torch.load(path, weights_only=False)


def _refusals(tiles: dict, world: int) -> dict:
    out = {}
    try:
        mesh.space_layout(3)
    except ValueError as e:
        out["layout"] = str(e)
    try:
        loop.Trainer(td._cfg(tiles, spatial=world))  # 64² tiles over 4 ranks
    except ValueError as e:
        out["height"] = str(e)
    return out


def _rank(rank: int, ports: list, tiles: dict, scene: dict, out_dir: Path) -> None:
    """Phase 1: rank of a world of four (S = 4, then 2 × 2). Between the
    phases, outside any group, rank 0 takes the one-process steps and rank
    2 serves at S = 1. Phase 2: rank r % 2 of a world of two, ranks 0-1
    training, 2-3 serving."""
    torch.set_num_threads(1)
    res = {}
    try:
        mesh.init_distributed(f"127.0.0.1:{ports[0]}", 4, rank, device="cpu")
        scope4 = mesh.space_layout(4)
        res["halo4"] = _halo_checks(scope4)
        res["forward4"] = _forwards(scope4)
        res["refusals"] = _refusals(tiles, 4)
        steps = {4: _steps(tiles, 2, STEP_CASES[4])}
        mesh.close_distributed()
        pair, r = divmod(rank, 2)
        if rank == 0:
            one = _one_process_steps(tiles)
        if rank == 2:
            res["one_serve"] = _serve_maps(scene, out_dir / "one", 1)
            res["one_bf16"] = tp.predict_raster(scene["bundle"], scene["scene"],
                                                patch_size=PATCH, batch_size=BATCH,
                                                device="cpu")[0]
        mesh.init_distributed(f"127.0.0.1:{ports[1 + pair]}", 2, r, device="cpu")
        scope2 = mesh.space_layout(2)
        if pair == 0:
            res["halo2"] = _halo_checks(scope2)
            res["forward2"] = _forwards(scope2)
            steps[2] = _steps(tiles, 2, STEP_CASES[2])
        else:
            res["serve"] = _serve_maps(scene, out_dir / f"serve{r}", 2)
            stdout = io.StringIO()
            with contextlib.redirect_stdout(stdout):
                api.main(_api_params(scene, out_dir))
            res["api"] = stdout.getvalue()
        res["digests"] = {w: {n: _digest(v) for n, v in cases.items()}
                          for w, cases in steps.items()}
        res["layouts"] = {w: {n: (v["space"], v["data"]) for n, v in cases.items()}
                          for w, cases in steps.items()}
        if rank == 0:  # the gradient trees stay here: hundreds of MB a case
            refs = _wait_for(out_dir / "jax_steps.pt")
            res["close"] = {(w, n, ref): _closeness(v, (one if ref == "one" else refs)[n])
                            for w, cases in steps.items() for n, v in cases.items()
                            for ref in ("one", "jax") if ref == "one" or n in JAX_STEPS}
    except Exception:
        res["error"] = traceback.format_exc()
    finally:
        mesh.close_distributed()
        torch.save(res, out_dir / f"rank{rank}.pt")


# --- this process ------------------------------------------------------------------

def _jax_forwards() -> dict:
    """JAX's unsharded float32 forward of each topology and size."""
    import jax
    import jax.numpy as jnp

    from unet_tpu.models import build_unet as jax_build_unet

    out = {}
    for topology, kw in TOPOLOGIES.items():
        model = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float32, **kw)
        forward = jax.jit(lambda v, x, m=model: m.apply(v, x, train=False))
        for s in SIDE:
            x = np.moveaxis(_forward_input(s), 1, 3)
            y = forward(_weights(topology), x)
            out[topology, s] = np.moveaxis(np.asarray(y), 3, 1)
    return out


def _jax_steps(path: Path) -> None:
    """JAX's float64 steps on the global batch, saved to ``path`` in
    float32 for rank 0 to read: CE and dice, and CE under
    ``UNET_TPU_BN=group:32`` (JAX's factory reads it when it traces)."""
    _, _, v, x, y = _step_case("ce")
    refs = td._jax_references(["ce", "dice"], v, x, y)
    with _bn_env(BN_VARIANTS["group"]):
        refs["group"] = td._jax_references(["ce"], v, x, y)["ce"]

    def narrow(tree):
        return {k: narrow(a) if isinstance(a, dict) else np.asarray(a, np.float32)
                for k, a in tree.items()}

    torch.save({n: {"loss": r["loss"], "params": narrow(r["params"]),
                    "batch_stats": narrow(r["batch_stats"])} for n, r in refs.items()},
               path.with_suffix(".tmp"))
    os.replace(path.with_suffix(".tmp"), path)


def _one_process_steps(tiles: dict) -> dict:
    out = {}
    for name in dict.fromkeys(STEP_CASES[2] + STEP_CASES[4]):
        kw, bn, v, x, y = _step_case(name)
        with _bn_env(bn):
            t = loop.Trainer(td._cfg(tiles, **kw))
        try:
            out[name] = td._step(t, v, x, y)
        finally:
            t.close()
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("spatial")
    tiles = {"cls": td._tiles(root / "cls", False), "mse": td._tiles(root / "mse", True)}
    scene = _scene(root)
    ports = []
    while len(ports) < 3:
        ports += [p for p in [mesh.free_port()] if p not in ports]
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, ports, tiles, scene, root)) for r in range(4)]
    for p in procs:
        p.start()
    cli_out, cli_rc = root / "cli.tif", []
    # the command line's two ranks, on a thread: its launcher only waits
    serve = threading.Thread(target=lambda: cli_rc.append(cli([
        "serve", scene["bundle"], scene["scene"], str(cli_out), "--spatial", "2",
        "--device", "cpu", "--patch-size", str(PATCH), "--batch-size", str(BATCH),
        "--stats-json", str(root / "cli.json")])))
    serve.start()
    try:
        _jax_steps(root / "jax_steps.pt")
        jax_forwards = _jax_forwards()
    finally:
        serve.join(JOIN_S)
        for p in procs:
            p.join(JOIN_S)
        alive = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    assert not any(alive) and not serve.is_alive(), "a rank did not finish"
    (root / "jax_steps.pt").unlink(missing_ok=True)  # three gradient trees
    ranks = [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(4)]
    for r, res in enumerate(ranks):
        assert "error" not in res, f"rank {r}:\n{res['error']}"
    one = {"serve": ranks[2]["one_serve"], "cli": ranks[2]["one_bf16"]}
    return {"ranks": ranks, "one": one, "jax": {"forward": jax_forwards}, "root": root,
            "scene": scene, "cli": (cli_rc[0], cli_out)}


# --- the tests ---------------------------------------------------------------------

@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("op", HALO_OPS)
def test_halo_op_equals_the_unsharded_op(run, spatial, op):
    """Forward, input gradient and (convolutions) the weight gradient
    summed over the ranks, at float64, on every rank."""
    ranks = range(4) if spatial == 4 else range(2)
    for r in ranks:
        errs = run["ranks"][r][f"halo{spatial}"][op]
        assert len(errs) == (4 if op.startswith("conv") else 2)
        assert max(errs) <= 1e-12, (r, errs)


@pytest.mark.parametrize("spatial", [2, 4])
@pytest.mark.parametrize("topology", list(TOPOLOGIES))
def test_sharded_forward_matches_jax_unsharded(run, spatial, topology):
    """The ranks' gathered logits are equal, and JAX's unsharded forward on
    the same weights within atol 1e-5, rtol 1e-4."""
    got = [run["ranks"][r][f"forward{spatial}"][topology]
           for r in (range(4) if spatial == 4 else range(2))]
    for g in got[1:]:
        np.testing.assert_array_equal(g, got[0])
    np.testing.assert_allclose(got[0], run["jax"]["forward"][topology, spatial],
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("world,name", [(2, n) for n in STEP_CASES[2]]
                         + [(4, n) for n in STEP_CASES[4]])
def test_spatial_step_equals_one_process_and_jax(run, world, name):
    """S = 2 (world 2) and D = 2 × S = 2 (world 4): the ranks end
    bit-equal (loss, gradients, running statistics); rank 0's step equals
    one process's and (but for ``slice:2``) JAX's on the global batch
    (float64) within the bars of ``test_torch_distributed``."""
    ranks = run["ranks"][:world]
    assert len({res["digests"][world][name] for res in ranks}) == 1
    assert [res["layouts"][world][name] for res in ranks] == [
        ((r % 2, 2), (r // 2, world // 2)) for r in range(world)]
    for ref in ("one", "jax") if name in JAX_STEPS else ("one",):
        c = ranks[0]["close"][world, name, ref]
        assert c["same_leaves"], ref
        np.testing.assert_allclose(*c["loss"], rtol=1e-5, err_msg=ref)
        assert c["grad"] <= td.GRAD_REL_L2 and c["stats"] <= 1, (ref, c)


@pytest.mark.parametrize("what", ["whole", "banded", "streamed", "tta", "probs", "tiles",
                                  "merged"])
def test_spatial_serve_equals_unsharded(run, what):
    """Rank 0 of S = 2 against S = 1, float32: class maps, tiles and the
    device merge equal; the whole tier's probabilities within 1e-5. Rank 1
    returns no map and the same output paths."""
    got, want = run["ranks"][2]["serve"], run["one"]["serve"]
    follower = run["ranks"][3]["serve"]
    assert follower[what if what in ("whole", "banded", "probs", "tta") else "whole"] is None
    assert [Path(p).name for p in follower["paths"]] == [Path(p).name for p in got["paths"]]
    if what == "probs":
        assert got[what].shape == (3, SCENE_H, SCENE_W)
        np.testing.assert_allclose(got[what], want[what], rtol=0, atol=1e-5)
    elif what == "tiles":
        assert sorted(got[what]) == sorted(want[what]) == [f"t{i}.tif" for i in range(4)]
        for k in want[what]:
            np.testing.assert_array_equal(got[what][k], want[what][k])
    else:
        assert got[what].dtype == np.uint8
        np.testing.assert_array_equal(got[what], want[what])


def test_api_main_trains_and_predicts_under_spatial(run):
    """``api.main`` with ``spatial=2`` inside a group of two: rank 0 tiles,
    both ranks train (one bundle) and predict (one mosaic); rank 0 prints
    the rows."""
    out2, out3 = run["ranks"][2]["api"], run["ranks"][3]["api"]
    assert "epoch=0" in out2 and "epoch=0" not in out3
    root = run["root"]
    assert (root / "run_models" / "sp" / "sp.msgpack").is_file()
    assert (root / "run_tiles" / "vali" / "a_sp_prediction.tif").is_file()
    assert len(list((root / "run_tiles" / "trai" / "img_tiles").glob("*.tif"))) > 0


def test_cli_serve_spatial_two_ranks(run):
    """``serve --spatial 2 --device cpu``: the command starts two gloo
    ranks; exit 0, rank 0's stats, the bf16 map >= 99% equal to the
    unsharded serve's (JAX's bar)."""
    import json

    rc, out = run["cli"]
    assert rc == 0
    got = read_raster(out).data[0]
    assert (got == run["one"]["cli"]).mean() >= 0.99
    stats = json.loads((run["root"] / "cli.json").read_text())
    assert stats["spatial"] == 2 and stats["windows"] > 0


def test_refusals_before_any_compute(run, tmp_path, monkeypatch):
    """A world that does not split into spatial groups, a tile height not
    divisible by 32·S, no process group, more ranks than cards under NCCL
    (JAX's words beside the port's), and a ``.uta`` model with
    ``--spatial`` (JAX's words) are refused."""
    refusals = run["ranks"][0]["refusals"]
    assert "4 devices do not divide into spatial=3 groups" in refusals["layout"]
    assert "divisible by 32·4 = 128" in refusals["height"] and "got 64" in refusals["height"]
    with pytest.raises(ValueError, match="spatial=2 needs that many devices, have 1.*launch"):
        mesh.space_layout(2)
    with pytest.raises(ValueError, match="launch"):
        tp.Predictor(run["scene"]["bundle"], device="cpu", spatial=2)
    with pytest.raises(ValueError, match="32·2 = 64"):
        check_spatial_height("xresnet18", 96, 2)
    check_spatial_height("xresnet34_deep", 256, 2)
    with pytest.raises(ValueError, match="128·2 = 256"):
        check_spatial_height("xresnet34_deep", 128, 2)
    with monkeypatch.context() as m:
        m.delenv(mesh.BACKEND_ENV, raising=False)
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        m.setattr(torch.distributed, "is_nccl_available", lambda: True)
        with pytest.raises(ValueError, match="spatial=2 needs that many devices, have 1: "
                                             "2 ranks .*backend='gloo'"):
            mesh.launch(2, "unet_tpu_torch.__main__:rank_command", device="cuda")
    uta = tmp_path / "m.uta"
    with open(uta, "wb") as f:
        np.savez(f, __utaot__=np.zeros(1, np.uint8))
    for cmd in (["serve", str(uta), run["scene"]["scene"], str(tmp_path / "o.tif")],
                ["predict", str(uta), str(run["scene"]["tiles"])]):
        with pytest.raises(SystemExit, match="needs a live model bundle") as e:
            cli([*cmd, "--spatial", "2", "--device", "cpu"])
        assert str(e.value) == ARTIFACT_SPATIAL


def exit_by_rank(codes):
    """A launched rank's target: exit with ``codes[rank]`` (raise for None)."""
    code = codes[torch.distributed.get_rank()]
    if code is None:
        raise RuntimeError("this rank fails")
    return code


@pytest.mark.parametrize("codes,want", [((2, 0), 2), ((0, None), 1)])
def test_launcher_exit_code(codes, want):
    """``mesh.launch`` returns the exit code of the first rank that fails
    (an exception exits 1); the command line's launch that exits 0 is
    ``test_cli_serve_spatial_two_ranks``."""
    assert mesh.launch(2, "test_torch_spatial:exit_by_rank", (codes,), device="cpu") == want
