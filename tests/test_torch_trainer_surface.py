"""PyTorch port: the trainer's transfer learning, gradient accumulation,
reference quirks and profiling against the JAX package on the CPU.

``existing_model`` on a bundle the JAX package exported (the adopted
topology and the starting weights); a ``grad_accum=2`` step against the
JAX trainer's microbatch scan at float64 (the bars of
``tests/test_torch_train.py``); the reference-quirks class-weight sampler
and the float-raster truncation, bit-equal to JAX's; and ``--profile-dir``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_parity import jax_variables
from test_torch_train import _randomize
from unet_tpu.data import TileDataset as JaxTileDataset
from unet_tpu.data import compute_class_weights as jax_class_weights
from unet_tpu.data import resolve_class_weights as jax_resolve
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.train import loop as jax_loop
from unet_tpu.train import losses as jl
from unet_tpu.train.checkpoint import export_bundle as jax_export_bundle
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.data import TileDataset, TileLoader, compute_class_weights, resolve_class_weights
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.train import loop
from unet_tpu_torch.train.checkpoint import to_flax_variables

torch.set_num_threads(2)
TILE = 64
CODES = ("background", "building", "vegetation")
TRANSFORM = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)


def _write(path, a):
    write_raster(path, a, transform=TRANSFORM, crs="EPSG:25832")


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """8 trai and 3 vali 64² uint8 tiles; classes 1 and 2 where bands 0
    and 1 are bright, and class 2 only in trai tile 5."""
    root = tmp_path_factory.mktemp("surface_tiles")
    rng = np.random.default_rng(0)
    for scene, n in (("trai", 8), ("vali", 3)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            img = np.kron(rng.integers(0, 256, (3, TILE // 8, TILE // 8)),
                          np.ones((8, 8), np.int64)).astype(np.uint8)
            mask = (img[0] > 128).astype(np.uint8)
            if scene == "trai" and i == 5:
                mask[img[1] > 200] = 2
            _write(root / scene / "img_tiles" / f"{i}.tif", img)
            _write(root / scene / "mask_tiles" / f"{i}.tif", mask[None])
    return root


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_existing_model_adopts_the_jax_bundle(tiles, tmp_path):
    """A bundle exported by the JAX package (xresnet18 tpu_opt, random
    weights): from a config that says xresnet34 parity, both trainers
    adopt the bundle's arch and topology, and the port starts from the
    bundle's weights, leaf for leaf what JAX's init_variables returns."""
    x = np.zeros((1, TILE, TILE, 3), np.float32)
    v = jax_variables(jax_build_unet("xresnet18", n_out=3, c_in=3, tpu_opt=True), x,
                      np.random.default_rng(1), train=False)
    jax_export_bundle(tmp_path / "prev", "prev", v,
                      {"ARCHITECTURE": "xresnet18", "tpu_opt": True, "self_attention": False,
                       "n_out": 3, "number_of_bands": 3, "patch_size": TILE,
                       "tpu_opt_topology": 3})
    kw = dict(data_path=tiles, codes=CODES, arch="xresnet34", tpu_opt=False, batch_size=4,
              existing_model=str(tmp_path / "prev"), loader_threads=4)
    jt = jax_loop.Trainer(jax_loop.TrainerConfig(**kw))
    t = loop.Trainer(loop.TrainerConfig(device="cpu", **kw))
    try:
        for name in ("arch", "tpu_opt", "self_attention"):
            assert getattr(t.cfg, name) == getattr(jt.cfg, name), name
        assert (t.cfg.arch, t.cfg.tpu_opt) == ("xresnet18", True)
        want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jt.init_variables())))
        t.init_state()
        got = dict(_leaves(to_flax_variables(t.model.state_dict())))
        assert t.manifest()["ARCHITECTURE"] == jt.manifest()["ARCHITECTURE"] == "xresnet18"
    finally:
        t.close()
        jt.close()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_grad_accum_step_matches_jax(tiles):
    """batch 4 × 64², grad_accum 2 (xresnet18 tpu_opt, 3 classes, weighted
    CE, float32): the port's microbatch loop against JAX's scan
    (``unet_tpu/train/loop.py`` train_step, the same body) at float64 from
    the same weights — the mean loss within rtol 1e-5, each averaged
    gradient within atol 1e-4·max + rtol 1e-3, the batch_stats after both
    microbatches within 1e-5; the port's BatchNorm statistics advance
    microbatch by microbatch (they differ from one step on the whole
    batch). The weights are the init with random BatchNorm parameters and
    statistics (``_randomize`` of tests/test_torch_train.py): with every
    conv kernel random as well, the float32 gradients of some 2-sample
    batches drift 3% from float64 with or without accumulation."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, size=(4, TILE, TILE, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=(4, TILE, TILE)).astype(np.int32)
    weight = np.array([0.2, 0.5, 0.3], np.float32)
    init = init_weights(build_unet("xresnet18", n_out=3, c_in=3),
                        torch.Generator().manual_seed(0))
    v = _randomize(to_flax_variables(init.state_dict()), rng)
    with jax.enable_x64():
        jmodel = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float64, tpu_opt=True)
        loss_fn = jl.build_loss(None, False, jnp.asarray(weight, jnp.float64))

        def forward_loss(params, batch_stats, images, masks):
            logits, updates = jmodel.apply({"params": params, "batch_stats": batch_stats},
                                           images, train=True, fold_logits=True,
                                           mutable=["batch_stats"])
            logits, masks = jl.fold_loss_layout(logits, masks)
            return loss_fn(logits, masks), updates["batch_stats"]

        @jax.jit
        def accum_step(params, batch_stats, images, masks):
            def body(carry, mb):
                stats, gsum, lsum = carry
                (l, stats), g = jax.value_and_grad(forward_loss, has_aux=True)(
                    params, stats, mb[0], mb[1])
                return (stats, jax.tree_util.tree_map(jnp.add, gsum, g), lsum + l), None

            zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
            (stats, gsum, lsum), _ = jax.lax.scan(
                body, (batch_stats, zeros, jnp.float64(0)),
                (images.reshape(2, 2, *images.shape[1:]), masks.reshape(2, 2, *masks.shape[1:])))
            return lsum / 2, jax.tree_util.tree_map(lambda g: g / 2, gsum), stats

        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        want_loss, want_grads, want_stats = jax.tree_util.tree_map(np.asarray, accum_step(
            v64["params"], v64["batch_stats"], jnp.asarray(x, jnp.float64), jnp.asarray(y)))

    t = loop.Trainer(loop.TrainerConfig(data_path=tiles, codes=CODES, arch="xresnet18",
                                        batch_size=4, grad_accum=2, bf16=False,
                                        class_weights=list(weight), transforms=False,
                                        loader_threads=2, device="cpu"))
    try:
        t.set_weights(v)
        xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, 3, 1)))
        loss = t.loss_and_grads(xt, torch.from_numpy(y))
        sd = dict(t.model.state_dict())
        sd.update({n: p.grad for n, p in t.model.named_parameters()})
        got = to_flax_variables(sd)
        t.set_weights(v)
        t.cfg.grad_accum = 1
        t.loss_and_grads(xt, torch.from_numpy(y))
        whole = to_flax_variables(t.model.state_dict())["batch_stats"]
    finally:
        t.close()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for (path, g), (_, w_) in zip(jax.tree_util.tree_flatten_with_path(got["params"])[0],
                                  jax.tree_util.tree_flatten_with_path(want_grads)[0]):
        np.testing.assert_allclose(g, w_, rtol=1e-3, atol=1e-4 * np.abs(w_).max(),
                                   err_msg=jax.tree_util.keystr(path))
    differ = 0
    for (path, s), (_, w_), (_, s1) in zip(
            jax.tree_util.tree_flatten_with_path(got["batch_stats"])[0],
            jax.tree_util.tree_flatten_with_path(want_stats)[0],
            jax.tree_util.tree_flatten_with_path(whole)[0]):
        np.testing.assert_allclose(s, w_, rtol=1e-5, atol=1e-5, err_msg=jax.tree_util.keystr(path))
        differ += not np.allclose(s, s1, rtol=1e-4, atol=1e-4)
    assert differ > 0


def test_grad_accum_must_divide_the_batch(tiles):
    for trainer, cfg in ((loop.Trainer, loop.TrainerConfig), (jax_loop.Trainer,
                                                              jax_loop.TrainerConfig)):
        kw = dict(device="cpu") if trainer is loop.Trainer else {}
        with pytest.raises(ValueError, match="grad_accum=3 microbatches"):
            trainer(cfg(data_path=tiles, codes=CODES, batch_size=4, grad_accum=3, **kw))


@pytest.mark.parametrize("max_tiles,seed", [(1200, 0), (3, 0), (3, 1), (2, 4)])
def test_quirks_class_weight_sampler_bit_equal_to_jax(tiles, max_tiles, seed):
    """The reference's sampler: the first tiles of a seeded RandomState
    permutation, np.unique counts; class 2 lives in one tile, so a small
    sample can drop it from the vector, as the reference does."""
    want = jax_class_weights(tiles, 3, max_tiles=max_tiles, reference_quirks=True, seed=seed)
    got = compute_class_weights(tiles, 3, max_tiles=max_tiles, reference_quirks=True,
                                seed=seed)
    assert got == want
    assert all(isinstance(w, float) for w in got)


def test_quirks_sampler_drops_an_absent_class(tiles):
    lengths = {len(compute_class_weights(tiles, 3, max_tiles=2, reference_quirks=True, seed=s))
               for s in range(8)}
    assert lengths == {2, 3}


@pytest.mark.parametrize("regression", [False, True])
def test_resolve_class_weights_with_quirks_matches_jax(tiles, regression):
    got = resolve_class_weights("weighted", CODES, tiles, regression, reference_quirks=True)
    assert got == jax_resolve("weighted", CODES, tiles, regression, reference_quirks=True)
    assert (got == [1.0]) == regression


@pytest.mark.parametrize("quirks", [False, True])
def test_float_raster_truncation_matches_jax(tmp_path, quirks):
    """float32 image tiles with fractional and negative values: under
    reference_quirks truncated toward zero through int32 (kept float32 in
    the port, the dtype the flip_scale kernel takes), else as stored; the
    loader gives the same arrays (the Python codec: the native decoder does
    not truncate)."""
    rng = np.random.default_rng(3)
    for scene in ("trai", "vali"):
        for sub in ("img_tiles", "mask_tiles"):
            (tmp_path / scene / sub).mkdir(parents=True)
        for i in range(2):
            _write(tmp_path / scene / "img_tiles" / f"{i}.tif",
                   rng.uniform(-300, 300, (3, 16, 16)).astype(np.float32))
            _write(tmp_path / scene / "mask_tiles" / f"{i}.tif",
                   rng.integers(0, 2, (1, 16, 16)).astype(np.uint8))
    ds = TileDataset(tmp_path, reference_quirks=quirks)
    jds = JaxTileDataset(tmp_path, reference_quirks=quirks)
    loader = TileLoader(ds, ds.train_files, 2, n_threads=2)
    try:
        images, _, _ = next(iter(loader))
    finally:
        loader.close()
    for i, f in enumerate(ds.train_files):
        got, _ = ds.load_pair(f)
        want, _ = jds.load_pair(f)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want.astype(np.float32))
        np.testing.assert_array_equal(images[i], got)
        frac = np.abs(got - np.trunc(got)).max()
        assert (frac == 0) == quirks
    assert loader.path == "python" if quirks else loader.path in ("native", "python")


def test_profile_dir_writes_a_trace_and_the_phase_report(tiles, tmp_path):
    """``train --profile-dir``: a torch.profiler Chrome trace of the first
    epoch in that directory, and ``<desc>_profile.txt`` with the JAX
    trainer's phases beside the history."""
    prof = tmp_path / "prof"
    assert cli(["train", str(tiles), "--model-path", str(tmp_path), "--description", "p",
                "--codes", *CODES, "--arch", "xresnet18", "--batch-size", "4", "--epochs", "1",
                "--profile-dir", str(prof), "--reference-quirks", "--device", "cpu"]) == 0
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    report = (tmp_path / "p" / "p_profile.txt").read_text().splitlines()
    assert report[0].split() == ["phase", "count", "total_s", "mean_ms", "p50_ms", "p95_ms"]
    rows = {r.split()[0]: int(r.split()[1]) for r in report[1:]}
    assert rows == {"evaluate": 1, "h2d": 3, "loss_fetch": 1, "train_step": 2}
