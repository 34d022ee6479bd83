"""PyTorch port: the train step's pieces against the JAX package on the CPU.

The folded-logits loss, DiceMulti, the fastai Adam under the one-cycle
schedule, the model's float32 gradients (the JAX trainer's
``forward_loss``, augmentation off), and the copied dataset, loader and
class weights. Inputs come from numpy seeds; each test states its
tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.data import TileDataset as JaxTileDataset
from unet_tpu.data import TileLoader as JaxTileLoader
from unet_tpu.data import get_datatype as jax_get_datatype
from unet_tpu.data import get_patch_size as jax_get_patch_size
from unet_tpu.data import resolve_class_weights as jax_class_weights
from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.train import losses as jl
from unet_tpu.train import metrics as jm
from unet_tpu.train import schedule as js
from unet_tpu.train.optimizer import one_cycle_adam
from unet_tpu_torch.data import (TileDataset, TileLoader, get_datatype,
                                 get_patch_size, resolve_class_weights)
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.models import build_unet
from unet_tpu_torch.train import losses as tl
from unet_tpu_torch.train import metrics as tm
from unet_tpu_torch.train import schedule as ts
from unet_tpu_torch.train.checkpoint import from_flax_variables, to_flax_variables
from unet_tpu_torch.train.optimizer import OneCycleAdam, param_group_label

torch.set_num_threads(2)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


@pytest.mark.parametrize("weighted", [False, True])
def test_folded_cross_entropy_matches_jax_and_full_res(weighted):
    """Weighted CE of pre-shuffle logits (B, C·4, h, w) against full-res
    targets equals JAX's cross_entropy(fold_loss_layout(...)) and the port's
    own full-resolution CE on the pixel-shuffled logits: rtol 1e-5 (float32
    sums in another order)."""
    rng = np.random.default_rng(0)
    b, c, h, w = 3, 4, 5, 6
    folded = rng.normal(size=(b, h, w, c * 4)).astype(np.float32)  # JAX NHWC
    targets = rng.integers(0, c, size=(b, 2 * h, 2 * w))
    weight = rng.uniform(0.1, 2.0, c).astype(np.float32) if weighted else None
    lg, t = jl.fold_loss_layout(jnp.asarray(folded), jnp.asarray(targets))
    want = float(jl.cross_entropy(lg, t, None if weight is None else jnp.asarray(weight)))
    wt = None if weight is None else torch.from_numpy(weight)
    logits = _nchw(folded)
    got = tl.cross_entropy(*tl.fold_loss_layout(logits, torch.from_numpy(targets)), wt)
    full = torch.nn.functional.pixel_shuffle(logits, 2)
    got_full = tl.cross_entropy(full, torch.from_numpy(targets), wt)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)
    np.testing.assert_allclose(got_full.item(), want, rtol=1e-5)
    torch_ce = torch.nn.functional.cross_entropy(full, torch.from_numpy(targets), weight=wt)
    np.testing.assert_allclose(got_full.item(), torch_ce.item(), rtol=1e-5)


def test_cross_entropy_sample_mask_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 6, 7, 3)).astype(np.float32)
    targets = rng.integers(0, 3, size=(4, 6, 7))
    weight = np.array([0.2, 1.0, 3.0], np.float32)
    mask = np.array([True, True, False, True])
    want = float(jl.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                                  jnp.asarray(weight), jnp.asarray(mask)))
    got = tl.build_loss(None, torch.from_numpy(weight))(
        _nchw(logits), torch.from_numpy(targets), sample_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)  # float32 sum order
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tl.build_loss("focal")


def test_dice_multi_matches_jax():
    """Two batches, one padded, a class absent from both: exact counts,
    value within 1e-6."""
    rng = np.random.default_rng(2)
    sj, st = jm.dice_multi_init(4), tm.dice_multi_init(4)
    for n_valid in (3, 2):
        logits = rng.normal(size=(3, 8, 9, 4)).astype(np.float32)
        logits[..., 3] -= 100  # class 3 is never predicted
        targets = rng.integers(0, 3, size=(3, 8, 9))
        mask = np.arange(3) < n_valid
        sj = jm.dice_multi_update(sj, jnp.asarray(logits), jnp.asarray(targets),
                                  jnp.asarray(mask))
        st = tm.dice_multi_update(st, _nchw(logits), torch.from_numpy(targets),
                                  torch.from_numpy(mask))
    for k in ("inter", "union"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
    np.testing.assert_allclose(float(tm.dice_multi_value(st)),
                               float(jm.dice_multi_value(sj)), rtol=1e-6)


def test_schedules_match_jax():
    for n in (1, 3, 5):
        np.testing.assert_allclose(ts.even_mults(1e-4, 1e-3, n), js.even_mults(1e-4, 1e-3, n),
                                   rtol=1e-12)
    lr_t, lr_j = ts.one_cycle_lr(1e-3, 37), js.one_cycle_lr(1e-3, 37)
    mom_t, mom_j = ts.one_cycle_momentum(37), js.one_cycle_momentum(37)
    for step in range(0, 40):
        assert lr_t(step) == lr_j(step) and mom_t(step) == mom_j(step)


def test_param_groups_follow_the_xresnet_split():
    assert param_group_label("encoder.stem_0.conv.weight") == 0
    assert param_group_label("encoder.stage_2_block_1.conv1.bn.bias") == 1
    assert param_group_label("mid_bn.weight") == 2
    assert param_group_label("up_0.shuf.convt.weight") == 2
    assert param_group_label("head.bias") == 2


def test_one_cycle_adam_matches_jax():
    """Seven updates over a 10-step cycle (warm-up and anneal), from the
    same params and grads, three LR groups, decay on kernels only:
    parameters within 1e-6 of JAX's."""
    rng = np.random.default_rng(3)
    shapes = {("encoder", "stem_0", "conv", "kernel"): (3, 3, 2, 4),
              ("encoder", "stem_0", "bn", "scale"): (4,),
              ("encoder", "stage_0_block_0", "conv1", "conv", "kernel"): (3, 3, 4, 4),
              ("encoder", "stage_0_block_0", "conv1", "bn", "bias"): (4,),
              ("up_0", "conv1", "conv", "bias"): (5,),
              ("head", "kernel"): (1, 1, 4, 3)}
    params = {}
    for path, shape in shapes.items():
        d = params
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = rng.normal(size=shape).astype(np.float32)
    grads = [jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32)
                                    * rng.choice([1e-3, 1.0]), params) for _ in range(7)]
    tx, _ = one_cycle_adam(jax.tree_util.tree_map(jnp.asarray, params), 1e-3, 10)
    pj = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(pj)
    named = [(".".join(p), torch.from_numpy(np.array(v)))
             for p, v in ((tuple(k.key for k in path), v)
                          for path, v in jax.tree_util.tree_flatten_with_path(params)[0])]
    opt = OneCycleAdam(named, 1e-3, 10)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, pj)
        pj = jax.tree_util.tree_map(lambda p, u: p + u, pj, upd)
        for (_, p), v in zip(named, jax.tree_util.tree_leaves(g)):
            p.grad = torch.from_numpy(np.asarray(v, np.float32))
        opt.step()
    for (name, p), want in zip(named, jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(p.numpy(), np.asarray(want), rtol=0, atol=1e-6,
                                   err_msg=name)


def _randomize(variables, rng):
    """Random BatchNorm scale/bias/statistics and conv biases, so every
    path (BatchZero branches included) carries gradient."""
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
                out[k] = np.asarray(v)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, variables))


def test_model_gradients_match_jax_forward_loss():
    """One train-mode forward + weighted CE on the folded logits + backward
    from the same flax weights and batch, as the JAX trainer's
    ``forward_loss`` (train/loop.py:305-324) computes it; xresnet18, 64²,
    batch 2, 3 classes. The port runs at float32; JAX's gradients are taken
    at float64 (x64 on, the same model at dtype float64) because JAX's own
    float32 gradients of the folded stem are ~4e-2 off its float64 ones on
    the CPU, while the port's stay within 3e-5. Loss within rtol 1e-5;
    updated batch_stats within 1e-5; each parameter's gradient within
    atol 1e-4·max|grad| + rtol 1e-3."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, size=(2, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 3, size=(2, 64, 64)).astype(np.int32)
    weight = np.array([0.2, 0.5, 0.3], np.float32)
    init = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float32, tpu_opt=True)
    v = _randomize(init.init(jax.random.PRNGKey(0), x, train=False), rng)
    with jax.enable_x64():
        jmodel = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float64,
                                tpu_opt=True)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        loss_fn = jl.build_loss(None, False, jnp.asarray(weight, jnp.float64))

        def forward_loss(params, batch_stats, images, masks):
            logits, updates = jmodel.apply({"params": params, "batch_stats": batch_stats},
                                           images, train=True, fold_logits=True,
                                           mutable=["batch_stats"])
            logits, masks = jl.fold_loss_layout(logits, masks)
            return loss_fn(logits, masks), updates["batch_stats"]

        (want_loss, want_stats), want_grads = jax.value_and_grad(
            forward_loss, has_aux=True)(v64["params"], v64["batch_stats"],
                                        jnp.asarray(x, jnp.float64), jnp.asarray(y))
        want_grads = jax.tree_util.tree_map(np.asarray, want_grads)
        want_stats = jax.tree_util.tree_map(np.asarray, want_stats)

    model = build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32).train()
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in from_flax_variables(v).items()})
    logits = model(_nchw(x), fold_logits=True)
    loss = tl.cross_entropy(*tl.fold_loss_layout(logits, torch.from_numpy(y)),
                            torch.from_numpy(weight))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)

    sd = dict(model.state_dict())
    sd.update({n: p.grad for n, p in model.named_parameters()})
    got = to_flax_variables(sd)
    for (path, g), (_, w_) in zip(jax.tree_util.tree_flatten_with_path(got["params"])[0],
                                  jax.tree_util.tree_flatten_with_path(want_grads)[0]):
        np.testing.assert_allclose(g, w_, rtol=1e-3, atol=1e-4 * np.abs(w_).max(),
                                   err_msg=jax.tree_util.keystr(path))
    for (path, s), (_, w_) in zip(jax.tree_util.tree_flatten_with_path(got["batch_stats"])[0],
                                  jax.tree_util.tree_flatten_with_path(want_stats)[0]):
        np.testing.assert_allclose(s, np.asarray(w_), rtol=1e-5, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """A tile tree: 5 trai, 2 vali and 1 test tiles, 3-band uint8 16×12
    with uint8 masks of 3 classes."""
    root = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(5)
    for scene, n in (("trai", 5), ("vali", 2), ("test", 1)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            t = (500000.0 + 10 * i, 0.2, 0.0, 5400000.0, 0.0, -0.2)
            write_raster(root / scene / "img_tiles" / f"t{i}.tif",
                         rng.integers(0, 256, (3, 16, 12)).astype(np.uint8),
                         transform=t, crs="EPSG:25832")
            write_raster(root / scene / "mask_tiles" / f"t{i}.tif",
                         rng.integers(0, 3, (1, 16, 12)).astype(np.uint8),
                         transform=t, crs="EPSG:25832")
    return root


def test_dataset_matches_jax(tiles):
    ds, jds = TileDataset(tiles), JaxTileDataset(tiles)
    assert [str(p) for p in ds.train_files] == [str(p) for p in jds.train_files]
    assert [str(p) for p in ds.valid_files] == [str(p) for p in jds.valid_files]
    assert ds.n_train == 6 and ds.n_valid == 2  # test/ lands in train
    for f in ds.train_files:
        for a, b in zip(ds.load_pair(f), jds.load_pair(f)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert get_datatype(tiles) == jax_get_datatype(tiles) == "int8"
    assert get_patch_size(tiles) == jax_get_patch_size(tiles)


@pytest.mark.parametrize("spec", ["even", "weighted", [1.0, 2.0, 0.5]])
def test_class_weights_match_jax(tiles, spec):
    codes = ["a", "b", "c"]
    assert resolve_class_weights(spec, codes, tiles) == \
        jax_class_weights(spec, codes, tiles)


@pytest.mark.parametrize("train", [True, False])
def test_loader_matches_jax(tiles, train, monkeypatch):
    """Same batches in the same order (the shuffle is the same seeded numpy
    permutation), images NCHW in the port, NHWC in JAX; the last
    validation batch padded by repeating its final tile."""
    monkeypatch.setenv("UNET_TPU_LOADER", "python")
    ds, jds = TileDataset(tiles), JaxTileDataset(tiles)
    files = ds.train_files if train else ds.valid_files
    kw = dict(shuffle=train, drop_last=train, seed=3, n_threads=2)
    ld = TileLoader(ds, files, 4 if train else 3, **kw)
    jld = JaxTileLoader(jds, files, 4 if train else 3, **kw)
    try:
        assert len(ld) == len(jld)
        for _ in range(2):  # two epochs: a new permutation each
            got, want = list(ld), list(jld)
            assert len(got) == len(want) == len(ld)
            for (gi, gm, gn), (wi, wm, wn) in zip(got, want):
                assert gn == wn and gi.dtype == np.uint8
                np.testing.assert_array_equal(np.moveaxis(gi, 1, 3), wi)
                np.testing.assert_array_equal(gm, wm)
    finally:
        ld.close()
        jld.close()
