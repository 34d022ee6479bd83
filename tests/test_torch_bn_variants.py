"""PyTorch port: the BatchNorm variants ``UNET_TPU_BN`` selects, against the
JAX package's on the CPU.

For every value JAX accepts (unset, ``fused``, ``pallas`` — run as
``tests/test_pallas_bn.py`` runs it, with ``UNET_TPU_BN_MULTIDEVICE=1`` —,
``slice:4``, ``slice``, ``group:16``, ``group``): a ConvLayer's train-mode
output, its running statistics after the step and the gradients of the
input and every parameter, from the same weights, in float32 (and, for
unset, ``fused`` and ``pallas``, the bf16 output against JAX's); the
flagship's wiring (every BatchNorm site takes the variable) on a whole
xresnet18 U-Net; bundles loading across the switch in both packages; a
trained bundle and its artifact serving the variant they were trained
with whatever the variable says; an unknown value refused; and ``slice``
over two gloo ranks against one process, with k below and above a rank's
share of the batch.

The ranks run in spawned processes: JAX is imported only inside the tests
that use it, so the children import this module without it.
"""

import json
import multiprocessing as mp
import traceback

import numpy as np
import pytest
import torch

from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.models import layers as tl
from unet_tpu_torch.parallel import mesh
from unet_tpu_torch.train.checkpoint import (export_bundle, from_flax_variables, load_bundle,
                                             to_flax_variables)

torch.set_num_threads(2)
VARIANTS = ["", "fused", "pallas", "slice:4", "slice", "group:16", "group"]
N, H, W, C_IN, C = 6, 8, 8, 5, 24  # N·H·W = 384 blocks for the Pallas kernels; C >= 8


def _set(monkeypatch, value):
    monkeypatch.delenv("UNET_TPU_BN", raising=False)
    if value:
        monkeypatch.setenv("UNET_TPU_BN", value)


def _randomize(v, rng):
    def walk(d):
        out = {}
        for k, a in d.items():
            if isinstance(a, dict):
                out[k] = walk(a)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, np.shape(a)).astype(np.float32)
            elif k in ("mean", "bias"):
                out[k] = rng.normal(0, 0.2, np.shape(a)).astype(np.float32)
            else:
                out[k] = np.asarray(a, np.float32)
        return out

    return walk(v)


@pytest.mark.parametrize("variant", VARIANTS)
def test_conv_layer_variant_matches_jax(variant, monkeypatch):
    """conv → BatchNorm variant → ReLU in training mode, float32: the
    output within 1e-5, the running statistics after the step within 1e-5
    (unchanged for group), and the gradients of x, the kernel, the scale
    and the bias of ``sum(y · r)`` within rtol 1e-4 / atol 1e-5 of max."""
    import jax
    import jax.numpy as jnp

    from unet_tpu.models import layers as jl

    _set(monkeypatch, variant)
    monkeypatch.setenv("UNET_TPU_BN_MULTIDEVICE", "1")
    rng = np.random.default_rng(7)
    x = rng.normal(1.0, 2.0, (N, H, W, C_IN)).astype(np.float32)
    r = rng.normal(size=(N, H, W, C)).astype(np.float32)
    jmod = jl.ConvLayer(C, 3, dtype=jnp.float32)
    v = _randomize(jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda k: jmod.init(k, jnp.asarray(x), True))(jax.random.PRNGKey(0))), rng)

    def loss(params, x_):
        y, upd = jmod.apply({"params": params, "batch_stats": v["batch_stats"]}, x_, True,
                            mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd["batch_stats"])

    (_, (want_y, want_stats)), (want_gp, want_gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))

    port = tl.ConvLayer(C_IN, C, 3).train()
    kind = {"": tl.BatchNorm, "fused": tl.BatchNorm, "pallas": tl.BatchNorm}.get(
        variant, tl.SliceBatchNorm if variant.startswith("slice") else tl.GroupNormAsBN)
    assert type(port.bn) is kind
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          from_flax_variables(v).items()})
    xt = torch.from_numpy(np.moveaxis(x, -1, 1).copy()).requires_grad_(True)
    y = port(xt)
    (y * torch.from_numpy(np.moveaxis(r, -1, 1).copy())).sum().backward()
    np.testing.assert_allclose(np.moveaxis(y.detach().numpy(), 1, -1), want_y,
                               rtol=1e-5, atol=1e-5)
    sd = dict(port.state_dict())
    got_stats = to_flax_variables(sd)["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_stats["bn"][k], want_stats["bn"][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    sd.update({n: p.grad for n, p in port.named_parameters()})
    got = to_flax_variables(sd)["params"]
    pairs = [(got["conv"]["kernel"], want_gp["conv"]["kernel"], "kernel"),
             (got["bn"]["scale"], want_gp["bn"]["scale"], "scale"),
             (got["bn"]["bias"], want_gp["bn"]["bias"], "bias"),
             (np.moveaxis(xt.grad.numpy(), 1, -1), want_gx, "x")]
    for g, w, name in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(), err_msg=name)
    if variant in ("", "fused", "pallas"):
        _bf16_order(jl.ConvLayer(C, 3, dtype=jnp.bfloat16), v, x, variant)


def _bf16_order(jmod, v, x, variant):
    """The same layer and weights in bf16, training mode: the port (flax's
    order: normalize in float32, then cast) equals JAX's default bit for
    bit; JAX's ``fused`` and ``pallas`` cast to bf16 before they normalize,
    so they may differ by up to one bf16 step at the output's largest
    magnitude, never more. The differing share and the largest difference
    are printed (ROADMAP §3)."""
    import jax.numpy as jnp

    want, _ = jmod.apply(v, jnp.asarray(x, jnp.bfloat16), True, mutable=["batch_stats"])
    want = np.asarray(want.astype(jnp.float32))
    port = tl.ConvLayer(C_IN, C, 3).train()
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          from_flax_variables(v).items()})
    with torch.no_grad():
        got = port(torch.from_numpy(np.moveaxis(x, -1, 1).copy()).to(torch.bfloat16))
    got = np.moveaxis(got.float().numpy(), 1, -1)
    d = np.abs(got - want)
    print(f"UNET_TPU_BN={variant or 'unset'} bf16: port vs JAX max {d.max():.4f}, "
          f"{100 * (d > 0).mean():.1f}% of outputs differ (max |y| {np.abs(want).max():.2f})")
    if not variant:
        np.testing.assert_array_equal(got, want)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert d.max() <= step, (d.max(), step)


@pytest.mark.parametrize("variant", ["slice:4", "group:16"])
def test_unet_variant_forward_and_stats_match_jax(variant, monkeypatch):
    """The whole xresnet18 tpu_opt U-Net under the variable, float32,
    training mode, batch 6 at 64²: the folded logits within 1e-4 relative
    to their scale and every running statistic within 1e-4, so each
    BatchNorm site of the port (stem, encoder, middle, decoder skips) takes
    the variant JAX's does."""
    import jax
    import jax.numpy as jnp

    from test_torch_parity import jax_variables
    from unet_tpu.models import build_unet as jax_build_unet

    _set(monkeypatch, variant)
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (6, 64, 64, 3)).astype(np.float32)
    jmodel = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float32, tpu_opt=True)
    v = jax_variables(jmodel, x[:1], rng, train=False)
    want, upd = jax.jit(lambda v_, x_: jmodel.apply(v_, x_, train=True, fold_logits=True,
                                                    mutable=["batch_stats"]))(v, x)
    model = build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32).train()
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in from_flax_variables(v).items()})
    with torch.no_grad():
        got = model(torch.from_numpy(np.moveaxis(x, -1, 1).copy()), fold_logits=True)
    want = np.asarray(want)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    got_stats = to_flax_variables(model.state_dict())["batch_stats"]
    flat_w = jax.tree_util.tree_flatten_with_path(upd["batch_stats"])[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got_stats)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    n_sites = sum(isinstance(m, tl.BatchNorm) for m in model.modules())
    kind = tl.SliceBatchNorm if variant.startswith("slice") else tl.GroupNormAsBN
    assert n_sites == sum(isinstance(m, kind) for m in model.modules()) > 0


@pytest.mark.parametrize("variant", ["slice", "group"])
def test_bundle_trained_under_a_variant_loads_unset(variant, monkeypatch, tmp_path):
    """A bundle the port writes after a training step under the variant
    loads, with ``UNET_TPU_BN`` unset, in the port (strict) and in JAX
    (its ``load_bundle``), weights equal; the port's trees are the same
    under every variant."""
    from unet_tpu.train.checkpoint import load_bundle as jax_load_bundle

    _set(monkeypatch, variant)
    model = init_weights(build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32),
                         torch.Generator().manual_seed(0)).train()
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    model(x, fold_logits=True).square().mean().backward()
    with torch.no_grad():
        for p in model.parameters():
            p -= 0.1 * p.grad
    manifest = {"ARCHITECTURE": "xresnet18", "n_out": 3, "number_of_bands": 3,
                "patch_size": 64, "enable_regression": False, "dtype_str": "uint8",
                "normalize": "unit", "self_attention": False, "tpu_opt": True,
                "tpu_opt_topology": 3}
    export_bundle(tmp_path / "b", "b", to_flax_variables(model.state_dict()), manifest)
    keys = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    monkeypatch.delenv("UNET_TPU_BN")
    port, _ = load_bundle(tmp_path / "b", dtype=torch.float32)
    assert {k: tuple(t.shape) for k, t in port.state_dict().items()} == keys
    for k, t in model.state_dict().items():
        assert torch.equal(port.state_dict()[k], t), k
    _, jv, _ = jax_load_bundle(str(tmp_path / "b"))
    want = to_flax_variables(model.state_dict())
    import jax

    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jv)[0],
                                 jax.tree_util.tree_flatten_with_path(want)[0]):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))


def _tile_set(root, tile=32, n=4):
    """``trai`` and ``vali`` tiles (3-band uint8 blocks, a mask a function
    of the image) and a 64 × 96 scene of the same kind."""
    from unet_tpu_torch.geo import write_raster

    rng = np.random.default_rng(5)
    transform = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)

    def blocks(h, w):
        img = np.kron(rng.integers(0, 256, (3, h // 8, w // 8)),
                      np.ones((8, 8), np.int64)).astype(np.uint8)
        return img, np.where(img[0] > 160, 1, np.where(img[1] > 160, 2, 0)).astype(np.uint8)

    for scene in ("trai", "vali"):
        for sub in ("img_tiles", "mask_tiles"):
            (root / "tiles" / scene / sub).mkdir(parents=True)
        for i in range(n):
            img, mask = blocks(tile, tile)
            write_raster(root / "tiles" / scene / "img_tiles" / f"{i}.tif", img,
                         transform=transform, crs="EPSG:25832")
            write_raster(root / "tiles" / scene / "mask_tiles" / f"{i}.tif", mask[None],
                         transform=transform, crs="EPSG:25832")
    write_raster(root / "scene.tif", blocks(64, 96)[0], transform=transform,
                 crs="EPSG:25832")
    return root / "tiles", root / "scene.tif"


@pytest.mark.parametrize("trained,served", [("group:4", ""), ("", "group:4")])
def test_bundle_and_artifact_serve_the_variant_they_were_trained_with(
        trained, served, monkeypatch, tmp_path, capsys):
    """One train step under ``trained``, the bundle and a float32 ``.uta``
    exported; served under ``served`` each gives the training build's eval
    maps and probabilities (float32: equal to 1e-6), and the loader names
    both variants in one line; a trainer of ``existing_model`` adopts the
    variant. The same weights in a build of ``served``'s variant serve
    other probabilities: what the recorded variant fixes."""
    from unet_tpu_torch.geo import read_raster
    from unet_tpu_torch.predict import predict as tp
    from unet_tpu_torch.predict.artifact import ArtifactPredictor, _read, export_artifact
    from unet_tpu_torch.train import loop

    tiles, scene = _tile_set(tmp_path)
    _set(monkeypatch, trained)
    t = loop.Trainer(loop.TrainerConfig(
        data_path=tiles, model_path=tmp_path / "models", description="b", codes=["a", "b", "c"],
        arch="xresnet18", batch_size=4, epochs=1, lr=1e-2, seed=0, bf16=False,
        loader_threads=2, device="cpu"))
    try:
        t.init_state()
        t.train_step(*next(iter(t.train_loader))[:2])
        bundle = t.export()
    finally:
        t.close()
    want_variant = tl.parse_bn_variant(trained)
    assert t.model.bn_variant == want_variant
    assert json.loads((bundle / "b.json").read_text())["bn_variant"] == want_variant
    kw = dict(patch_size=32, batch_size=4, device="cpu", dtype=torch.float32)
    reference = tp.Predictor(str(bundle), batch_size=4, device="cpu", dtype=torch.float32)
    reference.model = t.model.eval()
    reference.probs_fn = tp.make_probs_fn(reference.model, False)
    want_map = tp.predict_raster(str(bundle), str(scene), None, predictor=reference, **kw)[0]
    img = read_raster(scene).data
    x = np.stack([np.moveaxis(img[:, :32, c:c + 32], 0, -1) for c in (0, 32, 64)])
    want_probs = reference.predict_batch(x)

    _set(monkeypatch, served)
    capsys.readouterr()
    pred = tp.Predictor(str(bundle), batch_size=4, device="cpu", dtype=torch.float32)
    line = capsys.readouterr().out
    assert pred.model.bn_variant == want_variant
    assert f"({want_variant or 'unset'}), not UNET_TPU_BN={served or '(unset)'}" in line
    export_artifact(str(bundle), str(tmp_path / "b.uta"), platforms=["cpu"],
                    dtype=torch.float32, device="cpu")
    assert _read(tmp_path / "b.uta")[0]["bn_variant"] == want_variant
    art = ArtifactPredictor(str(tmp_path / "b.uta"), batch_size=4, device="cpu")
    for served_by in (pred, art):
        got = tp.predict_raster(str(bundle), str(scene), None, predictor=served_by, **kw)[0]
        np.testing.assert_array_equal(got, want_map)
        np.testing.assert_allclose(served_by.predict_batch(x), want_probs, rtol=0, atol=1e-6)
    t2 = loop.Trainer(loop.TrainerConfig(
        data_path=tiles, model_path=tmp_path / "models", description="again",
        codes=["a", "b", "c"], arch="xresnet18", batch_size=4, epochs=1,
        existing_model=str(bundle), loader_threads=2, device="cpu"))
    t2.close()
    assert t2.model.bn_variant == want_variant
    assert (f"existing_model: adopting bundle topology {{'bn_variant': {want_variant!r}}}"
            in capsys.readouterr().out)
    wrong = build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32,
                       bn_variant=served or None)
    wrong.load_state_dict(pred.model.state_dict())
    pred.model = wrong.eval()
    pred.probs_fn = tp.make_probs_fn(wrong, False)
    assert np.abs(pred.predict_batch(x) - want_probs).max() > 1e-2


@pytest.mark.parametrize("value", ["slice:x", "group:0", "bogus", "slice:"])
def test_unknown_variant_raises(value, monkeypatch):
    _set(monkeypatch, value)
    with pytest.raises(ValueError, match="UNET_TPU_BN"):
        tl.batch_norm(8)
    with pytest.raises(ValueError, match="UNET_TPU_BN"):
        build_unet("xresnet18", n_out=2)


WORLD, N_RANK = 2, 3  # two ranks of 3 samples: the global batch is 6
SLICE_KS = (2, 5)     # below and above a rank's share


def _slice_case(k):
    rng = np.random.default_rng(11 + k)
    x = rng.normal(0.5, 1.5, (WORLD * N_RANK, 8, 6, 6)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.2, 8).astype(np.float32)
    return x, r, scale, bias


def _slice_step(k, x, r, scale, bias, group=None):
    """A ``SliceBatchNorm`` step on ``x``: (y, running mean, running var,
    dx, dscale, dbias)."""
    bn = tl.SliceBatchNorm(x.shape[1], n_stat=k).train()
    bn.group = group
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(r)).sum().backward()
    return [t.detach().numpy().copy() for t in (y, bn.running_mean, bn.running_var, xt.grad,
                                                bn.weight.grad, bn.bias.grad)]


def _slice_rank(rank, port, out_dir):
    res = {}
    try:
        mesh.init_distributed(f"127.0.0.1:{port}", WORLD, rank, device="cpu")
        for k in SLICE_KS:
            x, r, scale, bias = _slice_case(k)
            share = slice(rank * N_RANK, (rank + 1) * N_RANK)
            res[k] = _slice_step(k, x[share], r[share], scale, bias, mesh.data_group())
    except Exception:
        res["error"] = traceback.format_exc()
    finally:
        mesh.close_distributed()
        torch.save(res, f"{out_dir}/rank{rank}.pt")


def test_slice_over_two_gloo_ranks_matches_one_process(tmp_path):
    """``slice:k`` over two gloo ranks of 3 samples each, k = 2 (inside
    rank 0's share) and 5 (across both): each rank's output and input
    gradient equal one process's on its share (at k = 2 rank 1 holds no
    sample of the slice: its forward sums are zeros and its dx the plain
    scale·inv·dy), the running statistics equal on both ranks, and the
    ranks' dscale and dbias summed equal one process's (within 1e-5:
    float32 sums in another order)."""
    ctx = mp.get_context("spawn")
    port = mesh.free_port()
    procs = [ctx.Process(target=_slice_rank, args=(r, port, str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    one = {k: _slice_step(k, *_slice_case(k)) for k in SLICE_KS}
    for p in procs:
        p.join(120)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    for res in ranks:
        assert "error" not in res, res.get("error")
    for k in SLICE_KS:
        y, rm, rv, dx, ds, db = one[k]
        for rank, res in enumerate(ranks):
            share = slice(rank * N_RANK, (rank + 1) * N_RANK)
            gy, grm, grv, gdx = res[k][:4]
            np.testing.assert_allclose(gy, y[share], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(gdx, dx[share], rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(grm, rm, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(grv, rv, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ranks[0][k][4] + ranks[1][k][4], ds, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(ranks[0][k][5] + ranks[1][k][5], db, rtol=1e-5, atol=1e-5)
