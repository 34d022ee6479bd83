"""PyTorch port on the card: the CUDA kernels against their plain versions.

Imports neither JAX nor ``unet_tpu``, so it also runs on a machine that has
only PyTorch with CUDA (and nvcc):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test here skips.
"""

import numpy as np
import pytest
import torch

from unet_tpu_torch.ops import blend

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed, n, h, w, c, th, tw, dev):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([[0, h - th], rng.integers(0, h - th + 1, n - 2)])
    cols = np.concatenate([[w - tw, 0], rng.integers(0, w - tw + 1, n - 2)])
    g = torch.Generator(device=dev).manual_seed(seed)
    tiles = torch.randn((n, c, th, tw), generator=g, device=dev)
    mosaic = torch.randn((c, h, w), generator=g, device=dev)
    return tiles, rows, cols, mosaic, torch.zeros((h, w), device=dev)


def _tiny_bundle(path, patch=64):
    from unet_tpu_torch.models import TPU_OPT_TOPOLOGY_VERSION, build_unet, init_weights
    from unet_tpu_torch.train.checkpoint import export_bundle, to_flax_variables

    model = init_weights(build_unet("xresnet18", n_out=3, c_in=3),
                         torch.Generator().manual_seed(0))
    export_bundle(path, path.name, to_flax_variables(model.state_dict()),
                  {"ARCHITECTURE": "xresnet18", "n_out": 3, "number_of_bands": 3,
                   "patch_size": patch, "enable_regression": False, "dtype_str": "uint8",
                   "normalize": "unit", "tpu_opt": True,
                   "tpu_opt_topology": TPU_OPT_TOPOLOGY_VERSION})
    return str(path)


@pytest.mark.parametrize("n,c", [(16, 3), (40, 2), (2, 1), (70, 4)])
def test_blend_count_bit_equal_to_plain(dev, n, c):
    """Up to and past 32 tiles (the kernel's mask width)."""
    tiles, rows, cols, m, cnt = _case(n, n, 300, 260, c, 64, 48, dev)
    mk, ck = m.clone(), cnt.clone()
    before = blend.blend_and_count.launches
    blend.blend_and_count(mk, ck, tiles, rows, cols)
    blend.blend_and_count_reference(m, cnt, tiles, rows, cols)
    torch.cuda.synchronize()
    assert blend.blend_and_count.launches == before + 1
    assert torch.equal(mk, m) and torch.equal(ck, cnt)


def test_blend_count_rejects_bad_input(dev):
    tiles, rows, cols, m, cnt = _case(0, 4, 100, 100, 3, 32, 32, dev)
    with pytest.raises(ValueError, match="float32"):
        blend.blend_and_count(m.double(), cnt, tiles, rows, cols)
    with pytest.raises(ValueError, match="contiguous"):
        blend.blend_and_count(m, cnt, tiles.transpose(2, 3), rows, cols)
    with pytest.raises(ValueError, match="out of range"):
        blend.blend_and_count(m, cnt, tiles, rows + 100, cols)


def test_device_mosaic_beyond_card_memory_is_not_yet_ported(dev):
    """A whole mosaic past the card's memory raises (the device merge needs
    it whole; serving takes the band)."""
    with pytest.raises(RuntimeError, match="merge on the host"):
        blend.DeviceMosaic(200_000, 200_000, 3, device=dev)


def test_device_mosaic_uses_kernel_on_cuda(dev):
    tiles, rows, cols, _, _ = _case(5, 8, 120, 140, 3, 32, 32, dev)
    on_card = blend.DeviceMosaic(120, 140, 3, device=dev)
    on_cpu = blend.DeviceMosaic(120, 140, 3, device="cpu")
    assert on_card.blend is blend.blend_and_count
    on_card.add_batch(tiles, rows, cols)
    on_cpu.add_batch(tiles.cpu(), rows, cols)
    for a, b in zip(on_card.finalize(), on_cpu.finalize()):
        np.testing.assert_array_equal(a, b)


def test_save_predictions_device_merge_equals_host_merge(dev, tmp_path):
    """``predict --merge``, on the card: the device merge launches
    blend_count once a batch and writes the host merge's mosaic bit for bit
    (both add the same float32 probabilities in tile order), in the default
    and the all_classes mode; the tiles include a partial last batch."""
    from unet_tpu_torch.geo import read_raster, write_raster
    from unet_tpu_torch.predict.predict import Predictor, save_predictions
    from unet_tpu_torch.tiling import split_raster

    _tiny_bundle(tmp_path / "m")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 150, 182)).astype(np.uint8)
    t = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
    write_raster(tmp_path / "scene.tif", img, transform=t, crs="EPSG:25832")
    n = split_raster(str(tmp_path / "scene.tif"), None, str(tmp_path / "pred"),
                     patch_size=64, patch_overlap=0.2, max_empty=1.0)
    pred = Predictor(str(tmp_path / "m"), batch_size=5, device=dev)
    tiles = str(tmp_path / "pred" / "img_tiles")
    for kw in ({}, {"all_classes": True}):
        host = save_predictions(str(tmp_path / "m"), tiles, merge=True, AOI="host",
                                predictor=pred, **kw)
        before = blend.blend_and_count.launches
        on_card = save_predictions(str(tmp_path / "m"), tiles, merge=True, AOI="card",
                                   device_merge=True, predictor=pred, **kw)
        assert blend.blend_and_count.launches - before == -(-n // 5)
        a, b = read_raster(on_card), read_raster(host)
        np.testing.assert_array_equal(a.data, b.data)
        assert tuple(a.transform) == t and a.crs == b.crs


def test_band_equals_full_mosaic_through_blend_count(dev):
    """The banded serve's batches over a 300 × 500 scene at 64² windows
    and batch 7 (10 windows a window row, so most batches wrap rows): a
    DeviceBand and a whole DeviceMosaic, both through the kernel, give the
    same finalized output bit for bit in every mode, and the band's sums
    equal the plain version's after every batch."""
    from unet_tpu_torch.predict.predict import band_plan
    from unet_tpu_torch.tiling.windows import generate_windows

    h, w, c = 300, 500, 3
    batches, rows = band_plan(generate_windows(h, w, 64, 0.2), 7)
    assert sum(b[0].y != b[-1].y for b in batches) > len(batches) // 2
    g = torch.Generator(device=dev).manual_seed(3)
    probs = [torch.rand((len(b), c, 64, 64), generator=g, device=dev) for b in batches]
    for mode in ({}, {"all_classes": True}, {"specific_class": 2}, {"regression": True}):
        band = blend.DeviceBand(rows, w, c, device=dev)
        plain = blend.DeviceBand(rows, w, c, device=dev,
                                 blend=blend.blend_and_count_reference)
        full = blend.DeviceMosaic(h, w, c, device=dev)
        before = blend.blend_and_count.launches
        parts = []
        for k, (b, p) in enumerate(zip(batches, probs)):
            ys, xs = [win.y for win in b], [win.x for win in b]
            for m in (band, plain, full):
                m.add_batch(p, ys, xs)
            assert torch.equal(band.sum, plain.sum) and torch.equal(band.count, plain.count)
            upto = batches[k + 1][0].y if k + 1 < len(batches) else h
            if upto > band.top:
                parts.append(band.finalize_rows(upto, **mode)[0])
                plain.finalize_rows(upto, **mode)
        assert blend.blend_and_count.launches - before == 2 * len(batches)
        want, _ = full.finish(**mode)
        assert torch.equal(torch.cat(parts, dim=-2), want)


@pytest.mark.parametrize("mode", [{}, {"all_classes": True}, {"specific_class": 1},
                                  {"regression": True}])
def test_finalize_on_the_card_equals_numpy(dev, mode):
    """finalize_mosaic_torch on the card against the host finalize_mosaic on
    the same sums, bit for bit, with zero counts and exact ties."""
    from unet_tpu_torch.predict.merge import finalize_mosaic, finalize_mosaic_torch

    rng = np.random.default_rng(4)
    counter = rng.integers(0, 5, (300, 257)).astype(np.float32)
    summed = (rng.uniform(size=(3, 300, 257)) * counter).astype(np.float32)
    summed[1, :7] = summed[0, :7]
    summed[:, counter == 0] = 0
    want, want_nodata = finalize_mosaic(summed, counter, **mode)
    got, nodata = finalize_mosaic_torch(torch.from_numpy(summed).to(dev),
                                        torch.from_numpy(counter).to(dev), **mode)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert nodata == want_nodata


def test_streamed_equals_banded_in_bf16(dev, tmp_path):
    """predict_raster_streamed and predict_raster's banded tier share the
    banded core, so their bf16 class maps are equal bit for bit; both
    launch blend_count once for each window row of each batch."""
    from unet_tpu_torch.geo import read_raster, write_raster
    from unet_tpu_torch.predict.predict import (Predictor, predict_raster,
                                                predict_raster_streamed)

    bundle = _tiny_bundle(tmp_path / "m")
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (3, 333, 517)).astype(np.uint8)
    t = (500000.0, 0.2, 0.0, 5400000.0, 0.0, -0.2)
    write_raster(tmp_path / "scene.tif", img, transform=t, crs="EPSG:25832")
    pred = Predictor(bundle, batch_size=6, device=dev)
    launches = []
    before = blend.blend_and_count.launches
    banded, _, _ = predict_raster(bundle, str(tmp_path / "scene.tif"), predictor=pred,
                                  device_budget_bytes=0, device=dev)
    launches.append(blend.blend_and_count.launches - before)
    before = blend.blend_and_count.launches
    predict_raster_streamed(bundle, str(tmp_path / "scene.tif"), str(tmp_path / "s.tif"),
                            predictor=pred, device=dev)
    launches.append(blend.blend_and_count.launches - before)
    assert [s["tier"] for s in pred.scenes] == ["banded", "streamed"]
    rec = pred.scenes[0]
    assert rec["adds"] == rec["batches"] + rec["wrapping_batches"] > rec["batches"]
    assert launches == [rec["adds"]] * 2
    back = read_raster(tmp_path / "s.tif")
    np.testing.assert_array_equal(back.data[0], banded)
    assert tuple(back.transform) == t


# --- the training kernels: bn_stats (forward and backward) and flip_scale ---

# (N, C, H, W): the training BatchNorm shapes of the xresnet34 U-Net at
# batch 16 × 512² (tpu_opt, then the parity stem's (32, 256²)), then ragged
# ones (C = 3 and 1, odd N·H·W, H·W not a multiple of the 16-byte load)
BN_SHAPES = [(16, 64, 128, 128), (16, 64, 256, 256), (16, 128, 64, 64),
             (16, 128, 128, 128), (16, 256, 32, 32), (16, 256, 128, 128),
             (16, 512, 16, 16), (16, 32, 256, 256), (3, 3, 37, 41), (5, 1, 17, 13),
             (2, 7, 3, 5)]


def _bn_inputs(shape, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, generator=g, device=dev).to(dtype)
    return x, dy


@pytest.mark.parametrize("shape", BN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_stats_kernels_match_float64_and_are_bit_stable(dev, shape, dtype):
    """Within 1e-6 of the float64 sums relative to Σ|x|, Σx², Σ|dy| and
    Σ|dy·x̂|; two launches bit-identical; one launch counted per call."""
    from unet_tpu_torch.ops import bn

    x, dy = _bn_inputs(shape, dtype, dev)
    before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
    s1, s2 = bn.bn_sum_sumsq(x), bn.bn_sum_sumsq(x)
    n = x.numel() // shape[1]
    mean = s1[0] / n
    inv = torch.rsqrt(torch.clamp(s1[1] / n - mean * mean, min=0) + 1e-5)
    b1, b2 = bn.bn_bwd_sums(dy, x, mean, inv), bn.bn_bwd_sums(dy, x, mean, inv)
    torch.cuda.synchronize()
    assert (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(s1, s2) and torch.equal(b1, b2)
    dims = (0, 2, 3)
    x64, dy64 = x.double(), dy.double()
    xhat = (x64 - mean.double().view(1, -1, 1, 1)) * inv.double().view(1, -1, 1, 1)
    for got, want, scale in ((s1[0], x64.sum(dims), x64.abs().sum(dims)),
                             (s1[1], (x64 * x64).sum(dims), (x64 * x64).sum(dims)),
                             (b1[0], dy64.sum(dims), dy64.abs().sum(dims)),
                             (b1[1], (dy64 * xhat).sum(dims), (dy64 * xhat).abs().sum(dims))):
        assert bool(((got.double() - want).abs() <= 1e-6 * scale).all())


def test_bn_stats_rejects_bad_input(dev):
    from unet_tpu_torch.ops import bn

    x, dy = _bn_inputs((2, 4, 8, 8), torch.float32, dev)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bn.bn_sum_sumsq(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        bn.bn_sum_sumsq(x.transpose(2, 3))
    mean, inv = torch.zeros(4, device=dev), torch.ones(4, device=dev)
    with pytest.raises(ValueError, match="dy"):
        bn.bn_bwd_sums(dy.bfloat16(), x, mean, inv)
    with pytest.raises(ValueError, match="mean"):
        bn.bn_bwd_sums(dy, x, mean.double(), inv)


def test_train_batch_norm_on_cuda_runs_the_kernels(dev):
    """The module's forward and backward launch one kernel each and agree
    with the plain reductions (float32: rtol 1e-5)."""
    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.ops import bn

    x, dy = _bn_inputs((4, 16, 20, 24), torch.float32, dev, seed=1)
    out = {}
    for name, red in (("kernel", bn.KERNEL_REDUCTIONS), ("plain", bn.PLAIN_REDUCTIONS)):
        m = BatchNorm(16).to(dev).train()
        m.reductions = red
        xi = x.clone().requires_grad_(True)
        before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
        y = m(xi)
        (y * dy).sum().backward()
        launched = (bn.bn_sum_sumsq.launches - before[0], bn.bn_bwd_sums.launches - before[1])
        out[name] = (y, xi.grad, m.weight.grad, m.bias.grad, m.running_var, launched)
    assert out["kernel"][-1] == (1, 1) and out["plain"][-1] == (0, 0)
    for a, b in zip(out["kernel"][:-1], out["plain"][:-1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_parity_sa_train_step_kernels_against_plain(dev):
    """One float32 train step (TF32 off) of the xresnet18 parity +
    self-attention U-Net at batch 4 × 64², 3 classes: every BatchNorm
    through the bn_stats kernels (one forward and one backward launch
    each), against the same step with their plain versions from the same
    state and batch, so the two differ only in the order of the BatchNorm
    sums. Loss within 1e-4 relative; each gradient within 5e-2 relative L2
    of the plain one, relative to at least 1e-2 of the RMS of all gradients
    (the chip_smoke.py bar: the deepest BatchNorms see 16 values a channel
    here, and a bf16 step at this size exceeds it in a 64-value BatchNorm
    scale); the u vectors updated alike."""
    from unet_tpu_torch.models import build_unet, init_weights
    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.ops import bn
    from unet_tpu_torch.train.losses import cross_entropy

    model = build_unet("xresnet18", n_out=3, c_in=3, self_attention=True, tpu_opt=False,
                       dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.up_1.sa.gamma.fill_(0.5)
    model.to(dev).train()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.rand((4, 3, 64, 64), generator=g, device=dev)
    y = torch.randint(0, 3, (4, 64, 64), generator=g, device=dev)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, red in (("kernel", bn.KERNEL_REDUCTIONS), ("plain", bn.PLAIN_REDUCTIONS)):
            model.load_state_dict(state)
            for m in bns:
                m.reductions = red
            for p in model.parameters():
                p.grad = None
            before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
            logits = model(x, fold_logits=True)
            loss = cross_entropy(logits, y)
            loss.backward()
            torch.cuda.synchronize()
            launched = (bn.bn_sum_sumsq.launches - before[0], bn.bn_bwd_sums.launches - before[1])
            out[name] = (loss.item(), [p.grad.float().clone() for p in model.parameters()],
                         model.up_1.sa.value_u.clone(), launched, logits.shape)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out["kernel"][3] == (len(bns), len(bns)) and out["plain"][3] == (0, 0)
    assert out["kernel"][4] == (4, 3, 64, 64)
    assert abs(out["kernel"][0] - out["plain"][0]) <= 1e-4 * abs(out["plain"][0])
    gk, gp = out["kernel"][1], out["plain"][1]
    g_rms = (sum(float(a.pow(2).sum()) for a in gp) / sum(a.numel() for a in gp)) ** 0.5
    for a, b in zip(gk, gp):
        rms = float(b.norm()) / b.numel() ** 0.5
        assert float((a - b).norm()) / b.numel() ** 0.5 <= 5e-2 * max(rms, 1e-2 * g_rms)
    torch.testing.assert_close(out["kernel"][2], out["plain"][2], rtol=1e-5, atol=1e-6)


AUG_FULL = dict(rot90_p=0.5, brightness_contrast_p=0.5, saturation_p=0.5,
                coarse_dropout_p=0.5)


@pytest.mark.parametrize("img_dtype,dtype_str,quirks,frac", [
    (torch.uint8, "int8", False, 1.0), (torch.int16, "int16", True, 0.5),
    (torch.uint16, "int16", False, 1.0), (torch.float32, "int8", False, 0.75)])
@pytest.mark.parametrize("mask_dtype", [torch.uint8, torch.float32])
def test_full_augmentation_kernel_path_equals_plain(dev, img_dtype, dtype_str, quirks, frac,
                                                    mask_dtype):
    """Every AugmentConfig op at p = 0.5 on 8 × 3 × 64² tiles (float32
    masks: a regression target through the kernel as its int32 bits): the
    draws through flip_scale bit-equal to the same draws through its
    plain version, one launch a batch."""
    from unet_tpu_torch.data import augment as A
    from unet_tpu_torch.ops import aug

    g = torch.Generator(device=dev).manual_seed(3)
    hi = {torch.uint8: 256, torch.int16: 30000, torch.uint16: 65536}.get(img_dtype)
    x = (torch.rand((8, 3, 64, 64), generator=g, device=dev) * 300 if hi is None else
         torch.randint(0, hi, (8, 3, 64, 64), generator=g, device=dev).to(img_dtype))
    m = (torch.rand((8, 64, 64), generator=g, device=dev) if mask_dtype == torch.float32
         else torch.randint(0, 3, (8, 64, 64), generator=g, device=dev).to(mask_dtype))
    cfg = A.AugmentConfig(**AUG_FULL)
    n_aug = A.n_augmented(8, frac, quirks)
    draws = A.draw_augment(8, 64, 64, cfg, n_aug, torch.Generator().manual_seed(4))
    scales = A.sample_scales(8, n_aug, dtype_str, "reference", quirks)
    before = aug.fused_flip_scale.launches
    xk, mk = A.apply_augment(x, m, draws, scales, cfg, A.value_max(dtype_str))
    assert aug.fused_flip_scale.launches == before + 1
    xp, mp = A.apply_augment(x, m, draws, scales, cfg, A.value_max(dtype_str),
                             aug.fused_flip_scale_reference)
    torch.cuda.synchronize()
    assert xk.dtype == torch.float32 and mk.dtype == mask_dtype
    assert torch.equal(xk, xp) and torch.equal(mk, mp)


def _tile_tree(root, n_train=8, n_valid=4, tile=64, regression=False):
    from unet_tpu_torch.geo import write_raster

    rng = np.random.default_rng(0)
    for scene, n in (("trai", n_train), ("vali", n_valid)):
        for sub in ("img_tiles", "mask_tiles"):
            (root / scene / sub).mkdir(parents=True)
        for i in range(n):
            img = np.kron(rng.integers(0, 256, (3, tile // 8, tile // 8)),
                          np.ones((8, 8), np.int64)).astype(np.uint8)
            mask = (img.mean(0, dtype=np.float32)[None] / 255 if regression
                    else (img[:1] > 128).astype(np.uint8))
            for sub, a in (("img_tiles", img), ("mask_tiles", mask)):
                write_raster(root / scene / sub / f"{i}.tif", a,
                             transform=(0.0, 1.0, 0.0, 0.0, 0.0, -1.0), crs="EPSG:25832")
    return root


@pytest.mark.parametrize("grad_accum", [1, 2, 4])
@pytest.mark.parametrize("regression", [False, True])
def test_grad_accum_step_kernels_against_plain(dev, tmp_path, grad_accum, regression):
    """A float32 train step (TF32 off) of the xresnet18 tpu_opt U-Net at
    8 × 64² with every augmentation op, split into ``grad_accum``
    microbatches: each BatchNorm launches each bn_stats kernel once a
    microbatch and flip_scale runs once a step; against the same step with
    the plain versions from the same state, batch and draws: loss within
    1e-4 relative, each gradient within 5e-2 relative L2 (floor 1e-2 of
    the RMS), as the parity step test."""
    from unet_tpu_torch.data import AugmentConfig
    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.ops import aug, bn
    from unet_tpu_torch.train.loop import Trainer, TrainerConfig

    t = Trainer(TrainerConfig(data_path=_tile_tree(tmp_path, regression=regression),
                              codes=("a", "b"), arch="xresnet18", batch_size=8, bf16=False,
                              grad_accum=grad_accum, regression=regression,
                              aug=AugmentConfig(**AUG_FULL), loader_threads=2))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t.init_state()
        state = {k: v.clone() for k, v in t.model.state_dict().items()}
        images, masks, _ = next(iter(t.train_loader))
        bns = [m for m in t.model.modules() if isinstance(m, BatchNorm)]
        out = {}
        for name, red, fs in (("kernel", bn.KERNEL_REDUCTIONS, aug.fused_flip_scale),
                              ("plain", bn.PLAIN_REDUCTIONS, aug.fused_flip_scale_reference)):
            t.model.load_state_dict(state)
            for m in bns:
                m.reductions = red
            before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches,
                      aug.fused_flip_scale.launches)
            x, y = t.augment(*t.to_device(images, masks), "train",
                             torch.Generator().manual_seed(6), flip_scale=fs)
            loss = t.loss_and_grads(x, y).item()
            torch.cuda.synchronize()
            launched = tuple(a.launches - b for a, b in zip(
                (bn.bn_sum_sumsq, bn.bn_bwd_sums, aug.fused_flip_scale), before))
            out[name] = (loss, [p.grad.clone() for p in t.model.parameters()], launched,
                         t.model.state_dict()["mid_bn.running_var"].clone())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        t.close()
    n = len(bns) * grad_accum
    assert out["kernel"][2] == (n, n, 1) and out["plain"][2] == (0, 0, 0), (out["kernel"][2], out["plain"][2], n)
    assert abs(out["kernel"][0] - out["plain"][0]) <= 1e-4 * abs(out["plain"][0])
    gk, gp = out["kernel"][1], out["plain"][1]
    g_rms = (sum(float(a.pow(2).sum()) for a in gp) / sum(a.numel() for a in gp)) ** 0.5
    for a, b in zip(gk, gp):
        rms = float(b.norm()) / b.numel() ** 0.5
        assert float((a - b).norm()) / b.numel() ** 0.5 <= 5e-2 * max(rms, 1e-2 * g_rms)
    torch.testing.assert_close(out["kernel"][3], out["plain"][3], rtol=1e-5, atol=1e-6)


FLIP_IMAGE_DTYPES = [torch.uint8, torch.uint16, torch.int16, torch.float32]
FLIP_MASK_DTYPES = [None, torch.uint8, torch.int8, torch.int16, torch.uint16, torch.int32,
                    torch.uint32, torch.int64]
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _flip_case(dev, img_dtype, mask_dtype, b, h, w, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    if img_dtype == torch.float32:
        img = torch.randn((b, 3, h, w), generator=g, device=dev) * 100
    else:
        hi = 256 if img_dtype == torch.uint8 else 30000
        img = torch.randint(0, hi, (b, 3, h, w), generator=g, device=dev).to(img_dtype)
    msk = None if mask_dtype is None else \
        torch.randint(0, 5, (b, h, w), generator=g, device=dev).to(mask_dtype)
    hf = torch.arange(b) % 2 == 1
    vf = torch.arange(b) % 3 == 1
    return img, msk, hf, vf, torch.linspace(0.001, 2.0, b)


def _bits_equal(a, b):
    """Bit-equality, through a signed view where PyTorch lacks the dtype's ops."""
    return a.dtype == b.dtype and torch.equal(a.view(_SIGNED.get(a.dtype, a.dtype)),
                                              b.view(_SIGNED.get(b.dtype, b.dtype)))


def _flip_check(args, launches=1):
    from unet_tpu_torch.ops import aug

    before = aug.fused_flip_scale.launches
    ki, km = aug.fused_flip_scale(*args)
    pi, pm = aug.fused_flip_scale_reference(*args)
    torch.cuda.synchronize()
    assert aug.fused_flip_scale.launches == before + launches
    assert ki.dtype == torch.float32 and torch.equal(ki, pi)
    assert (km is None and pm is None) or _bits_equal(km, pm)


def _device_op_names(fn, tries=3):
    """Names of the device operations (kernels, copies, sets) of one
    ``fn()`` call, by torch.profiler after a warm call; a trace that comes
    back empty (CUPTI now and then delivers none) is taken again."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return names


# word-path widths (W % 4 == 0; 300 ends in a partial chunk), then the
# element path's
@pytest.mark.parametrize("w", [512, 128, 64, 4, 300, 301, 17, 1])
@pytest.mark.parametrize("img_dtype", FLIP_IMAGE_DTYPES)
@pytest.mark.parametrize("mask_dtype", FLIP_MASK_DTYPES)
def test_flip_scale_bit_equal_to_plain(dev, img_dtype, mask_dtype, w):
    _flip_check(_flip_case(dev, img_dtype, mask_dtype, 8, 37, w))


@pytest.mark.parametrize("img_dtype", FLIP_IMAGE_DTYPES)
def test_flip_scale_unaligned_views_take_the_element_path(dev, img_dtype):
    """Images and masks whose data_ptr() is not 16-byte aligned, at a width
    the word path would take."""
    img, msk, hf, vf, s = _flip_case(dev, img_dtype, torch.uint8, 4, 9, 64)
    img_u = torch.empty(img.numel() + 1, dtype=img.dtype, device=dev)[1:].view(img.shape)
    msk_u = torch.empty(msk.numel() + 3, dtype=msk.dtype, device=dev)[3:].view(msk.shape)
    img_u.copy_(img)
    msk_u.copy_(msk)
    assert img_u.data_ptr() % 16 and msk_u.data_ptr() % 16
    _flip_check((img_u, msk, hf, vf, s))
    _flip_check((img, msk_u, hf, vf, s))


def test_flip_scale_over_max_batch_takes_one_launch_per_chunk(dev):
    from unet_tpu_torch.ops import aug

    b = aug.MAX_B + 88
    img, msk, _, _, _ = _flip_case(dev, torch.uint8, torch.uint8, b, 6, 12)
    rng = np.random.default_rng(0)
    hf, vf = torch.from_numpy(rng.random(b) < 0.5), torch.from_numpy(rng.random(b) < 0.5)
    _flip_check((img, msk, hf, vf, torch.from_numpy(rng.uniform(0.1, 2, b).astype(np.float32))),
                launches=2)


def test_flip_scale_flags_and_scales_on_the_card(dev):
    img, msk, hf, vf, s = _flip_case(dev, torch.uint16, torch.int64, 6, 20, 40)
    _flip_check((img, msk, hf.to(dev), vf.to(dev), s.to(dev)))


@pytest.mark.parametrize("w,unaligned,group", [(512, False, 4), (300, False, 4), (301, False, 1),
                                               (512, True, 1)])
def test_flip_scale_call_is_one_kernel_on_its_path(dev, w, unaligned, group):
    """Host flags and scales: one device operation a call (no copy), the
    word-path kernel where W % 4 == 0 and the pointers are aligned."""
    from unet_tpu_torch.ops import aug

    img, msk, hf, vf, s = _flip_case(dev, torch.uint8, torch.uint8, 16, 8, w)
    if unaligned:
        img = torch.empty(img.numel() + 1, dtype=img.dtype, device=dev)[1:].view(img.shape)
    names = _device_op_names(lambda: aug.fused_flip_scale(img, msk, hf, vf, s))
    assert len(names) == 1 and "flip_scale_kernel<" in names[0], names
    assert f", {group}>" in names[0], names


def test_flip_scale_rejects_bad_input(dev):
    from unet_tpu_torch.ops import aug

    img = torch.zeros((2, 3, 8, 8), dtype=torch.uint8, device=dev)
    f, s = torch.zeros(2, dtype=torch.bool), torch.ones(2)
    with pytest.raises(ValueError, match="uint8/uint16/int16/float32"):
        aug.fused_flip_scale(img.half(), None, f, f, s)
    with pytest.raises(ValueError, match="masks"):
        aug.fused_flip_scale(img, torch.zeros((2, 8, 9), dtype=torch.uint8, device=dev),
                             f, f, s)
    with pytest.raises(ValueError, match="contiguous"):
        aug.fused_flip_scale(img.transpose(2, 3), None, f, f, s)


# --- offset_copy and the capability check ---


@pytest.mark.parametrize("rows", [16, 64])
def test_offset_copy_bit_equal_to_plain_at_every_offset(dev, rows):
    from unet_tpu_torch.ops import probe

    src = torch.randn((rows, 128), generator=torch.Generator(device=dev).manual_seed(rows),
                      device=dev)
    before = probe.offset_copy.launches
    for o in range(rows // 8):
        off = torch.tensor([o], dtype=torch.int32, device=dev)
        got = probe.offset_copy(src, off)
        torch.cuda.synchronize()
        assert torch.equal(got, probe.offset_copy_reference(src, off))
    assert probe.offset_copy.launches == before + rows // 8


def test_offset_copy_rejects_bad_input(dev):
    from unet_tpu_torch.ops import probe

    src = torch.zeros((16, 128), device=dev)
    for o in (-1, 2, 1000):
        with pytest.raises(ValueError, match="out of range"):
            probe.offset_copy(src, torch.tensor([o], dtype=torch.int32, device=dev))
    off = torch.tensor([0], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        probe.offset_copy(src, off.long())
    with pytest.raises(ValueError, match="float32"):
        probe.offset_copy(src.double(), off)
    with pytest.raises(ValueError, match="aligned"):
        probe.offset_copy(torch.zeros(17 * 128 + 1, device=dev)[1:].view(17, 128), off)


def test_offset_copy_1000_calls_in_a_row_bit_equal(dev):
    from unet_tpu_torch.ops import probe

    src = torch.randn((64, 128), generator=torch.Generator(device=dev).manual_seed(7),
                      device=dev)
    offs = [torch.tensor([o], dtype=torch.int32, device=dev) for o in range(8)]
    before = probe.offset_copy.launches
    got = [probe.offset_copy(src, offs[i % 8]) for i in range(1000)]
    torch.cuda.synchronize()
    assert probe.offset_copy.launches == before + 1000
    for i, g in enumerate(got):
        assert torch.equal(g, src[8 * (i % 8):8 * (i % 8) + 8]), i


def test_offset_copy_bad_offset_then_good_call(dev):
    from unet_tpu_torch.ops import probe

    src = torch.arange(16 * 128, dtype=torch.float32, device=dev).view(16, 128)
    with pytest.raises(ValueError, match="out of range"):
        probe.offset_copy(src, torch.tensor([5], dtype=torch.int32, device=dev))
    got = probe.offset_copy(src, torch.tensor([1], dtype=torch.int32, device=dev))
    assert torch.equal(got, src[8:16])


def test_offset_copy_failed_launch_raises(dev, monkeypatch):
    """A launcher that reports a CUDA error: RuntimeError, not a result."""
    from unet_tpu_torch.ops import probe

    probe._kernel("copy")
    monkeypatch.setitem(probe._kernels, "copy", lambda *args: 700)
    src = torch.zeros((16, 128), device=dev)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        probe.offset_copy(src, torch.tensor([0], dtype=torch.int32, device=dev))


def test_offset_copy_call_is_one_kernel(dev):
    """The status comes back through pinned host memory: no copy."""
    from unet_tpu_torch.ops import probe

    src = torch.zeros((16, 128), device=dev)
    off = torch.tensor([1], dtype=torch.int32, device=dev)
    names = _device_op_names(lambda: probe.offset_copy(src, off))
    assert len(names) == 1 and "offset_copy_kernel" in names[0], names


def test_capability_check_all_ok(dev):
    from unet_tpu_torch.ops import probe

    results = probe.capability_check()
    assert set(results) == set(probe.CHECKS)
    assert all(ok for ok, _ in results.values()), results


def _sync_bn_rank(rank, port, x, dy, out):
    """One of two gloo ranks on the card: a training BatchNorm over its half
    of ``x`` with the group set, through the kernels and through the plain
    reductions; the gradients of scale and bias summed over the ranks."""
    import torch.distributed as dist

    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.ops import bn
    from unet_tpu_torch.parallel import mesh

    res = {}
    try:
        mesh.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda")
        dev = torch.device("cuda")
        half = x.shape[0] // 2
        xs, dys = x[rank * half:(rank + 1) * half].to(dev), dy[rank * half:(rank + 1) * half].to(dev)
        for name, red in (("kernel", bn.KERNEL_REDUCTIONS), ("plain", bn.PLAIN_REDUCTIONS)):
            m = BatchNorm(x.shape[1]).to(dev).train()
            m.reductions, m.group = red, mesh.data_group()
            xi = xs.clone().requires_grad_(True)
            before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
            y = m(xi)
            (y.float() * dys).sum().backward()
            launched = (bn.bn_sum_sumsq.launches - before[0], bn.bn_bwd_sums.launches - before[1])
            g = torch.stack([m.weight.grad, m.bias.grad])
            dist.all_reduce(g)
            res[name] = [t.detach().float().cpu() for t in (y, xi.grad, g, m.running_mean,
                                                              m.running_var)] + [launched]
    except BaseException:
        import traceback

        res["error"] = traceback.format_exc()
    finally:
        mesh.close_distributed()
        torch.save(res, out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_synchronized_batch_norm_kernels_against_plain_over_two_ranks(dev, dtype, tmp_path):
    """Two gloo ranks on one card, each with half of a (16, 64, 32, 32)
    batch: forward and backward launch one kernel each a rank; the kernel
    path equals the plain one within the module test's bars (float32 rtol
    1e-5; bf16 outputs within one bf16 rounding, 1e-2) for the outputs and
    dx, and within 1e-4 for the summed scale and bias gradients and the
    running statistics (sums over 16384 values a channel, in another
    order: 3.8e-5 apart on the card), and both equal one process's plain
    BatchNorm on the whole batch."""
    import multiprocessing as mp

    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.parallel import mesh

    x, dy = _bn_inputs((16, 64, 32, 32), dtype, torch.device("cpu"), seed=3)
    dy = dy.float()
    port = mesh.free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_sync_bn_rank, args=(r, port, x, dy, tmp_path / f"r{r}.pt"))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert not any(p.is_alive() for p in procs)
    ranks = [torch.load(tmp_path / f"r{r}.pt", weights_only=False) for r in range(2)]
    assert all("error" not in r for r in ranks), [r.get("error") for r in ranks]
    m = BatchNorm(64).to(dev).train()
    xi = x.to(dev).clone().requires_grad_(True)
    y = m(xi)
    (y.float() * dy.to(dev)).sum().backward()
    whole = [t.detach().float().cpu() for t in (y, xi.grad, torch.stack([m.weight.grad,
                                                                         m.bias.grad]),
                                                m.running_mean, m.running_var)]
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    for r, res in enumerate(ranks):
        assert res["kernel"][-1] == (1, 1) and res["plain"][-1] == (0, 0)
        for a, b in zip(res["kernel"][:2], res["plain"][:2]):
            torch.testing.assert_close(a, b, **tol)
        for a, b in zip(res["kernel"][2:-1], res["plain"][2:-1]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        for a, b in zip(res["kernel"][:2], whole[:2]):
            torch.testing.assert_close(a, b[r * 8:(r + 1) * 8], **tol)
        for a, b in zip(res["kernel"][2:-1], whole[2:]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_artifact_serves_on_the_card_like_the_bundle(dev, tmp_path):
    """A float32 ``.uta`` of a tiny bundle, exported on the CPU and served
    on the card (the program moved there), against the live float32
    bundle on the card with TF32 off: probabilities within 1e-6 and class
    maps equal, batches of 1, 3 and 5; blend_count launched by
    ``predict_raster`` through the artifact once a batch."""
    from unet_tpu_torch.predict import predict as pp
    from unet_tpu_torch.predict.artifact import export_artifact, load_artifact

    bundle = _tiny_bundle(tmp_path / "m")
    uta = export_artifact(bundle, str(tmp_path / "m.uta"), dtype=torch.float32, device="cpu")
    art = load_artifact(str(uta), batch_size=4, device=dev)
    live = pp.Predictor(bundle, batch_size=4, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for n in (1, 3, 5):
            x = rng.integers(0, 256, (n, 64, 64, 3)).astype(np.uint8)
            np.testing.assert_allclose(art.predict_batch(x), live.predict_batch(x),
                                       rtol=0, atol=1e-6)
            assert torch.equal(art.predict_batch_device(x, argmax_u8=True),
                               live.predict_batch_device(x, argmax_u8=True))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    from unet_tpu_torch.geo import write_raster

    write_raster(tmp_path / "s.tif", rng.integers(0, 256, (3, 96, 128)).astype(np.uint8),
                 transform=(0.0, 1.0, 0.0, 0.0, 0.0, -1.0), crs="EPSG:25832")
    before = blend.blend_and_count.launches
    out, _, _ = pp.predict_raster(None, str(tmp_path / "s.tif"), patch_size=64,
                                  predictor=art, device=dev)
    assert out.shape == (96, 128)
    assert blend.blend_and_count.launches - before == art.scenes[-1]["adds"] > 0


def test_planar_batch_crosses_pinned_and_serves_as_a_contiguous_one(dev, tmp_path):
    """A batch gathered from a CHW scene is staged in pinned memory in its
    planar order (a ``host_batch`` block crosses as it is) and reaches
    ``_forward`` bit-equal to the contiguous batch of the pre-staging path,
    with the same class maps; a served 1024² scene writes the map that
    batches made contiguous on the host write, every batch interleaved on
    the card."""
    from unet_tpu_torch.geo import write_raster
    from unet_tpu_torch.predict import predict as pp

    pred = pp.Predictor(_tiny_bundle(tmp_path / "m", patch=128), batch_size=8, device=dev)
    rng = np.random.default_rng(0)
    hwc = np.moveaxis(rng.integers(0, 256, (3, 400, 440)).astype(np.uint8), 0, 2)
    windows = [hwc[31 * k:31 * k + 128, 37 * k:37 * k + 128] for k in range(8)]
    batch = np.stack(windows)
    planar = (3 * 128 * 128, 128, 1, 128 * 128)
    staged = pp.stage_batch(batch, dev)
    assert staged.is_pinned() and staged.stride() == planar
    assert staged.data_ptr() != batch.ctypes.data
    block = pp.host_batch(windows, 8, dev)
    assert torch.from_numpy(block).is_pinned()
    assert pp.stage_batch(block, dev).data_ptr() == block.ctypes.data
    rows = pp.host_batch([np.ascontiguousarray(w) for w in windows], 8, dev)
    assert rows.flags.c_contiguous and torch.from_numpy(rows).is_pinned()
    assert pp.stage_batch(rows, dev).data_ptr() == rows.ctypes.data
    seen = []
    real = pred._forward

    def capture(x):
        seen.append(x.clone())
        return real(x)

    pred._forward = capture
    maps = [pred.predict_batch_device(b, argmax_u8=True)
            for b in (batch, block, np.ascontiguousarray(batch))]
    assert pred.planar_batches == 2
    want = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
    for x, m in zip(seen, maps):
        assert x.device.type == "cuda" and x.is_contiguous() and torch.equal(x, want)
        assert torch.equal(m, maps[-1])
    del pred._forward

    write_raster(tmp_path / "s.tif", rng.integers(0, 256, (3, 1024, 1024)).astype(np.uint8),
                 transform=(0.0, 1.0, 0.0, 0.0, 0.0, -1.0), crs="EPSG:25832")
    out, _, _ = pp.predict_raster(None, str(tmp_path / "s.tif"), patch_size=128,
                                  predictor=pred, device=dev)
    staged_call = pred.predict_batch_device
    pred.predict_batch_device = lambda images, **kw: staged_call(np.ascontiguousarray(images),
                                                                 **kw)
    before, _, _ = pp.predict_raster(None, str(tmp_path / "s.tif"), patch_size=128,
                                     predictor=pred, device=dev)
    np.testing.assert_array_equal(out, before)
    first, second = pred.scenes
    assert first["planar_batches"] == first["batches"] > 1 and first["windows"] % 8
    assert second["planar_batches"] == 0


def test_a_host_batch_block_is_not_handed_out_while_its_copy_is_pending(dev):
    """A ``host_batch`` block freed while its H2D copy still waits behind
    device work is not handed out again before the copy has read it: the
    caching host allocator records the copy's event on the block, so
    blocks gathered meanwhile do not overwrite the batch on its way."""
    from unet_tpu_torch.predict import predict as pp

    rng = np.random.default_rng(3)
    hwc = np.moveaxis(rng.integers(0, 256, (3, 300, 300)).astype(np.uint8), 0, 2)
    wins = [hwc[9 * k:9 * k + 128, 13 * k:13 * k + 128] for k in range(8)]
    block = pp.host_batch(wins, 8, dev)
    want = torch.from_numpy(np.ascontiguousarray(block))
    torch.cuda._sleep(1 << 30)  # hold the stream: the copy below stays pending
    x = pp.stage_batch(block, dev).to(dev, non_blocking=True)
    del block
    others = [pp.host_batch([np.full_like(w, 255 - k) for w in wins], 8, dev) for k in range(4)]
    torch.cuda.synchronize()
    assert torch.equal(x.contiguous().cpu(), want)
    assert all(int(o.min()) == 255 - k for k, o in enumerate(others))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_slice_batch_norm_kernels_against_plain(dev, k):
    """``SliceBatchNorm`` (``UNET_TPU_BN=slice:k``) at batch 4: one forward
    launch over the first min(k, 4) samples and one backward launch over
    all four, agreeing with the plain reductions (float32: rtol 1e-5); the
    running mean equal to 0.1 × the prefix's mean."""
    from unet_tpu_torch.models.layers import SliceBatchNorm
    from unet_tpu_torch.ops import bn

    x, dy = _bn_inputs((4, 16, 20, 24), torch.float32, dev, seed=2)
    out = {}
    for name, red in (("kernel", bn.KERNEL_REDUCTIONS), ("plain", bn.PLAIN_REDUCTIONS)):
        m = SliceBatchNorm(16, n_stat=k).to(dev).train()
        m.reductions = red
        xi = x.clone().requires_grad_(True)
        before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
        y = m(xi)
        (y * dy).sum().backward()
        launched = (bn.bn_sum_sumsq.launches - before[0], bn.bn_bwd_sums.launches - before[1])
        out[name] = (y, xi.grad, m.weight.grad, m.bias.grad, m.running_mean, launched)
    assert out["kernel"][-1] == (1, 1) and out["plain"][-1] == (0, 0)
    for a, b in zip(out["kernel"][:-1], out["plain"][:-1]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    want = 0.1 * x[:min(k, 4)].double().mean(dim=(0, 2, 3))
    torch.testing.assert_close(out["kernel"][4].double(), want, rtol=1e-5, atol=1e-6)


def test_remat_step_moves_running_statistics_once(dev):
    """The xresnet18 tpu_opt U-Net at float32 (TF32 off), batch 4 × 64²:
    with remat the running statistics after one step equal those without
    it bit for bit, the loss within 1e-6 relative and the gradients within
    1e-5 relative L2; bn_sum_sumsq launched once a site plus once a site
    inside a recomputed block, bn_bwd_sums once a site."""
    from unet_tpu_torch.models import build_unet, init_weights
    from unet_tpu_torch.models.layers import BatchNorm
    from unet_tpu_torch.ops import bn
    from unet_tpu_torch.train.losses import cross_entropy, fold_loss_layout

    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand((4, 3, 64, 64), generator=g, device=dev)
    y = torch.randint(0, 3, (4, 64, 64), generator=g, device=dev)
    out = {}
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for remat in (False, True):
            model = build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32, remat=remat)
            init_weights(model, torch.Generator().manual_seed(0))
            model.to(dev).train()
            before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
            loss = cross_entropy(*fold_loss_layout(model(x, fold_logits=True), y))
            loss.backward()
            torch.cuda.synchronize()
            launched = (bn.bn_sum_sumsq.launches - before[0], bn.bn_bwd_sums.launches - before[1])
            out[remat] = (loss.item(), [p.grad.clone() for p in model.parameters()],
                          {k: v.clone() for k, v in model.state_dict().items()
                           if "running" in k}, launched)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    sites = sum(isinstance(m, BatchNorm) for m in model.modules())
    blocks = [model.encoder.get_submodule(n) for names in model.encoder.block_names
              for n in names] + [model.get_submodule(f"up_{i}") for i in range(model.n_up)]
    inside = sum(isinstance(m, BatchNorm) for b in blocks for m in b.modules())
    assert out[False][3] == (sites, sites) and out[True][3] == (sites + inside, sites)
    for k, v in out[False][2].items():
        assert torch.equal(out[True][2][k], v), k
    assert abs(out[True][0] - out[False][0]) <= 1e-6 * abs(out[False][0])
    num = sum(float((a - b).pow(2).sum()) for a, b in zip(out[True][1], out[False][1]))
    den = sum(float(b.pow(2).sum()) for b in out[False][1])
    assert (num / den) ** 0.5 <= 1e-5


SPATIAL_TOPOLOGIES = {"tpu_opt": dict(tpu_opt=True),
                      "parity_sa": dict(tpu_opt=False, self_attention=True)}


def _spatial_model(kw: dict):
    from unet_tpu_torch.models import build_unet, init_weights
    from unet_tpu_torch.models.layers import SelfAttention

    model = init_weights(build_unet("xresnet18", n_out=3, c_in=3, dtype=torch.float32, **kw),
                         torch.Generator().manual_seed(0))
    for m in model.modules():
        if isinstance(m, SelfAttention):
            m.gamma.data.fill_(0.5)
    return model


def _spatial_train_grads(model, x, dy, scope):
    """Training-mode forward and backward of ``sum(logits · dy)`` on this
    rank's rows of ``x`` (the whole batch without a scope), BatchNorm over
    the world; the parameters' gradients summed over the ranks."""
    import torch.distributed as dist

    from unet_tpu_torch.models.layers import sync_batch_norm
    from unet_tpu_torch.parallel import halo

    sync_batch_norm(model, None if scope is None else dist.group.WORLD)
    model.train()
    with halo.space_scope(scope):
        y = model(halo.split_rows(x, 2, scope) if scope else x)
        (y * (halo.split_rows(dy, 2, scope) if scope else dy)).sum().backward()
    grads = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    if scope is not None:
        dist.all_reduce(grads)
    return grads.cpu()


def _spatial_forward_rank(rank, port, x, out):
    """One of two gloo ranks on the card: each topology's forward on this
    rank's rows (TF32 off), the rows gathered; then a training step of
    tpu_opt with remat (the backward recomputes the blocks, and their halo
    exchanges, on autograd's thread), its gradients summed."""
    from unet_tpu_torch.parallel import halo, mesh

    res = {}
    try:
        mesh.init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo", device="cuda")
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        scope = mesh.space_layout(2)
        dev = mesh.rank_device("cuda")
        for name, kw in SPATIAL_TOPOLOGIES.items():
            model = _spatial_model(kw).to(dev)
            with torch.no_grad(), halo.space_scope(scope):
                local = model(halo.split_rows(x.to(dev), 2, scope))
            res[name] = halo.gather_rows(local, 2, scope).cpu()
        model = _spatial_model(dict(tpu_opt=True, remat=True)).to(dev)
        res["remat_grads"] = _spatial_train_grads(model, x.to(dev), _spatial_dy(x).to(dev),
                                                  scope)
    except BaseException:
        import traceback

        res["error"] = traceback.format_exc()
    finally:
        mesh.close_distributed()
        torch.save(res, out)


def _spatial_dy(x):
    return torch.randn((x.shape[0], 3, *x.shape[2:]), generator=torch.Generator().manual_seed(2))


def test_spatial_forward_over_two_ranks_matches_unsharded(dev, tmp_path):
    """Spatial partitioning on the card: two gloo ranks each hold half the
    rows of a (2, 3, 128, 128) batch; the gathered float32 logits (TF32
    off) of tpu_opt and of parity with self-attention equal the unsharded
    forward on the card within JAX's bars (atol 1e-5, rtol 1e-4), and the
    ranks' gathered logits are bit-equal. A tpu_opt training step with
    remat over the two ranks: its summed gradients within 1e-2 relative
    L2 of the unsharded step's without remat (the BatchNorm sums of two
    halves in float32; 6.9e-4 on the CPU), bit-equal on the two ranks."""
    import multiprocessing as mp

    from unet_tpu_torch.parallel import mesh

    x = torch.randn((2, 3, 128, 128), generator=torch.Generator().manual_seed(1))
    port = mesh.free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_spatial_forward_rank, args=(r, port, x, tmp_path / f"r{r}.pt"))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert not any(p.is_alive() for p in procs)
    ranks = [torch.load(tmp_path / f"r{r}.pt", weights_only=False) for r in range(2)]
    assert all("error" not in r for r in ranks), [r.get("error") for r in ranks]
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, kw in SPATIAL_TOPOLOGIES.items():
            with torch.no_grad():
                want = _spatial_model(kw).to(dev)(x.to(dev)).cpu()
            assert torch.equal(ranks[0][name], ranks[1][name])
            torch.testing.assert_close(ranks[0][name], want, atol=1e-5, rtol=1e-4)
        want = _spatial_train_grads(_spatial_model(dict(tpu_opt=True)).to(dev), x.to(dev),
                                    _spatial_dy(x).to(dev), None)
        got = ranks[0]["remat_grads"]
        assert torch.equal(got, ranks[1]["remat_grads"])
        assert float((got - want).norm()) <= 1e-2 * float(want.norm())
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def test_bench_kernels_section(dev):
    """``bench``'s kernels section at small shapes, in a child process as
    ``bench`` runs it (the profiler sessions of earlier tests in this
    process can leave later traces short of device events): each of the
    five kernels against its plain version within ``capability_check``'s
    bars (the section raises otherwise), timed, bounded and launched."""
    from unet_tpu_torch import bench

    res = bench._bench_section("bench_kernels", dict(tile=64, batch_size=2, device="cuda"),
                               600)
    assert "error" not in res, res
    rows = res["kernels"]
    assert set(rows) == {"bn_sum_sumsq", "bn_bwd_sums", "flip_scale", "blend_count",
                         "offset_copy"}
    for name, row in rows.items():
        if row["bar"] == "bit-equal":
            assert row["max_abs_err"] == 0.0, name
        else:
            assert 0 <= row["max_abs_err"] < 1e-1, (name, row["max_abs_err"])
        for key in ("ms", "call_ms"):
            assert 0 < row[key]["min"] <= row[key]["median"] <= row[key]["max"], (name, key)
        assert row["plain_ms"] > 0, name
        assert (row["library_ms"] is None) == (name == "flip_scale")
        assert row["bound_ms"] > 0 and row["bound_by"] in ("bytes", "operations")
        assert res["launches"][name] > 0, name
