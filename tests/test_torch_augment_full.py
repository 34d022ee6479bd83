"""PyTorch port: every augmentation op against the JAX package on the CPU.

RNG is not shared, so the port's ``apply_augment`` is fed JAX's own draws:
``jax_draws`` reads them from the key splits ``unet_tpu/data/augment.py``
``_augment`` makes (keys[0] hflip, [1] vflip, [2] brightness/contrast,
[3] dropout, [4] rot90, [5] saturation) and the result is held against
``_augment`` on the same scaled batch. rot90, the flips and the dropout
are exact; brightness/contrast and saturation within 1e-6 relative
(float32 multiply-adds in another order). Also: rot90 only on square
tiles, ``n_augmented`` with and without the reference quirk, the int16
quirk scales and ``split_idx`` gating.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.data import augment as jaug
from unet_tpu_torch.data import augment as taug
from unet_tpu_torch.ops.aug import fused_flip_scale

torch.set_num_threads(2)
OPS = {"rot90": dict(rot90_p=0.6), "hflip": dict(hflip_p=0.6), "vflip": dict(vflip_p=0.6),
       "brightness_contrast": dict(brightness_contrast_p=0.6),
       "saturation": dict(saturation_p=0.6), "dropout": dict(coarse_dropout_p=0.6),
       "all": dict(hflip_p=0.5, vflip_p=0.5, rot90_p=0.5, brightness_contrast_p=0.5,
                   saturation_p=0.5, coarse_dropout_p=0.5)}
EXACT = ("rot90", "hflip", "vflip", "dropout")


def _cfgs(**kw):
    kw = {"hflip_p": 0.0, "vflip_p": 0.0, **kw}
    return jaug.AugmentConfig(**kw), taug.AugmentConfig(**kw)


def jax_draws(key, b, h, w, cfg, n_aug):
    """The per-sample parameters ``_augment`` draws from ``key``, as the
    port's AugmentDraws (ops whose probability is 0 left at their none)."""
    d = taug.AugmentDraws.none(b, taug.AugmentConfig(dropout_holes=cfg.dropout_holes))
    in_range = jnp.arange(b) < n_aug
    keys = jax.random.split(key, 6)

    def gate(k, p):
        return in_range & (jax.random.uniform(k, (b,)) < p)

    def t(a):
        return torch.from_numpy(np.array(a))

    if cfg.rot90_p > 0 and h == w:
        k_g, k_n = jax.random.split(keys[4])
        d.rot_k = t(jnp.where(gate(k_g, cfg.rot90_p),
                              jax.random.randint(k_n, (b,), 1, 4), 0)).long()
    if cfg.hflip_p > 0:
        d.hflip = t(gate(keys[0], cfg.hflip_p))
    if cfg.vflip_p > 0:
        d.vflip = t(gate(keys[1], cfg.vflip_p))
    if cfg.brightness_contrast_p > 0:
        k_a, k_b, k_g = jax.random.split(keys[2], 3)
        d.bc = t(gate(k_g, cfg.brightness_contrast_p))
        d.alpha = t(1.0 + jax.random.uniform(k_a, (b,), minval=cfg.contrast_limit[0],
                                             maxval=cfg.contrast_limit[1]))
        d.beta = t(jax.random.uniform(k_b, (b,), minval=cfg.brightness_limit[0],
                                      maxval=cfg.brightness_limit[1]))
    if cfg.saturation_p > 0:
        k_g, k_s = jax.random.split(keys[5])
        d.sat = t(gate(k_g, cfg.saturation_p))
        d.sat_factor = t(1.0 + jax.random.uniform(k_s, (b,), minval=cfg.saturation_limit[0],
                                                  maxval=cfg.saturation_limit[1]))
    if cfg.coarse_dropout_p > 0:
        k_g, k_pos = jax.random.split(keys[3])
        d.drop = t(gate(k_g, cfg.coarse_dropout_p))
        highs = jnp.array([max(h - cfg.dropout_size, 1), max(w - cfg.dropout_size, 1)])
        d.holes = t(jax.random.randint(k_pos, (cfg.dropout_holes, 2, b), 0,
                                       highs[:, None])).long()
    return d


def _batch(seed, b=6, h=16, w=16, dtype=np.uint8, hi=256):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, size=(b, 3, h, w)).astype(dtype),
            rng.integers(0, 4, size=(b, h, w)).astype(np.uint8))


def _run_both(op, img, msk, dtype_str="int8", n_aug=None, quirks=False, key=0,
              mask_float=False):
    b, _, h, w = img.shape
    n_aug = b if n_aug is None else n_aug
    jcfg, tcfg = _cfgs(**OPS[op])
    scales = taug.sample_scales(b, n_aug, dtype_str, "reference", quirks)
    max_val = taug.value_max(dtype_str)
    k = jax.random.PRNGKey(key)
    jmsk = msk.astype(np.float32) if mask_float else msk
    want_i, want_m = jaug._augment(
        k, jnp.asarray(np.moveaxis(img, 1, 3).astype(np.float32))
        * jnp.asarray(scales.numpy())[:, None, None, None],
        jnp.asarray(jmsk), jcfg, n_aug, max_val)
    draws = jax_draws(k, b, h, w, jcfg, n_aug)
    got_i, got_m = taug.apply_augment(torch.from_numpy(img), torch.from_numpy(jmsk), draws,
                                      scales, tcfg, max_val, fused_flip_scale)
    return (np.asarray(want_i), np.asarray(want_m), np.moveaxis(got_i.numpy(), 1, 3),
            got_m.numpy(), draws)


@pytest.mark.parametrize("op", sorted(OPS))
def test_each_op_matches_jax_with_its_draws(op):
    img, msk = _batch(1)
    want_i, want_m, got_i, got_m, draws = _run_both(op, img, msk, key=3)
    np.testing.assert_array_equal(got_m, want_m)
    if op in EXACT:
        np.testing.assert_array_equal(got_i, want_i)
    else:
        np.testing.assert_allclose(got_i, want_i, rtol=1e-6, atol=1e-6 * np.abs(want_i).max())
    changed = ~np.all(got_i == img.transpose(0, 2, 3, 1).astype(np.float32), axis=(1, 2, 3))
    assert changed.any() and not changed.all(), changed  # p = 0.5/0.6 over 6 samples


@pytest.mark.parametrize("op", ["all", "rot90", "dropout"])
def test_only_the_first_n_aug_samples_change(op):
    """n_aug = 3 of 6: JAX's gates are off past it, and so is every op
    here; the rest is only scaled."""
    img, msk = _batch(2)
    want_i, want_m, got_i, got_m, draws = _run_both(op, img, msk, n_aug=3, key=5)
    tol = dict(rtol=1e-6, atol=1e-6 * np.abs(want_i).max())
    np.testing.assert_allclose(got_i, want_i, **tol)
    np.testing.assert_array_equal(got_m, want_m)
    np.testing.assert_array_equal(got_i[3:], img[3:].transpose(0, 2, 3, 1).astype(np.float32))
    for gate in (draws.bc, draws.sat, draws.drop, draws.rot_k != 0):
        assert not gate[3:].any()


def test_int16_quirk_scales_and_float_masks_match_jax():
    """uint16 tiles of dtype 'int16' under reference_quirks: the first
    n_aug samples at the reference's 255/65535, the rest at 1/255, every
    op on; a float32 regression mask moves with its tile (through the
    flip pass as int32 bits on the card)."""
    img, _ = _batch(4, dtype=np.uint16, hi=65536)
    msk = np.random.default_rng(4).uniform(0, 1, size=(6, 16, 16)).astype(np.float32)
    want_i, want_m, got_i, got_m, _ = _run_both("all", img, msk, dtype_str="int16", n_aug=4,
                                                quirks=True, key=7, mask_float=True)
    np.testing.assert_allclose(got_i, want_i, rtol=1e-6, atol=1e-6 * np.abs(want_i).max())
    np.testing.assert_array_equal(got_m, want_m)
    scales = taug.sample_scales(6, 4, "int16", "reference", True).numpy()
    assert scales.dtype == np.float32
    np.testing.assert_array_equal(scales, np.float32([255 / 65535] * 4 + [1 / 255] * 2))


def test_rot90_only_on_square_tiles():
    """A (16, 24) batch at rot90_p = 1: JAX skips the op, and the port's
    draws turn nothing; the flips still apply."""
    img, msk = _batch(6, h=16, w=24)
    jcfg, tcfg = _cfgs(rot90_p=1.0, hflip_p=1.0)
    draws = taug.draw_augment(6, 16, 24, tcfg, 6, torch.Generator().manual_seed(0))
    assert not draws.rot_k.any() and draws.hflip.all()
    want_i, want_m = jaug._augment(jax.random.PRNGKey(0),
                                   jnp.asarray(np.moveaxis(img, 1, 3).astype(np.float32)),
                                   jnp.asarray(msk), jcfg, 6, 255.0)
    got_i, got_m = taug.apply_augment(torch.from_numpy(img), torch.from_numpy(msk), draws,
                                      torch.ones(6), tcfg, 255.0)
    np.testing.assert_array_equal(np.moveaxis(got_i.numpy(), 1, 3), np.asarray(want_i))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_draws_follow_the_config():
    """Seeded draws repeat; gates only below n_aug, near their p; α, β,
    the saturation factor and the hole corners inside their ranges."""
    cfg = taug.AugmentConfig(**OPS["all"])
    a = taug.draw_augment(4000, 64, 64, cfg, 3000, torch.Generator().manual_seed(1))
    b = taug.draw_augment(4000, 64, 64, cfg, 3000, torch.Generator().manual_seed(1))
    for f in a.__dataclass_fields__:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    for gate in (a.hflip, a.vflip, a.bc, a.sat, a.drop, a.rot_k != 0):
        assert not gate[3000:].any()
        assert 0.45 < gate[:3000].float().mean().item() < 0.55
    assert set(a.rot_k[a.rot_k != 0].tolist()) == {1, 2, 3}
    assert 0.9 <= a.alpha.min() and a.alpha.max() <= 1.1
    assert -0.1 <= a.beta.min() and a.beta.max() <= 0.1
    assert 0.7 <= a.sat_factor.min() and a.sat_factor.max() <= 1.3
    assert a.holes.shape == (8, 2, 4000)
    assert a.holes.min() == 0 and a.holes.max() == 64 - 8 - 1


@pytest.mark.parametrize("b,frac", [(16, 1.0), (7, 0.3), (5, 0.0), (4, 0.5), (3, 0.99),
                                    (1, 1.0), (8, 0.875)])
@pytest.mark.parametrize("quirks", [False, True])
def test_n_augmented_matches_jax(b, frac, quirks):
    assert taug.n_augmented(b, frac, quirks) == jaug.n_augmented(b, frac, quirks)
    if quirks and frac == 1.0:
        assert taug.n_augmented(b, frac, quirks) == 0  # the reference's [:0]


@pytest.mark.parametrize("split,split_idx", [
    ("train", 0), ("valid", 0), ("train", 1), ("valid", 1), ("train", None), ("valid", None)])
@pytest.mark.parametrize("quirks", [False, True])
def test_split_idx_gating_matches_jax(split, split_idx, quirks):
    """Deterministic ops (flips at p = 1, brightness/contrast at p = 1
    with degenerate limits) on int16 tiles: where split_idx lets the split
    augment, the first ceil(B·0.5) samples change (and, under the quirk,
    take the reference's scale); elsewhere the batch is only scaled."""
    img, msk = _batch(8, dtype=np.uint16, hi=65536)
    kw = dict(hflip_p=1.0, vflip_p=1.0, brightness_contrast_p=1.0,
              brightness_limit=(0.03, 0.03), contrast_limit=(-0.05, -0.05))
    common = dict(n_transform_imgs=0.5, dtype_str="int16", normalize="reference",
                  split=split, split_idx=split_idx, reference_quirks=quirks)
    want_i, want_m = jaug.augment_batch(
        jax.random.PRNGKey(0), jnp.asarray(np.moveaxis(img, 1, 3).astype(np.float32)),
        jnp.asarray(msk), jaug.AugmentConfig(**kw), use_fused=False, **common)
    got_i, got_m = taug.augment_batch(torch.from_numpy(img), torch.from_numpy(msk),
                                      taug.AugmentConfig(**kw), torch.Generator(), **common)
    want_i = np.asarray(want_i)
    np.testing.assert_allclose(np.moveaxis(got_i.numpy(), 1, 3), want_i, rtol=1e-6,
                               atol=1e-6 * np.abs(want_i).max())
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    active = split_idx is None or (split_idx, split) in ((0, "train"), (1, "valid"))
    plain = img.transpose(0, 2, 3, 1).astype(np.float32) * np.float32(1 / 255)
    assert np.array_equal(want_i[:4], plain[:4]) != active
    np.testing.assert_array_equal(want_i[4:], plain[4:])
