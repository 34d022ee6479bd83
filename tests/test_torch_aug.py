"""PyTorch port: flip + scale augmentation against the JAX package on the CPU.

The plain version of the ``flip_scale`` kernel is held bit-equal to the
Pallas kernel of ``unet_tpu/ops/pallas_aug.py`` in interpret mode, given
the same explicit flags; the port's ``augment_batch`` follows JAX's
``n_transform_imgs`` and ``split_idx`` gating (flip probabilities of 1
make the flags the same in both, as RNG is not shared).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.data import augment as jaug
from unet_tpu.ops.pallas_aug import fused_flip_scale as jax_fused_flip_scale
from unet_tpu.ops.pallas_aug import splits_for
from unet_tpu_torch.data import augment as taug
from unet_tpu_torch.ops import aug

torch.set_num_threads(2)

IMAGE_CASES = {  # dtype -> (value range, the JAX package's dtype_str)
    "uint8": (256, "int8"), "uint16": (65536, "int16"), "float32": (None, "float32")}


def _batch(seed, dtype, b=4, c=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    hi, _ = IMAGE_CASES[dtype]
    if hi is None:
        img = rng.normal(0, 100, size=(b, c, h, w)).astype(np.float32)
    else:
        img = rng.integers(0, hi, size=(b, c, h, w)).astype(dtype)
    msk = rng.integers(0, 5, size=(b, h, w)).astype(np.uint8)
    return img, msk


@pytest.mark.parametrize("dtype", sorted(IMAGE_CASES))
def test_plain_flip_scale_bit_equal_to_pallas_interpret(dtype):
    """Every (hflip, vflip) combination, per-sample scales; images and
    masks bit for bit."""
    img, msk = _batch(0, dtype)
    hf = np.array([False, True, False, True])
    vf = np.array([False, False, True, True])
    scales = np.array([1.0, 0.5, 1 / 255, 1 / 65535], np.float32)
    want_i, want_m = jax_fused_flip_scale(
        jnp.asarray(np.moveaxis(img, 1, 3).astype(np.float32)), jnp.asarray(msk),
        jnp.asarray(hf), jnp.asarray(vf), jnp.asarray(scales), interpret=True,
        n_splits=splits_for(IMAGE_CASES[dtype][1]))
    got_i, got_m = aug.fused_flip_scale(torch.from_numpy(img), torch.from_numpy(msk),
                                        torch.from_numpy(hf), torch.from_numpy(vf),
                                        torch.from_numpy(scales))
    assert got_i.dtype == torch.float32 and got_m.dtype == torch.uint8
    np.testing.assert_array_equal(np.moveaxis(got_i.numpy(), 1, 3), np.asarray(want_i))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_plain_flip_scale_is_the_flipped_float_times_scale():
    img, msk = _batch(1, "uint8")
    hf = torch.tensor([True, False, True, False])
    vf = torch.tensor([True, True, False, False])
    s = torch.tensor([2.0, 0.25, 1.0, 1 / 255])
    x = torch.from_numpy(img)
    before = aug.fused_flip_scale.launches
    got_i, got_m = aug.fused_flip_scale(x, None, hf, vf, s)
    assert got_m is None
    want = torch.stack([x[0].float().flip(1, 2) * 2.0, x[1].float().flip(1) * 0.25,
                        x[2].float().flip(2), x[3].float() * s[3]])
    assert torch.equal(got_i, want)
    assert aug.fused_flip_scale.launches == before  # CPU tensors never launch it


@pytest.mark.parametrize("b,frac", [(16, 1.0), (7, 0.3), (5, 0.0), (4, 0.5),
                                    (3, 0.99), (1, 1.0)])
def test_n_augmented_matches_jax(b, frac):
    assert taug.n_augmented(b, frac) == jaug.n_augmented(b, frac)


def test_n_augmented_rejects_fractions_outside_0_1():
    with pytest.raises(ValueError, match="between 1 and 0"):
        taug.n_augmented(4, 1.5)


@pytest.mark.parametrize("split,split_idx,frac", [
    ("train", 0, 1.0), ("valid", 0, 1.0), ("train", 1, 1.0), ("valid", 1, 1.0),
    ("valid", None, 1.0), ("train", 0, 0.5), ("train", 0, 0.0)])
def test_augment_batch_gating_matches_jax(split, split_idx, frac):
    """With flip probabilities of 1 the first ceil(B·frac) samples flip
    both ways in both packages, where split_idx lets the split augment;
    the others are only scaled. Bit-equal, int8 'unit' scaling."""
    img, msk = _batch(2, "uint8")
    cfg_kw = dict(hflip_p=1.0, vflip_p=1.0)
    want_i, want_m = jaug.augment_batch(
        jax.random.PRNGKey(0), jnp.asarray(np.moveaxis(img, 1, 3).astype(np.float32)),
        jnp.asarray(msk), jaug.AugmentConfig(**cfg_kw), n_transform_imgs=frac,
        dtype_str="int8", normalize="unit", split=split, split_idx=split_idx,
        use_fused=False)
    got_i, got_m = taug.augment_batch(
        torch.from_numpy(img), torch.from_numpy(msk), taug.AugmentConfig(**cfg_kw),
        torch.Generator().manual_seed(0), n_transform_imgs=frac, dtype_str="int8",
        normalize="unit", split=split, split_idx=split_idx)
    np.testing.assert_array_equal(np.moveaxis(got_i.numpy(), 1, 3), np.asarray(want_i))
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))


def test_flip_flags_follow_the_probabilities():
    """Flags come from the torch.Generator: seeded runs repeat, samples
    past n_aug never flip, and p = 0.5 flips about half."""
    cfg = taug.AugmentConfig()
    a = taug.flip_flags(4000, 3000, cfg, torch.Generator().manual_seed(3))
    b = taug.flip_flags(4000, 3000, cfg, torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for f in a:
        assert not f[3000:].any()
        assert 0.45 < f[:3000].float().mean().item() < 0.55


@pytest.mark.parametrize("dtype_str", ["int8", "int16"])
@pytest.mark.parametrize("normalize", ["reference", "unit"])
def test_scales_match_jax(dtype_str, normalize):
    assert taug.image_scale(dtype_str, normalize) == jaug.image_scale(dtype_str, normalize)
    assert taug.value_max(dtype_str, normalize) == jaug.value_max(dtype_str, normalize)


def test_more_than_flips_is_not_yet_ported():
    img, msk = _batch(3, "uint8")
    cfg = taug.AugmentConfig(brightness_contrast_p=0.5)
    assert cfg.describe() == jaug.AugmentConfig(brightness_contrast_p=0.5).describe()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        taug.augment_batch(torch.from_numpy(img), torch.from_numpy(msk), cfg,
                           torch.Generator())
