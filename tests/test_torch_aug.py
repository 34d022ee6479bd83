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


# --- the host side of a flip_scale launch: parameter blocks and the plan ---


def _unpack(block, n):
    """(hflip, vflip, scales) of the first ``n`` samples of a parameter block."""
    block = np.frombuffer(block, np.uint8)
    words = aug.MAX_B // 8
    bits = np.unpackbits(block[:2 * words], bitorder="little").reshape(2, -1)
    return bits[0, :n].astype(bool), bits[1, :n].astype(bool), \
        block[2 * words:].view("<f4")[:n]


@pytest.mark.parametrize("b", [1, 16, 33, 512, 600, 1100])
def test_pack_flip_params_round_trips(b):
    """Bits and scales come back from each block as given; blocks cover
    the batch in runs of MAX_B samples; every unused bit and scale is 0."""
    rng = np.random.default_rng(b)
    hf, vf = rng.random(b) < 0.5, rng.random(b) < 0.3
    scales = rng.uniform(1e-3, 2, b).astype(np.float32)
    blocks = aug.pack_flip_params(hf, vf, scales)
    assert [(s, e) for s, e, _ in blocks] == \
        [(s, min(s + aug.MAX_B, b)) for s in range(0, b, aug.MAX_B)]
    for start, stop, block in blocks:
        assert isinstance(block, bytes) and len(block) == aug.PARAM_BYTES
        h, v, s = _unpack(block, aug.MAX_B)
        n = stop - start
        np.testing.assert_array_equal(h[:n], hf[start:stop])
        np.testing.assert_array_equal(v[:n], vf[start:stop])
        np.testing.assert_array_equal(s[:n], scales[start:stop])
        assert not h[n:].any() and not v[n:].any() and not s[n:].any()


def test_pack_flip_params_bit_words_are_little_endian_uint32():
    """Sample i's flag is bit i % 32 of uint32 word i // 32, as the kernel
    reads ``hbits[b >> 5] >> (b & 31)``."""
    hf = np.zeros(70, bool)
    hf[[0, 33, 69]] = True
    block = np.frombuffer(aug.pack_flip_params(hf, ~hf, np.ones(70, np.float32))[0][2], np.uint8)
    h_words = block[:aug.MAX_B // 8].view("<u4")
    v_words = block[aug.MAX_B // 8:aug.MAX_B // 4].view("<u4")
    assert list(h_words[:3]) == [1, 2, 1 << 5] and not h_words[3:].any()
    assert list(v_words[:3]) == [0xFFFFFFFE, 0xFFFFFFFD, 0x1F & ~(1 << 5)]


def test_pack_flip_params_takes_the_scales_as_float32():
    """Scales given in float64 are rounded to float32 once, as the plain
    version's ``scales.to(float32)`` rounds them."""
    s64 = np.array([1 / 255, 1 / 3, 0.1])
    block = aug.pack_flip_params(np.zeros(3, bool), np.zeros(3, bool), s64)[0][2]
    np.testing.assert_array_equal(_unpack(block, 3)[2],
                                  torch.tensor(s64).to(torch.float32).numpy())


def test_pack_flip_params_takes_torch_lists_as_the_wrapper_passes_them():
    """The wrapper packs ``tolist()`` of its flag and scale tensors."""
    hf, vf = torch.arange(40) % 3 == 0, torch.arange(40) % 5 == 1
    s = torch.linspace(0.001, 2.0, 40)
    want = aug.pack_flip_params(hf.numpy(), vf.numpy(), s.numpy())
    assert aug.pack_flip_params(hf.tolist(), vf.tolist(), s.tolist()) == want


# (b, c, h, w, with_mask, sms, blocks): 16 x (3 + 1) x 512 rows of 4
# 128-element chunks stop at BLOCKS_PER_SM blocks a multiprocessor and the
# warps loop; small batches get one warp per item, counted at one element a
# group whatever path the launcher takes
@pytest.mark.parametrize("b,c,h,w,with_mask,sms,blocks", [
    (16, 3, 512, 512, True, 132, 132 * 8), (16, 3, 512, 512, True, 114, 114 * 8),
    (16, 3, 512, 300, True, 132, 132 * 8), (2, 3, 8, 8, False, 132, 6),
    (1, 1, 1, 1, False, 132, 1), (1, 1, 1, 129, True, 132, 1),
    (4, 3, 9, 64, True, 1, 8), (3, 2, 5, 300, False, 132, 12)])
def test_launch_blocks_sizes_the_grid_from_the_items_and_the_sms(b, c, h, w, with_mask, sms,
                                                                 blocks):
    assert aug.launch_blocks(b, c, h, w, with_mask, sms) == blocks


def test_launch_blocks_refuses_more_items_than_the_kernel_counts():
    with pytest.raises(ValueError, match="32-bit"):
        aug.launch_blocks(aug.MAX_B, 4096, 2048, 4, False, 132)
