"""PyTorch port: the focal loss against the JAX package's ``focal_loss``.

Class-first logits (B, C, H, W) and the tpu_opt folded layout of
``fold_loss_layout`` (class axis 1, phase axis 2), with and without class
weights, ``sample_mask`` and targets outside [0, C). Values within 1e-6
relative (float32 on both sides, sums in another order); gradients of the
port's float32 loss against JAX's at float64, within 1e-5 of the largest
gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.train import losses as jl
from unet_tpu_torch.train import losses as tl

B, C, H, W = 3, 4, 6, 8
CASES = {  # weighted, masked, targets outside [0, C)
    "plain": (False, False, False),
    "weighted": (True, False, False),
    "sample_mask": (False, True, False),
    "outside": (False, False, True),
    "weighted_outside_masked": (True, True, True),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def inputs(case: str, seed: int = 0):
    weighted, masked, outside = CASES[case]
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, H, W, C)) * 2).astype(np.float32)  # JAX NHWC
    targets = rng.integers(0, C, size=(B, H, W))
    if outside:
        targets[0, :2] = C
        targets[1, 3] = -1
        targets[2, :, 5] = 255
    weight = rng.uniform(0.2, 3.0, C).astype(np.float32) if weighted else None
    mask = np.array([True, False, True]) if masked else None
    return logits, targets, weight, mask


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a, dtype=None):
    return None if a is None else jnp.asarray(a, dtype)


@pytest.mark.parametrize("case", sorted(CASES))
def test_focal_value_matches_jax(case):
    logits, targets, weight, mask = inputs(case)
    want = float(jl.focal_loss(jnp.asarray(logits), jnp.asarray(targets), 2.0,
                               _j(weight), _j(mask)))
    got = tl.focal_loss(_nchw(logits), torch.from_numpy(targets), 2.0, _t(weight), _t(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    by_name = tl.build_loss("FocalLossFlat", _t(weight))(
        _nchw(logits), torch.from_numpy(targets), sample_mask=_t(mask))
    np.testing.assert_allclose(by_name.item(), want, rtol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_folded_focal_value_matches_jax(case):
    """Pre-shuffle logits (B, C·4, h, w) against full-resolution targets:
    JAX's focal on its folded layout, the port's on its own."""
    _, _, weight, mask = inputs(case)
    rng = np.random.default_rng(1)
    folded = (rng.normal(size=(B, H // 2, W // 2, C * 4)) * 2).astype(np.float32)
    targets = inputs(case, seed=2)[1]
    lg, t = jl.fold_loss_layout(jnp.asarray(folded), jnp.asarray(targets))
    want = float(jl.focal_loss(lg, t, 2.0, _j(weight), _j(mask)))
    lgt, tt = tl.fold_loss_layout(_nchw(folded), torch.from_numpy(targets))
    got = tl.build_loss("focal", _t(weight))(lgt, tt, sample_mask=_t(mask))
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_focal_gradient_matches_jax_float64(case, folded):
    logits, targets, weight, mask = inputs(case)
    if folded:
        logits = (np.random.default_rng(1).normal(size=(B, H // 2, W // 2, C * 4))
                  * 2).astype(np.float32)
    with jax.enable_x64():
        def jax_loss(lg):
            t = jnp.asarray(targets)
            if folded:
                lg, t = jl.fold_loss_layout(lg, t)
            return jl.focal_loss(lg, t, 2.0, _j(weight, jnp.float64), _j(mask))

        want = np.moveaxis(np.asarray(jax.grad(jax_loss)(jnp.asarray(logits, jnp.float64))),
                           -1, 1)
    x = _nchw(logits).requires_grad_(True)
    lg, t = (tl.fold_loss_layout(x, torch.from_numpy(targets)) if folded
             else (x, torch.from_numpy(targets)))
    tl.focal_loss(lg, t, 2.0, _t(weight), _t(mask)).backward()
    got = x.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    if CASES[case][2] and not folded:  # outside targets: no gradient there
        assert np.all(got[0, :, :2] == 0) and np.all(want[0, :, :2] == 0)


def test_other_losses_are_not_yet_ported():
    """The other losses by name: build_loss gives JAX's value for dice on
    logits and for mse, l1 and smooth_l1 on regression predictions;
    1e-6 relative (float32 sums)."""
    rng = np.random.default_rng(11)
    logits = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    labels = rng.integers(0, 3, size=(2, 6, 5))
    preds = rng.normal(size=(2, 6, 5)).astype(np.float32)
    targets = rng.uniform(-1, 1, size=(2, 6, 5)).astype(np.float32)
    for name in ("dice", "mse", "l1", "smooth_l1"):
        if name == "dice":
            j_in, t_in = (logits, labels), (_nchw(logits), torch.from_numpy(labels))
        else:
            j_in = (preds, targets)
            t_in = (torch.from_numpy(preds), torch.from_numpy(targets))
        want = float(jl.build_loss(name, name != "dice")(*map(jnp.asarray, j_in)))
        got = tl.build_loss(name, regression=name != "dice")(*t_in)
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, err_msg=name)
