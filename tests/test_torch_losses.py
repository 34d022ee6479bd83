"""PyTorch port: the regression losses and the dice loss against the JAX
package on the CPU.

MSE, L1, smooth L1 (β = 0.5) and dice, each with and without a per-sample
mask, on full-resolution predictions and in the folded layout of the
tpu_opt head (the loss on the pre-shuffle logits); ``build_loss``'s
defaults. Inputs come from numpy seeds; values within 1e-6 relative
(float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.train import losses as jl
from unet_tpu_torch.train import losses as tl

torch.set_num_threads(2)
B, H, W, C = 3, 8, 10, 4
MASK = np.array([True, False, True])


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _regression_inputs(seed, folded):
    """(JAX preds, JAX targets, port preds, port targets): channel 0 of a
    one-channel head, through both packages' fold_loss_layout when
    ``folded`` (pre-shuffle logits (B, h, w, 4) against (B, 2h, 2w)
    targets)."""
    rng = np.random.default_rng(seed)
    if folded:
        logits = rng.normal(size=(B, H // 2, W // 2, 4)).astype(np.float32)
        targets = rng.uniform(-1, 2, size=(B, H, W)).astype(np.float32)
        jlg, jt = jl.fold_loss_layout(jnp.asarray(logits), jnp.asarray(targets))
        tlg, tt = tl.fold_loss_layout(_nchw(logits), torch.from_numpy(targets))
        return jlg[..., 0], jt, tlg[:, 0], tt
    preds = rng.normal(size=(B, H, W)).astype(np.float32)
    targets = rng.uniform(-1, 2, size=(B, H, W)).astype(np.float32)
    return (jnp.asarray(preds), jnp.asarray(targets), torch.from_numpy(preds),
            torch.from_numpy(targets))


@pytest.mark.parametrize("name", ["mse", "l1", "smooth_l1"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("folded", [False, True])
def test_regression_losses_match_jax(name, masked, folded):
    seed = ["mse", "l1", "smooth_l1"].index(name) * 4 + 2 * masked + folded
    jp, jt, tp, tt = _regression_inputs(seed, folded)
    jfn = {"mse": jl.mse_loss, "l1": jl.l1_loss, "smooth_l1": jl.smooth_l1_loss}[name]
    tfn = {"mse": tl.mse_loss, "l1": tl.l1_loss, "smooth_l1": tl.smooth_l1_loss}[name]
    kw_j = {"sample_mask": jnp.asarray(MASK)} if masked else {}
    kw_t = {"sample_mask": torch.from_numpy(MASK)} if masked else {}
    want = float(jfn(jp, jt, **kw_j))
    got = tfn(tp, tt, **kw_t).item()
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_smooth_l1_has_both_branches():
    """β = 0.5: |d| < 0.5 is quadratic, the rest linear, as JAX's."""
    d = np.array([[0.0, 0.2, 0.49, 0.5, 0.7, -3.0]], np.float32)
    z = np.zeros_like(d)
    want = float(jl.smooth_l1_loss(jnp.asarray(d), jnp.asarray(z)))
    got = tl.smooth_l1_loss(torch.from_numpy(d), torch.from_numpy(z)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.mean([0, 0.04, 0.2401, 0.25, 0.45, 2.75]), rtol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("folded", [False, True])
def test_dice_loss_matches_jax(masked, folded):
    """fastai DiceLoss: softmax in float32, 1 − dice per (sample, class),
    summed (reduction='sum'); a class absent from a sample counts too."""
    rng = np.random.default_rng(7 + 2 * masked + folded)
    if folded:
        logits = rng.normal(size=(B, H // 2, W // 2, C * 4)).astype(np.float32)
        targets = rng.integers(0, C - 1, size=(B, H, W))
        jlg, jt = jl.fold_loss_layout(jnp.asarray(logits), jnp.asarray(targets))
        tlg, tt = tl.fold_loss_layout(_nchw(logits), torch.from_numpy(targets))
    else:
        logits = rng.normal(size=(B, H, W, C)).astype(np.float32)
        targets = rng.integers(0, C - 1, size=(B, H, W))
        jlg, jt, tlg, tt = (jnp.asarray(logits), jnp.asarray(targets), _nchw(logits),
                            torch.from_numpy(targets))
    kw_j = {"sample_mask": jnp.asarray(MASK)} if masked else {}
    kw_t = {"sample_mask": torch.from_numpy(MASK)} if masked else {}
    want = float(jl.dice_loss(jlg, jt, **kw_j))
    got = tl.dice_loss(tlg, tt, **kw_t).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert want > (2 if masked else 3) * 1.0  # summed over (sample, class)


def test_dice_loss_gradient_matches_jax():
    """The backward through the softmax: within 1e-5 of JAX's gradient,
    relative to its largest element."""
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(2, 6, 5, 3)).astype(np.float32)
    targets = rng.integers(0, 3, size=(2, 6, 5))
    want = np.moveaxis(np.asarray(jax.grad(lambda x: jl.dice_loss(x, jnp.asarray(targets)))(
        jnp.asarray(logits))), -1, 1)
    x = _nchw(logits).requires_grad_(True)
    tl.dice_loss(x, torch.from_numpy(targets)).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name,regression", [
    (None, True), (None, False), ("mse", True), ("MSELossFlat", True), ("l1", True),
    ("L1LossFlat", True), ("smooth_l1", True), ("SmoothL1", True), ("dice", False),
    ("DiceLoss", False), ("ce", False), ("focal", False)])
def test_build_loss_resolves_names_as_jax(name, regression):
    """The reference's defaults (None → MSE for regression, weighted CE
    otherwise) and every alias give JAX's value on the same input."""
    rng = np.random.default_rng(9)
    weight = np.array([0.2, 0.5, 0.3], np.float32)
    if regression:
        p = rng.normal(size=(2, 4, 5)).astype(np.float32)
        y = rng.uniform(0, 1, size=(2, 4, 5)).astype(np.float32)
        jin, tin = (jnp.asarray(p), jnp.asarray(y)), (torch.from_numpy(p), torch.from_numpy(y))
    else:
        lg = rng.normal(size=(2, 4, 5, 3)).astype(np.float32)
        y = rng.integers(0, 3, size=(2, 4, 5))
        jin, tin = (jnp.asarray(lg), jnp.asarray(y)), (_nchw(lg), torch.from_numpy(y))
    want = float(jl.build_loss(name, regression, None if regression
                               else jnp.asarray(weight))(*jin))
    got = tl.build_loss(name, None if regression else torch.from_numpy(weight),
                        regression=regression)(*tin).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unknown_loss_raises_in_both():
    for build in (lambda: jl.build_loss("hinge"), lambda: tl.build_loss("hinge")):
        with pytest.raises(ValueError, match="Unknown loss"):
            build()
