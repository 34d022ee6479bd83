"""PyTorch port: the tpu_opt U-Net's logits against JAX's on the same
weights (float32; rtol 1e-4, atol 1e-4·max|jax| — the convolutions sum in
another order than XLA's)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu_torch.models import build_unet
from unet_tpu_torch.train.checkpoint import from_flax_variables

torch.set_num_threads(2)


def _randomize_stats(variables, rng):
    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "mean":
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, variables))


def _pair(arch, n_out, size, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(2, size, size, 3)).astype(np.float32)
    jm = jax_build_unet(arch, n_out=n_out, c_in=3, dtype=jnp.float32, tpu_opt=True)
    v = _randomize_stats(jm.init(jax.random.PRNGKey(seed), x, train=False), rng)
    tm = build_unet(arch, n_out=n_out, c_in=3, dtype=torch.float32)
    tm.load_state_dict({k: torch.from_numpy(np.array(a))
                        for k, a in from_flax_variables(v).items()}, strict=True)
    return jm, v, tm, x


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ["xresnet18", "xresnet34"])
def test_folded_logits_match_jax(arch):
    jm, v, tm, x = _pair(arch, 3, 64)
    want = np.asarray(jm.apply(v, x, train=False, fold_logits=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), fold_logits=True)
    assert got.dtype == torch.float32 and got.shape == (2, 12, 32, 32)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_full_res_logits_match_jax():
    jm, v, tm, x = _pair("xresnet18", 3, 64, seed=1)
    want = np.asarray(jm.apply(v, x, train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_regression_head_matches_jax():
    jm, v, tm, x = _pair("xresnet18", 1, 64, seed=2)
    want = np.asarray(jm.apply(v, x, train=False, fold_logits=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), fold_logits=True)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_odd_encoder_sizes_resize_like_jax():
    """100² tiles: /32 is not whole, so decoder upsamples nearest-resize
    onto the skip grid."""
    jm, v, tm, x = _pair("xresnet18", 2, 100, seed=3)
    want = np.asarray(jm.apply(v, x, train=False, fold_logits=True))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2), fold_logits=True)
    _close(got.permute(0, 2, 3, 1).numpy(), want)


def test_state_dict_keys_follow_flax_names():
    tm = build_unet("xresnet18", n_out=2, c_in=3, dtype=torch.float32)
    keys = set(tm.state_dict())
    for k in ("encoder.stem_0.conv.weight", "encoder.stage_3_block_1.conv2.bn.running_var",
              "mid_bn.weight", "up_0.shuf.convt.weight", "up_3.conv1.conv.bias",
              "last_cross.conv2.conv.weight", "head.weight"):
        assert k in keys
    assert not any(k.startswith("up_3.conv2") for k in keys)  # single_conv


def test_unported_topologies_raise():
    """The parity topology and self-attention, once later slices, now
    build and run (their numerics against JAX: tests/test_torch_parity.py);
    what still raises is a tpu_opt model on tiles not divisible by 4."""
    par = build_unet("xresnet18", tpu_opt=False, self_attention=True, dtype=torch.float32)
    with torch.no_grad():
        assert par(torch.rand(1, 3, 66, 66)).shape == (1, 2, 66, 66)
    assert build_unet("xresnet18", self_attention=True).up_1.sa is not None
    tm = build_unet("xresnet18", dtype=torch.float32)
    with pytest.raises(ValueError, match="divisible by 4"):
        tm(torch.zeros(1, 3, 66, 66))
    # training mode is ported: it runs, and folds the logits for the loss
    out = tm.train()(torch.rand(2, 3, 64, 64), fold_logits=True)
    assert out.shape == (2, 8, 32, 32)
