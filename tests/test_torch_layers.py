"""PyTorch port: U-Net layers against their JAX functions (float32,
atol 1e-5; the port computes in NCHW, the JAX package in NHWC)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from unet_tpu.models import layers as jl
from unet_tpu_torch.models import layers as tl
from unet_tpu_torch.train.checkpoint import from_flax_variables

torch.set_num_threads(2)
ATOL = 1e-5


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 3, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, 3)


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _randomize_stats(variables, seed):
    """Random BatchNorm scale/bias/mean/var so BN is exercised."""
    rng = np.random.default_rng(seed)

    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k in ("mean",) or (k == "bias" and v.ndim == 1):
                out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out

    return walk(jax.tree_util.tree_map(np.asarray, variables))


def _load(module, variables):
    sd = from_flax_variables(variables)
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    return module.eval()


def test_depth_to_space():
    x = _rand(0, (2, 5, 6, 12))
    want = np.asarray(jl.depth_to_space(jnp.asarray(x), 2))
    np.testing.assert_allclose(nhwc(tl.depth_to_space(nchw(x), 2)), want, atol=ATOL)
    np.testing.assert_allclose(
        np.asarray(jl.depth_to_space_mxu(jnp.asarray(x), 2)), want, atol=ATOL)


def test_space_to_depth_mxu():
    x = _rand(1, (2, 8, 6, 3))
    want = np.asarray(jl.space_to_depth_mxu(jnp.asarray(x), 2))
    np.testing.assert_allclose(nhwc(tl.space_to_depth(nchw(x), 2)), want, atol=ATOL)


def test_pixel_shuffle():
    x = _rand(2, (2, 5, 7, 12))
    want = np.asarray(jl.pixel_shuffle(jnp.asarray(x), 2))
    np.testing.assert_allclose(nhwc(tl.pixel_shuffle(nchw(x), 2)), want, atol=ATOL)


def test_conv_transpose_up_flips_kernel():
    x = _rand(3, (2, 5, 6, 8))
    jm = jl.ConvTransposeUp(4, dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(0), x)
    # distinct taps, so a missing spatial flip shows
    v = {"params": {"convt": {"kernel": _rand(4, (2, 2, 8, 4)),
                              "bias": _rand(5, (4,))}}}
    want = np.asarray(jm.apply(v, x))
    port = _load(tl.ConvTransposeUp(8, 4), v)
    np.testing.assert_allclose(nhwc(port(nchw(x))), want, atol=ATOL)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 6)])
def test_avg_pool_ceil(hw):
    x = _rand(6, (2, *hw, 3))
    want = np.asarray(jl.avg_pool_ceil(jnp.asarray(x), 2))
    np.testing.assert_allclose(nhwc(tl.avg_pool_ceil(nchw(x), 2)), want, atol=ATOL)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_max_pool_torch(hw):
    x = _rand(7, (2, *hw, 3))
    want = np.asarray(jl.max_pool_torch(jnp.asarray(x), 3, 2))
    np.testing.assert_allclose(nhwc(tl.max_pool_torch(nchw(x), 3, 2)), want, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_eval(dtype):
    """Eval BatchNorm with random running stats; in bf16 both sides
    normalize in float32 and round once, so they agree exactly."""
    x = _rand(8, (2, 4, 5, 6))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    bn = fnn.BatchNorm(use_running_average=True, dtype=jdt)
    v = _randomize_stats(bn.init(jax.random.PRNGKey(0), x), 9)
    xj = jnp.asarray(x, jdt)
    want = np.asarray(bn.apply(v, xj).astype(jnp.float32))
    port = tl.BatchNorm(6).eval()
    port.weight.data = torch.from_numpy(v["params"]["scale"])
    port.bias.data = torch.from_numpy(v["params"]["bias"])
    port.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
    port.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    got = port(nchw(np.asarray(xj.astype(jnp.float32))).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(nhwc(got.float()), want, atol=ATOL)


def test_batch_norm_train_mode_is_a_later_slice():
    with pytest.raises(NotImplementedError):
        tl.BatchNorm(3).train()(torch.zeros(1, 3, 2, 2))


def test_folded_stem_conv_layer():
    """The k4-s4 stem conv has padding 0, then BN and ReLU."""
    x = _rand(10, (2, 16, 12, 3))
    jm = jl.ConvLayer(8, 4, 4, pad=((0, 0), (0, 0)), dtype=jnp.float32)
    v = _randomize_stats(jm.init(jax.random.PRNGKey(1), x), 11)
    port = _load(tl.ConvLayer(3, 8, 4, 4, pad=0), v)
    np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(jm.apply(v, x)),
                               atol=ATOL)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_resblock_stride2_idconv(hw):
    """Avg-pool (ceil) BEFORE the identity 1x1 conv."""
    x = _rand(12, (2, *hw, 4))
    jm = jl.ResBlock(1, 8, stride=2, dtype=jnp.float32)
    v = _randomize_stats(jm.init(jax.random.PRNGKey(2), x), 13)
    port = _load(tl.ResBlock(1, 4, 8, stride=2), v)
    np.testing.assert_allclose(nhwc(port(nchw(x))), np.asarray(jm.apply(v, x)),
                               atol=ATOL)


@pytest.mark.parametrize("src,dst", [((8, 8), (7, 7)), ((4, 6), (7, 13))])
def test_resize_nearest(src, dst):
    x = _rand(14, (1, *src, 2))
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 2), "nearest"))
    np.testing.assert_array_equal(nhwc(tl.resize_nearest(nchw(x), dst)), want)
