"""PyTorch port: training-mode BatchNorm against the JAX package on the CPU.

The plain versions of the ``bn_stats`` kernel's two reductions against the
Pallas kernels of ``unet_tpu/ops/pallas_bn.py`` in interpret mode (as
``tests/test_pallas_bn.py`` runs them), and the port's train-mode
``BatchNorm`` (``BatchNormTrain``) against flax ``nn.BatchNorm`` for the
output, the running statistics and the gradients. Inputs come from numpy
seeds; each test states its tolerance.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from unet_tpu.ops import pallas_bn
from unet_tpu_torch.models.layers import BatchNorm
from unet_tpu_torch.ops import bn

torch.set_num_threads(2)

# (C, H·W) of the 43 training BatchNorms of the xresnet34 U-Net at 512²
MODEL_SITES = [(64, 128 * 128, 7), (64, 256 * 256, 1), (128, 64 * 64, 10),
               (128, 128 * 128, 2), (256, 32 * 32, 14), (256, 128 * 128, 1),
               (512, 16 * 16, 8)]


def _nhwc(seed, shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, 3, 1))).to(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sum_sumsq_plain_matches_pallas_interpret(dtype):
    """rtol 1e-5 (float32 sums in another order), atol 1e-3 for the
    near-zero Σx of centred data."""
    x = _nhwc(0, (2, 16, 16, 32), scale=3.0, shift=0.5)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(pallas_bn.sum_and_sumsq(xj.reshape(-1, 32), interpret=True))
    got = bn.bn_sum_sumsq(_nchw(np.asarray(xj.astype(jnp.float32)), getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (2, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_sums_plain_matches_pallas_interpret(dtype):
    """Same tolerances as the forward sums (as tests/test_pallas_bn.py)."""
    x = _nhwc(1, (3, 16, 16, 64))
    g = _nhwc(2, (3, 16, 16, 64))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, gj = jnp.asarray(x, jdt), jnp.asarray(g, jdt)
    x32 = np.asarray(xj.astype(jnp.float32))
    mean = x32.mean(axis=(0, 1, 2))
    inv = 1.0 / np.sqrt(x32.var(axis=(0, 1, 2)) + 1e-5)
    want = np.asarray(pallas_bn.bn_bwd_sums(gj.reshape(-1, 64), xj.reshape(-1, 64),
                                            jnp.asarray(mean), jnp.asarray(inv),
                                            interpret=True))
    got = bn.bn_bwd_sums(_nchw(np.asarray(gj.astype(jnp.float32)), tdt), _nchw(x32, tdt),
                         torch.from_numpy(mean), torch.from_numpy(inv.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", [(3, 3, 37, 41), (1, 1, 5, 7), (2, 5, 1, 1)])
def test_plain_sums_on_ragged_shapes_match_float64(shape):
    """Any N, C, H, W (C down to 1, odd N·H·W): within 1e-6 of the float64
    sums, relative to Σ|x| and Σ|dy·x̂|."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    s = bn.bn_sum_sumsq(torch.from_numpy(x)).numpy()
    x64 = x.astype(np.float64)
    np.testing.assert_array_less(np.abs(s[0] - x64.sum((0, 2, 3))),
                                 1e-6 * np.abs(x64).sum((0, 2, 3)) + 1e-30)
    np.testing.assert_array_less(np.abs(s[1] - (x64 ** 2).sum((0, 2, 3))),
                                 1e-6 * (x64 ** 2).sum((0, 2, 3)) + 1e-30)
    mean = x64.mean((0, 2, 3))
    inv = 1 / np.sqrt(x64.var((0, 2, 3)) + 1e-5)
    b = bn.bn_bwd_sums(torch.from_numpy(g), torch.from_numpy(x),
                       torch.from_numpy(mean.astype(np.float32)),
                       torch.from_numpy(inv.astype(np.float32))).numpy()
    xhat = (x64 - mean.reshape(1, -1, 1, 1)) * inv.reshape(1, -1, 1, 1)
    gx = g.astype(np.float64) * xhat
    np.testing.assert_array_less(np.abs(b[1] - gx.sum((0, 2, 3))),
                                 1e-6 * np.abs(gx).sum((0, 2, 3)) + 1e-30)


@pytest.mark.parametrize("n,c,h,w", [(16, c, int(hw ** .5), int(hw ** .5))
                                     for c, hw, _ in MODEL_SITES]
                         + [(3, 3, 37, 37), (16, 1, 511, 511)])
@pytest.mark.parametrize("element_size", [2, 4])
def test_launch_grid_covers_every_value(n, c, h, w, element_size):
    """The kernel's (C, S) grid: S·chunk packs cover N·H·W/V, every block
    has work, S fits gridDim.y, and 16-byte loads only where H·W allows."""
    for sms in (132, 114, 1):  # H100 SXM, H100 PCIe, a lone SM
        vec, s, chunk = bn.launch_grid((n, c, h, w), element_size, True, sms)
        packs = n * h * w // vec
        assert vec in (1, 16 // element_size)
        assert (h * w) % vec == 0 and (vec == 1) == ((h * w) % (16 // element_size) != 0)
        assert 1 <= s <= 65535 and s * chunk >= packs > (s - 1) * chunk
        assert bn.launch_grid((n, c, h, w), element_size, False, sms)[0] == 1


def _flax_bn(dtype, x, scale, bias, mean0, var0):
    m = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                      dtype=dtype, param_dtype=jnp.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
         "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    return m, v


def _port_bn(scale, bias, mean0, var0):
    port = BatchNorm(scale.shape[0]).train()
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(scale))
        port.bias.copy_(torch.from_numpy(bias))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    return port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batch_norm_matches_flax(dtype):
    """y and the updated batch_stats: float32 within 1e-5; in bf16 y
    within one bf16 ulp (the float32 statistics are summed in another
    order, so a rounding can land on the other side), the statistics
    within 1e-5."""
    rng = np.random.default_rng(4)
    x = _nhwc(5, (4, 6, 7, 16), scale=2.0, shift=0.3)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(0, 0.2, 16).astype(np.float32)
    mean0 = rng.normal(0, 0.2, 16).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x, jdt)
    m, v = _flax_bn(jdt, xj, scale, bias, mean0, var0)
    want, upd = m.apply(v, xj, mutable=["batch_stats"])
    port = _port_bn(scale, bias, mean0, var0)
    got = port(_nchw(np.asarray(xj.astype(jnp.float32)), tdt))
    assert got.dtype == tdt
    got = np.moveaxis(got.float().detach().numpy(), 1, 3)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp)
        assert np.mean(got == want) > 0.99
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("reference", ["flax", "pallas"])
def test_train_batch_norm_gradients_match_jax(reference):
    """dx, dscale, dbias of Σ(y·w) at float32 against jax.grad through
    flax's BatchNorm and through the Pallas custom VJP (interpret mode):
    rtol 1e-4, atol 1e-5·max|grad| (float32 sums in another order)."""
    rng = np.random.default_rng(6)
    x = _nhwc(7, (2, 8, 16, 32))
    w = _nhwc(8, (2, 8, 16, 32))
    scale = (1 + 0.1 * rng.normal(size=32)).astype(np.float32)
    bias = (0.1 * rng.normal(size=32)).astype(np.float32)

    if reference == "flax":
        m, v = _flax_bn(jnp.float32, x, scale, bias, np.zeros(32, np.float32),
                        np.ones(32, np.float32))

        def loss(xx, s, b):
            vv = {"params": {"scale": s, "bias": b}, "batch_stats": v["batch_stats"]}
            y, _ = m.apply(vv, xx, mutable=["batch_stats"])
            return jnp.sum(y * w)
    else:
        def loss(xx, s, b):
            y, _, _ = pallas_bn.batch_norm_train(xx, s, b, 1e-5, jnp.float32, True)
            return jnp.sum(y * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                             jnp.asarray(bias))
    port = _port_bn(scale, bias, np.zeros(32, np.float32), np.ones(32, np.float32))
    xt = _nchw(x).requires_grad_(True)
    (port(xt) * _nchw(w)).sum().backward()
    got = (np.moveaxis(xt.grad.numpy(), 1, 3), port.weight.grad.numpy(),
           port.bias.grad.numpy())
    assert xt.grad.dtype == torch.float32 and port.weight.grad.dtype == torch.float32
    for g, want_g, name in zip(got, want, ("dx", "dscale", "dbias")):
        want_g = np.asarray(want_g)
        np.testing.assert_allclose(g, want_g, rtol=1e-4,
                                   atol=1e-5 * np.abs(want_g).max(), err_msg=name)


def test_bf16_gradient_leaves_in_input_dtype():
    port = _port_bn(np.ones(4, np.float32), np.zeros(4, np.float32),
                    np.zeros(4, np.float32), np.ones(4, np.float32))
    x = torch.randn(2, 4, 3, 5, generator=torch.Generator().manual_seed(0))
    x = x.to(torch.bfloat16).requires_grad_(True)
    port(x).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert port.weight.grad.dtype == torch.float32 and port.bias.grad.dtype == torch.float32


def test_running_var_is_the_biased_batch_variance():
    """flax's update, not nn.BatchNorm2d's: at n = 2·3·3 = 18 values per
    channel the unbiased variance is 18/17 of the biased one."""
    x = torch.from_numpy(_nhwc(9, (2, 3, 3, 5))).permute(0, 3, 1, 2).contiguous()
    port = _port_bn(np.ones(5, np.float32), np.zeros(5, np.float32),
                    np.zeros(5, np.float32), np.ones(5, np.float32))
    port(x)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(port.running_var, 0.9 + 0.1 * biased, rtol=1e-5, atol=1e-6)
    ref = torch.nn.BatchNorm2d(5).train()
    ref(x)
    assert not torch.allclose(port.running_var, ref.running_var, rtol=1e-4, atol=0)


def test_cpu_tensors_never_count_kernel_launches():
    before = (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches)
    port = _port_bn(np.ones(3, np.float32), np.zeros(3, np.float32),
                    np.zeros(3, np.float32), np.ones(3, np.float32))
    x = torch.randn(2, 3, 4, 4, requires_grad=True)
    port(x).sum().backward()
    assert (bn.bn_sum_sumsq.launches, bn.bn_bwd_sums.launches) == before
    assert port.reductions is bn.KERNEL_REDUCTIONS
