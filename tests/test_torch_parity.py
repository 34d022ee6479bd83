"""PyTorch port: the parity topology and SelfAttention against the JAX
package on the CPU.

PixelShuffle-ICNR (blur on and off), the replication
blur, SelfAttention with spectral norm in eval and training mode, and the
parity U-Net's logits over a small matrix of architectures, tile sizes,
heads, bands and self-attention, plus tpu_opt with self-attention. Inputs
and weights are made with numpy from seeds and carried across with
``from_flax_variables``. Float32 throughout; logits within rtol 1e-4 and
atol 1e-4·max|JAX| (convolutions sum in another order than XLA's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.models import layers as jl
from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.models import layers as tl
from unet_tpu_torch.models.unet import decoder_widths
from unet_tpu_torch.models.xresnet import stage_out_channels
from unet_tpu_torch.train.checkpoint import from_flax_variables, to_flax_variables

torch.set_num_threads(2)


def random_leaf(name, shape, rng):
    """A float32 value for the flax leaf ``name`` of ``shape``: He-normal
    conv kernels, lecun-normal attention kernels, unit-norm u vectors, γ =
    0.5 (0 would make the attention an identity), and BatchNorm and bias
    values away from their init so that every branch carries signal."""
    if name == "kernel":
        return rng.normal(0, np.sqrt(2.0 / np.prod(shape[:-1])), shape)
    if name.endswith("_kernel"):
        return rng.normal(0, 1 / np.sqrt(shape[0]), shape)
    if name.endswith("_u"):
        u = rng.normal(size=shape)
        return u / np.linalg.norm(u)
    if name == "gamma":
        return np.full(shape, 0.5)
    if name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    if name in ("mean", "bias"):
        return rng.normal(0, 0.2, shape)
    raise KeyError(name)


def jax_variables(jax_model, x, rng, **kwargs):
    """Random weights for ``jax_model`` on input ``x`` (NHWC), made with
    numpy over the structure of its init (``jax.eval_shape``: no compute);
    ``kwargs`` go to the init call."""
    shapes = jax.eval_shape(lambda k: jax_model.init(k, x, **kwargs),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: random_leaf(path[-1].key, s.shape, rng).astype(np.float32), shapes)


def port_model(v, **kwargs):
    """The port's float32 U-Net with the flax variables ``v``."""
    model = build_unet(dtype=torch.float32, **kwargs)
    model.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in from_flax_variables(v).items()}, strict=True)
    return model


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_replication_blur_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 7, 9, 5)).astype(np.float32)
    want = np.asarray(jl.replication_blur(jnp.asarray(x)))
    got = tl.replication_blur(nchw(x))
    assert got.shape == (2, 5, 7, 9)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("blur", [False, True])
@pytest.mark.parametrize("hw", [(5, 6), (7, 9)])
def test_pixel_shuffle_icnr_matches_jax(blur, hw):
    """1x1 conv + shuffle + ReLU [+ blur] gives JAX's transposed-conv
    formulation's function: rtol 1e-5 and atol 1e-5 (float32 sums of 6
    products in another order)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    mod = jl.PixelShuffleICNR(4, blur=blur, dtype=jnp.float32)
    v = jax_variables(mod, x, rng)
    want = np.asarray(mod.apply(v, x))
    port = tl.PixelShuffleICNR(6, 4, blur=blur)
    port.load_state_dict({k: torch.from_numpy(a) for k, a in from_flax_variables(v).items()})
    with torch.no_grad():
        got = port(nchw(x))
    assert got.shape == (2, 4, 2 * hw[0], 2 * hw[1])
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_self_attention_matches_jax(train):
    """γ = 0.5; outputs within rtol 1e-5 and atol 1e-5·max|JAX|; in training
    mode the power iteration's new u within 1e-6 of JAX's new batch_stats,
    and eval mode leaves u as it was."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 6, 24)).astype(np.float32)
    mod = jl.SelfAttention(dtype=jnp.float32)
    v = jax_variables(mod, x, rng)
    port = tl.SelfAttention(24).train(train)
    port.load_state_dict({k: torch.from_numpy(a) for k, a in from_flax_variables(v).items()})
    if train:
        want, upd = mod.apply(v, x, train=True, mutable=["batch_stats"])
    else:
        want, upd = mod.apply(v, x, train=False), {"batch_stats": v["batch_stats"]}
    with torch.no_grad():
        got = port(nchw(x))
    want = np.asarray(want)
    np.testing.assert_allclose(nhwc(got), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert np.abs(want - x).max() > 1e-2  # the attention changed the tokens
    stats = to_flax_variables(port.state_dict())["batch_stats"]
    for name in ("query_u", "key_u", "value_u"):
        np.testing.assert_allclose(stats[name], np.asarray(upd["batch_stats"][name]),
                                   rtol=0, atol=1e-6, err_msg=name)
        moved = not np.allclose(stats[name], v["batch_stats"][name], rtol=0, atol=1e-6)
        assert moved == train, name


def test_self_attention_u_vectors_are_buffers():
    sa = tl.SelfAttention(16)
    assert sorted(n for n, _ in sa.named_parameters()) == [
        "gamma", "key_kernel", "query_kernel", "value_kernel"]
    assert sorted(sa.state_dict()) == sorted(
        ["gamma", "key_kernel", "query_kernel", "value_kernel", "key_u", "query_u", "value_u"])
    assert sa.query_kernel.shape == (16, 2) and sa.value_u.shape == (16,)


@pytest.mark.parametrize("arch,size,sa,n_out,c_in", [
    ("xresnet18", 50, False, 3, 3),   # odd encoder grids: 25 → 13 → 26 resizes
    ("xresnet18", 64, True, 1, 4),
    ("xresnet34", 64, True, 3, 3),
    ("xresnet50", 32, False, 3, 3),
])
def test_parity_logits_match_jax(arch, size, sa, n_out, c_in):
    rng = np.random.default_rng(size + n_out)
    x = rng.uniform(0, 1, (2, size, size, c_in)).astype(np.float32)
    jm = jax_build_unet(arch, n_out=n_out, c_in=c_in, self_attention=sa,
                        dtype=jnp.float32, tpu_opt=False)
    v = jax_variables(jm, x, rng, train=False)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, x))
    tm = port_model(v, arch=arch, n_out=n_out, c_in=c_in, self_attention=sa, tpu_opt=False)
    with torch.no_grad():
        got = tm(nchw(x))
        folded = tm(nchw(x), fold_logits=True)  # parity ignores fold_logits
    assert got.dtype == torch.float32 and got.shape == (2, n_out, size, size)
    assert torch.equal(got, folded)
    close(nhwc(got), want)


def test_tpu_opt_with_self_attention_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = jax_build_unet("xresnet18", n_out=3, c_in=3, self_attention=True,
                        dtype=jnp.float32, tpu_opt=True)
    v = jax_variables(jm, x, rng, train=False)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False, fold_logits=True))(v, x))
    tm = port_model(v, arch="xresnet18", n_out=3, c_in=3, self_attention=True, tpu_opt=True)
    assert tm.up_1.sa is not None
    with torch.no_grad():
        got = tm(nchw(x), fold_logits=True)
    assert got.shape == (2, 12, 32, 32)
    close(nhwc(got), want)


def test_parity_widths_follow_the_fastai_walk():
    """xresnet34: the decoder blocks come out 512 → 384 → 256 → 96, the
    last_cross ResBlock takes 99 channels at 3 bands."""
    stages = stage_out_channels("xresnet34")
    widths = decoder_widths(list(reversed(stages[:-1])) + [64], stages[-1], 3, tpu_opt=False)
    assert [w[3] for w in widths] == [512, 384, 256, 96]
    assert [w[2] for w in widths] == [256, 256, 192, 128]
    m = build_unet("xresnet34", n_out=3, c_in=3, self_attention=True, tpu_opt=False)
    keys = set(m.state_dict())
    for k in ("up_1.sa.query_kernel", "up_1.sa.value_u", "up_3.shuf.conv.weight",
              "final_shuf.conv.bias", "last_cross.conv1.conv.weight", "up_3.conv2.conv.weight"):
        assert k in keys, k
    assert m.last_cross.conv1.conv.weight.shape[:2] == (99, 99)
    assert m.head.weight.shape[:2] == (3, 99)
    assert m.up_0.shuf.blur and m.up_3.shuf.blur and not m.final_shuf.blur
    assert not any(k.startswith(("up_0.sa", "up_2.sa", "up_3.sa")) for k in keys)


def test_parity_tree_matches_jax_init_structure():
    """The port's state_dict maps onto exactly the tree (paths, shapes) of
    the JAX init, SelfAttention's params and batch_stats included."""
    x = np.zeros((1, 64, 64, 4), np.float32)
    jm = jax_build_unet("xresnet34", n_out=2, c_in=4, self_attention=True, tpu_opt=False)
    shapes = jax.eval_shape(lambda k: jm.init(k, x, train=False), jax.random.PRNGKey(0))
    m = build_unet("xresnet34", n_out=2, c_in=4, self_attention=True, tpu_opt=False)
    got = to_flax_variables(m.state_dict())
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(shapes)
    for (path, a), (_, s) in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                 jax.tree_util.tree_flatten_with_path(shapes)[0]):
        assert a.shape == s.shape and a.dtype == s.dtype, jax.tree_util.keystr(path)


def test_init_weights_icnr_and_attention():
    """ICNR: the four sub-kernels of each shuffle output channel are equal;
    γ = 0; u vectors of unit norm; lecun-scale attention kernels."""
    m = build_unet("xresnet18", n_out=3, c_in=3, self_attention=True, tpu_opt=False)
    init_weights(m, torch.Generator().manual_seed(0))
    for mod in (m.up_0.shuf, m.up_3.shuf, m.final_shuf):
        w = mod.conv.weight.detach().view(-1, 4, mod.conv.weight.shape[1])
        assert torch.equal(w, w[:, :1].expand_as(w)) and float(w.abs().max()) > 0
        assert not mod.conv.bias.any()
    sa = m.up_1.sa
    assert float(sa.gamma.detach()) == 0.0
    for name in ("query", "key", "value"):
        assert abs(float(getattr(sa, f"{name}_u").norm()) - 1) < 1e-6
    std = float(sa.value_kernel.detach().std()) * sa.value_kernel.shape[0] ** 0.5
    assert 0.8 < std < 1.2
