"""PyTorch port: the msgpack codec and model bundles against flax/JAX."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import msgpack
from flax import serialization

from unet_tpu.models import build_unet as jax_build_unet
from unet_tpu.models.unet import TPU_OPT_TOPOLOGY_VERSION as JAX_TOPOLOGY
from unet_tpu.train import checkpoint as jax_ckpt
from unet_tpu_torch.io import msgpack_codec
from unet_tpu_torch.models import TPU_OPT_TOPOLOGY_VERSION
from unet_tpu_torch.train import checkpoint

torch.set_num_threads(2)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _assert_same_tree(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        x, y = np.asarray(la[k]), np.asarray(lb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=str(k))


def _tree(rng):
    return {
        "params": {
            "conv": {"kernel": rng.normal(size=(3, 3, 4, 8)).astype(np.float32),
                     "bias": rng.normal(size=(8,)).astype(np.float32)},
            "misc": {"h": rng.normal(size=(5,)).astype(np.float16),
                     "i": rng.integers(-9, 9, size=(2, 3)).astype(np.int32),
                     "u": rng.integers(0, 255, size=(7,)).astype(np.uint8),
                     "b": np.array([True, False]),
                     "e": np.zeros((0, 4), np.float32)},
        },
        "batch_stats": {"bn": {"mean": np.float32(0.25), "var": np.int64(-3)}},
    }


def test_codec_decodes_flax_bytes():
    tree = _tree(np.random.default_rng(0))
    data = serialization.to_bytes(tree)
    _assert_same_tree(msgpack_codec.restore(data), tree)


def test_codec_encoding_read_by_flax():
    tree = _tree(np.random.default_rng(1))
    data = msgpack_codec.serialize(tree)
    _assert_same_tree(serialization.msgpack_restore(data), tree)
    assert data == serialization.to_bytes(tree)


def test_codec_widens_bfloat16():
    x = np.random.default_rng(2).normal(size=(4, 3)).astype(jnp.bfloat16)
    back = msgpack_codec.restore(serialization.to_bytes({"x": x}))["x"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, x.astype(np.float32))


@pytest.mark.parametrize("obj", [
    None, True, 0, 127, 128, 65536, 2 ** 40, -1, -33, -200, -40000, -2 ** 40,
    1.5, "", "x" * 31, "x" * 40, "x" * 70000, b"y" * 300, [1] * 16,
    {str(i): i for i in range(16)},
])
def test_codec_scalars_match_msgpack(obj):
    packed = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_codec.packb(obj) == packed
    assert msgpack_codec.unpackb(packed) == obj


def test_codec_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_codec, "MAX_CHUNK_SIZE", 64)
    tree = {"w": np.arange(100, dtype=np.float32).reshape(4, 25),
            "small": np.ones(3, np.float32)}
    flax_bytes = serialization.msgpack_serialize(dict(tree), in_place=True)
    _assert_same_tree(msgpack_codec.restore(flax_bytes), tree)
    mine = msgpack_codec.serialize(tree)
    assert mine == flax_bytes
    _assert_same_tree(serialization.msgpack_restore(mine), tree)


def test_codec_rejects_truncated_data():
    data = msgpack_codec.serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError):
        msgpack_codec.restore(data[:-3])


def test_topology_constant_pinned():
    assert TPU_OPT_TOPOLOGY_VERSION == JAX_TOPOLOGY


def _manifest(**over):
    m = {"ARCHITECTURE": "xresnet18", "n_out": 3, "number_of_bands": 3,
         "patch_size": 64, "enable_regression": False, "dtype_str": "uint8",
         "normalize": "unit", "self_attention": False, "tpu_opt": True,
         "tpu_opt_topology": JAX_TOPOLOGY}
    m.update(over)
    return m


@pytest.fixture(scope="module")
def jax_variables():
    model = jax_build_unet("xresnet18", n_out=3, c_in=3, dtype=jnp.float32,
                           tpu_opt=True)
    v = model.init(jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32),
                   train=False)
    return jax.tree_util.tree_map(np.asarray, v)


def test_bundle_round_trip(tmp_path, jax_variables):
    """JAX export_bundle → port load_bundle → port export_bundle gives the
    same weights leaf for leaf, readable by the JAX loader."""
    jax_ckpt.export_bundle(tmp_path / "j", "j", jax_variables, _manifest())
    model, manifest = checkpoint.load_bundle(tmp_path / "j", dtype=torch.float32)
    assert manifest["ARCHITECTURE"] == "xresnet18"
    out = checkpoint.to_flax_variables(model.state_dict())
    checkpoint.export_bundle(tmp_path / "p", "p", out, manifest)
    restored = serialization.msgpack_restore((tmp_path / "p" / "p.msgpack").read_bytes())
    _assert_same_tree(restored, serialization.msgpack_restore(
        (tmp_path / "j" / "j.msgpack").read_bytes()))
    _, jvars, jman = jax_ckpt.load_bundle(tmp_path / "p")
    _assert_same_tree(jax.tree_util.tree_map(np.asarray, jvars), jax_variables)
    assert jman == manifest


def test_bundle_paths_match_jax(tmp_path):
    (tmp_path / "m").mkdir()
    for ref in (tmp_path / "m", tmp_path / "m" / "m.json",
                tmp_path / "m" / "m.pkl"):
        assert checkpoint.bundle_paths(ref) == jax_ckpt.bundle_paths(ref)


def test_topology_guard_raises_on_v2(tmp_path, jax_variables):
    jax_ckpt.export_bundle(tmp_path / "old", "old", jax_variables,
                           _manifest(tpu_opt_topology=2))
    with pytest.raises(ValueError, match="topology v2"):
        checkpoint.load_bundle(tmp_path / "old")


def test_parity_bundle_is_a_later_slice(tmp_path):
    """Parity bundles, once a later slice, now load: a JAX-written parity +
    self-attention bundle (no topology version, as JAX writes it) gives the
    port's parity model, and its weights come back leaf for leaf."""
    from test_torch_parity import jax_variables

    x = np.zeros((1, 64, 64, 3), np.float32)
    jm = jax_build_unet("xresnet18", n_out=3, c_in=3, self_attention=True, tpu_opt=False)
    v = jax_variables(jm, x, np.random.default_rng(0), train=False)
    jax_ckpt.export_bundle(tmp_path / "par", "par", v,
                           _manifest(tpu_opt=False, tpu_opt_topology=None,
                                     self_attention=True))
    model, manifest = checkpoint.load_bundle(tmp_path / "par", dtype=torch.float32)
    assert not model.tpu_opt and model.up_1.sa is not None and not model.training
    _assert_same_tree(checkpoint.to_flax_variables(model.state_dict()), v)
