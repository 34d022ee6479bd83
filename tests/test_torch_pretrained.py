"""PyTorch port: pretrained xresnet encoders against the JAX package on
the CPU.

A fastai-named xresnet18 ``.pth`` (the torch replica of
``tests/test_torch_import.py``, seeded, its BatchNorms moved off their
init) is grafted into the same U-Net variables by the port's and by JAX's
``load_encoder_any``: bit-equal in both topologies, the tpu_opt folded
stem (and a multispectral parity stem conv) keeping their init. The
``.npz`` of ``import-weights`` crosses between the packages both ways; an
arch mismatch raises in both; the port's CLI converts on the CPU; and the
port's trainer starts from the grafted encoder, as JAX's does.
"""

import functools

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax

from test_torch_import import torch_xresnet18_body
from unet_tpu.models import torch_import as jti
from unet_tpu.train import loop as jax_loop
from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.geo import write_raster
from unet_tpu_torch.models import build_unet, init_weights
from unet_tpu_torch.models import torch_import as tti
from unet_tpu_torch.train import loop
from unet_tpu_torch.train.checkpoint import to_flax_variables

torch.set_num_threads(2)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The replica's .pth, the JAX package's .npz of it and the port's."""
    root = tmp_path_factory.mktemp("pretrained")
    torch.manual_seed(3)
    body = torch_xresnet18_body()
    with torch.no_grad():
        for m in body.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.1)
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    pth = root / "xresnet18.pth"
    torch.save(body.state_dict(), pth)
    jti.import_weights_cli(str(pth), str(root / "jax.npz"), arch="xresnet18")
    assert cli(["import-weights", str(pth), "--arch", "xresnet18",
                "-o", str(root / "port.npz")]) == 0
    sd = {k: v.numpy() for k, v in body.state_dict().items()}
    return {"root": root, "pth": pth, "jax_npz": root / "jax.npz",
            "port_npz": root / "port.npz", "sd": sd}


@functools.lru_cache(maxsize=None)
def _variables(tpu_opt, c_in=3):
    """The port's init of the xresnet18 U-Net as flax variables (shared by
    the cases: the grafts must leave it untouched)."""
    model = init_weights(build_unet("xresnet18", n_out=3, c_in=c_in, tpu_opt=tpu_opt),
                         torch.Generator().manual_seed(1))
    return to_flax_variables(model.state_dict())


@pytest.mark.parametrize("tpu_opt,c_in", [(True, 3), (False, 3), (False, 4)],
                         ids=["tpu_opt", "parity", "parity-4-band"])
@pytest.mark.parametrize("source", ["pth", "jax_npz", "port_npz"])
def test_graft_bit_equal_to_jax(weights, tpu_opt, c_in, source):
    """Both packages graft into copies of the same variables, leaf for
    leaf; the source's tensors land as they are where the shapes match;
    mismatched stem layers (tpu_opt's whole folded stem, a 4-band stem_0
    conv) keep the init; the input tree is not modified."""
    v = _variables(tpu_opt, c_in)
    before = {p: a.copy() for p, a in _leaves(v)}
    got = tti.load_encoder_any(v, str(weights[source]), "xresnet18")
    want = jti.load_encoder_any(v, str(weights[source]), "xresnet18")
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys() == before.keys()
    differ = [p for p in want_l if got_l[p].dtype != want_l[p].dtype
              or not np.array_equal(got_l[p], want_l[p])]
    assert not differ, differ
    now = dict(_leaves(v))
    assert all(np.array_equal(now[p], a) for p, a in before.items())  # input untouched
    src_p, src_s = tti.convert_xresnet_state_dict(weights["sd"], "xresnet18")
    grafted = kept = 0
    for kind, src in (("params", src_p), ("batch_stats", src_s)):
        for p, a in _leaves(src):
            path = (kind, "encoder") + p
            if got_l[path].shape == a.shape:
                assert np.array_equal(got_l[path], a), path
                grafted += 1
            else:
                assert p[0].startswith("stem_")
                assert np.array_equal(got_l[path], before[path]), path
                kept += 1
    assert grafted > 90 and kept == {(True, 3): 15, (False, 3): 0, (False, 4): 1}[tpu_opt, c_in]


def test_npz_crosses_between_the_packages(weights):
    """The JAX-written archive read by the port and the port-written one
    read by JAX: the same arch and arrays; both equal the conversion of
    the .pth."""
    src_p, src_s = tti.convert_xresnet_state_dict(weights["sd"], "xresnet18")
    for reader, path in ((tti.load_converted, weights["jax_npz"]),
                         (jti.load_converted, weights["port_npz"])):
        p, s, arch = reader(str(path))
        assert arch == "xresnet18"
        for got, want in ((p, src_p), (s, src_s)):
            got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
            assert got_l.keys() == want_l.keys()
            for k in want_l:
                np.testing.assert_array_equal(got_l[k], want_l[k])
    with np.load(weights["port_npz"]) as zp, np.load(weights["jax_npz"]) as zj:
        assert sorted(zp.files) == sorted(zj.files)


def test_arch_mismatch_raises_in_both(weights):
    v = _variables(True)
    for load in (tti.load_encoder_any, jti.load_encoder_any):
        with pytest.raises(ValueError, match="are for xresnet18, model is xresnet34"):
            load(v, str(weights["port_npz"]), "xresnet34")


def test_import_weights_cli_default_output_name(weights, tmp_path):
    pth = tmp_path / "enc.pth"
    pth.write_bytes(weights["pth"].read_bytes())
    assert cli(["import-weights", str(pth), "--arch", "xresnet18"]) == 0
    assert (tmp_path / "enc.npz").is_file()
    assert tti.load_converted(str(tmp_path / "enc.npz"))[2] == "xresnet18"


def test_trainer_starts_from_the_grafted_encoder_as_jax(weights, tmp_path):
    """``pretrained_weights`` in both trainers (tpu_opt, 32² tiles): the
    residual stages of their starting variables are the source's in both,
    bit for bit; the folded stem is each package's own init."""
    rng = np.random.default_rng(0)
    for scene, n in (("trai", 4), ("vali", 2)):
        for sub in ("img_tiles", "mask_tiles"):
            (tmp_path / scene / sub).mkdir(parents=True)
        for i in range(n):
            for sub, a in (("img_tiles", rng.integers(0, 256, (3, 32, 32))),
                           ("mask_tiles", rng.integers(0, 3, (1, 32, 32)))):
                write_raster(tmp_path / scene / sub / f"{i}.tif", a.astype(np.uint8),
                             transform=(0.0, 1.0, 0.0, 0.0, 0.0, -1.0), crs="EPSG:25832")
    kw = dict(data_path=tmp_path, codes=("a", "b", "c"), arch="xresnet18", batch_size=2,
              pretrained_weights=str(weights["port_npz"]), loader_threads=4)
    jt = jax_loop.Trainer(jax_loop.TrainerConfig(**kw))
    t = loop.Trainer(loop.TrainerConfig(device="cpu", **kw))
    try:
        want = jax.tree_util.tree_map(np.asarray, jt.init_variables())
        t.init_state()
        got = to_flax_variables(t.model.state_dict())
    finally:
        t.close()
        jt.close()
    n = 0
    for kind in ("params", "batch_stats"):
        want_l = dict(_leaves(want[kind]["encoder"]))
        for p, a in _leaves(got[kind]["encoder"]):
            if not p[0].startswith("stem_"):
                np.testing.assert_array_equal(a, want_l[p], err_msg=str(p))
                n += 1
    assert n > 90
