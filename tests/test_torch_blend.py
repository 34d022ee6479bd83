"""PyTorch port: the blend (mosaic accumulation) against the JAX package,
exactly — both sides add the tiles in the same order in float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unet_tpu.ops import blend as jblend
from unet_tpu_torch.ops import _build
from unet_tpu_torch.ops import blend as tblend

torch.set_num_threads(2)


def _case(seed, n=6, h=40, w=52, c=3, th=16, tw=16):
    """Overlapping tiles plus the four edge-aligned corners."""
    rng = np.random.default_rng(seed)
    tiles = rng.normal(size=(n, th, tw, c)).astype(np.float32)
    rows = np.concatenate([[0, h - th, 0, h - th],
                           rng.integers(0, h - th + 1, n - 4)]).astype(np.int32)
    cols = np.concatenate([[0, 0, w - tw, w - tw],
                           rng.integers(0, w - tw + 1, n - 4)]).astype(np.int32)
    base = rng.normal(size=(h, w, c)).astype(np.float32)
    return tiles, rows, cols, base


def _port(tiles, rows, cols, base):
    m = torch.from_numpy(np.ascontiguousarray(np.moveaxis(base, 2, 0)))
    cnt = torch.zeros(base.shape[:2])
    t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(tiles, 3, 1)))
    tblend.blend_and_count_reference(m, cnt, t, rows, cols)
    return np.moveaxis(m.numpy(), 0, 2), cnt.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_equals_jax_blend_and_count(seed):
    tiles, rows, cols, base = _case(seed)
    n, th, tw, c = tiles.shape
    h, w, _ = base.shape
    buf, cnt = jblend.blend_and_count(
        jnp.asarray(base.reshape(h, w * c)), jnp.zeros((h, w), jnp.float32),
        jnp.asarray(tiles.reshape(n, th, tw * c)), jnp.asarray(rows),
        jnp.asarray(cols), th, tw)
    m, k = _port(tiles, rows, cols, base)
    np.testing.assert_array_equal(m, np.asarray(buf).reshape(h, w, c))
    np.testing.assert_array_equal(k, np.asarray(cnt))


def test_reference_equals_pallas_blend_tiles_interpret():
    tiles, rows, cols, base = _case(2)
    want = np.asarray(jblend.blend_tiles(jnp.asarray(base), jnp.asarray(tiles),
                                         jnp.asarray(rows), jnp.asarray(cols),
                                         interpret=True))
    m, _ = _port(tiles, rows, cols, base)
    np.testing.assert_array_equal(m, want)


def test_device_mosaic_matches_jax_with_ragged_batch():
    """Two full batches and a ragged last one; finalize crops like the JAX
    DeviceMosaic (which pads its buffers to whole tiles)."""
    h, w, c, th = 50, 70, 3, 16
    rng = np.random.default_rng(3)
    jm = jblend.DeviceMosaic(h, w, c, use_pallas=False)
    tm = tblend.DeviceMosaic(h, w, c, device="cpu")
    for n in (4, 4, 3):
        probs = rng.uniform(size=(n, th, th, c)).astype(np.float32)
        rows = rng.integers(0, h - th + 1, n)
        cols = rng.integers(0, w - th + 1, n)
        jm.add_batch(jnp.asarray(probs.reshape(n, th, th * c)), rows, cols)
        tm.add_batch(torch.from_numpy(np.ascontiguousarray(np.moveaxis(probs, 3, 1))),
                     rows, cols)
    js, jc = jm.finalize()
    ts, tc = tm.finalize()
    assert ts.shape == (c, h, w) and tc.shape == (h, w)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(tc, jc)


def test_kernel_binding_refuses_cpu_tensors():
    """The CUDA binding never runs the plain version for CPU tensors."""
    before = tblend.blend_and_count.launches
    m, cnt = torch.zeros(3, 20, 20), torch.zeros(20, 20)
    with pytest.raises(ValueError, match="not CUDA"):
        tblend.blend_and_count(m, cnt, torch.ones(1, 3, 8, 8), [0], [0])
    assert tblend.blend_and_count.launches == before
    assert not m.any() and not cnt.any()


@pytest.mark.parametrize("rows,cols", [([13], [0]), ([0], [-1]), ([0, 0], [0])])
def test_bad_offsets_raise(rows, cols):
    m, cnt = torch.zeros(3, 20, 20), torch.zeros(20, 20)
    with pytest.raises(ValueError):
        tblend.blend_and_count_reference(m, cnt, torch.ones(1, 3, 8, 8), rows, cols)


def test_device_mosaic_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tblend.DeviceMosaic(8, 8, 2)
    assert tblend.DeviceMosaic(8, 8, 2, device="cpu").blend \
        is tblend.blend_and_count_reference


def test_mosaic_larger_than_free_card_memory_is_not_yet_ported():
    """A 16384² 3-class mosaic (4 GiB) fits exactly that much free memory
    and raises one byte short, naming the host merge; it never moves to the
    host instead. (Serving takes the banded mosaic there; only the device
    merge needs the whole mosaic.)"""
    nbytes = tblend.mosaic_bytes(16384, 16384, 3)
    assert nbytes == 4 << 30
    tblend.check_mosaic_fits(nbytes, nbytes)
    with pytest.raises(RuntimeError, match="merge on the host"):
        tblend.check_mosaic_fits(nbytes, nbytes - 1)


def test_build_reuses_cached_library_unless_forced(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    fake = tmp_path / "nvcc"
    # the fake compiler writes its -o argument and logs each call
    fake.write_text(f'#!/bin/sh\necho x >> {calls}\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build("blend_count")
    assert _build.build("blend_count") == first == _build.library_path("blend_count")
    assert len(calls.read_text().split()) == 1
    _build.build("blend_count", force=True)
    assert len(calls.read_text().split()) == 2


def test_failed_build_raises_with_nvcc_stderr(tmp_path, monkeypatch):
    """A failed nvcc run raises; nothing falls back to the plain version."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'nvcc: fake failure' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake failure"):
        _build.build("blend_count")


def test_library_name_follows_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", src)
    first = _build.library_path("k")
    (src / "k.cu").write_text("// v2\n")
    assert _build.library_path("k") != first

