"""PyTorch port: the offset-copy kernel's plain version against the JAX
package's probe kernel (Pallas, interpreted on the CPU), and the capability
check's refusal to run without a card."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from unet_tpu_torch.ops import _build, probe

torch.set_num_threads(2)


def _probe_kernel(off_ref, src_ref, out_ref, scratch, sem):
    # verbatim copy of the closure at unet_tpu/ops/probe.py:136-141 (a
    # closure inside _probe_scalar_prefetch_dma, so it cannot be imported)
    dma = pltpu.make_async_copy(
        src_ref.at[pl.ds(off_ref[0] * 8, 8), :], scratch, sem)
    dma.start()
    dma.wait()
    out_ref[:] = scratch[:]


def _jax_probe(x: np.ndarray, off: int) -> np.ndarray:
    """The pallas_call of unet_tpu/ops/probe.py:145-156 for a source of any
    height, in interpret mode."""
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((8, 128), jnp.float32),
                        pltpu.SemaphoreType.DMA(())],
    )
    out = pl.pallas_call(
        _probe_kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray([off], jnp.int32), jnp.asarray(x))
    return np.asarray(out)


@pytest.fixture(scope="module")
def src64():
    return np.random.default_rng(3).normal(size=(64, 128)).astype(np.float32)


def _t(off: int) -> torch.Tensor:
    return torch.tensor([off], dtype=torch.int32)


@pytest.mark.parametrize("off", range(8))
def test_reference_equals_interpreted_probe_kernel(src64, off):
    got = probe.offset_copy_reference(torch.from_numpy(src64), _t(off)).numpy()
    np.testing.assert_array_equal(got, _jax_probe(src64, off))


def test_reference_on_the_probes_own_case():
    """The probe's (16, 128) arange source at offset 1: rows 8-15."""
    x = np.arange(16 * 128, dtype=np.float32).reshape(16, 128)
    want = _jax_probe(x, 1)
    np.testing.assert_array_equal(want, x[8:16])
    np.testing.assert_array_equal(
        probe.offset_copy_reference(torch.from_numpy(x), _t(1)).numpy(), want)


def test_reference_returns_a_copy(src64):
    src = torch.from_numpy(src64.copy())
    out = probe.offset_copy_reference(src, _t(2))
    out.zero_()
    assert float(src[16:24].abs().sum()) > 0


@pytest.mark.parametrize("rows,off", [(64, -1), (64, 8), (64, 100), (16, 2), (12, 1)])
def test_reference_rejects_bad_offsets(rows, off):
    with pytest.raises(ValueError, match="out of range"):
        probe.offset_copy_reference(torch.zeros((rows, 128)), _t(off))


def test_offset_copy_never_runs_on_the_cpu():
    """The binding takes CUDA tensors only; it does not fall back to the
    plain version."""
    before = probe.offset_copy.launches
    with pytest.raises(ValueError, match="not CUDA"):
        probe.offset_copy(torch.zeros((16, 128)), _t(1))
    assert probe.offset_copy.launches == before


@pytest.fixture
def plain_calls(monkeypatch):
    """Records any call of a kernel's plain version during the test."""
    from unet_tpu_torch.ops import aug, blend, bn

    calls = []
    for mod, name in ((blend, "blend_and_count_reference"), (bn, "bn_sum_sumsq_reference"),
                      (bn, "bn_bwd_sums_reference"), (aug, "fused_flip_scale_reference"),
                      (probe, "offset_copy_reference")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    return calls


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_capability_check_needs_a_card(monkeypatch, plain_calls, device):
    """On the CPU, and for "cuda" without a card, it raises and runs no
    plain version in a kernel's place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        probe.capability_check(device)
    assert plain_calls == []


def test_capability_check_covers_every_cuda_source():
    """Every kernel source under ops/csrc/ is built and checked."""
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert set(probe.SOURCES) == sources
    assert set(probe.CHECKS) == {"blend_count", "bn_sum_sumsq", "bn_bwd_sums",
                                 "flip_scale", "offset_copy"}


# --- offset_copy's status word, with the launcher stubbed ---


def _stub_launch(word=None, err=0):
    """A launcher that writes ``word`` (None: nothing) where the kernel
    would write its status, and returns the CUDA error ``err``."""
    calls = []

    def launch(ptr):
        calls.append(ptr)
        if word is not None:
            ctypes.c_int32.from_address(ptr).value = word
        return err
    return launch, calls


@pytest.mark.parametrize("word", [0, 1])
def test_status_word_is_cleared_then_read_after_the_wait(word):
    status = torch.tensor([7], dtype=torch.int32)  # a stale word
    order = []
    launch, calls = _stub_launch(word or None)  # a good kernel writes nothing

    def wait():
        order.append(("wait", int(status[0])))
    got = probe._run_with_status(lambda p: (order.append(("launch", int(status[0]))),
                                            launch(p))[1], wait, status)
    assert got == word and calls == [status.data_ptr()]
    assert order == [("launch", 0), ("wait", word)]


def test_status_word_left_clear_after_a_bad_call_reads_as_good():
    """A refused offset leaves 1 behind; the next call starts from 0 and a
    kernel that writes nothing reads as a copy."""
    status = torch.zeros(1, dtype=torch.int32)
    assert probe._run_with_status(_stub_launch(1)[0], lambda: None, status) == 1
    word = probe._run_with_status(_stub_launch(None)[0], lambda: None, status)
    assert word == 0
    probe._raise_for_status(word, _t(1), 16)


def test_failed_launch_raises_before_any_wait():
    launch, _ = _stub_launch(None, err=700)
    waited = []
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        probe._run_with_status(launch, lambda: waited.append(1), torch.zeros(1, dtype=torch.int32))
    assert waited == []


@pytest.mark.parametrize("off", [-1, 2, 1000])
def test_status_one_raises_value_error_with_the_offset(off):
    with pytest.raises(ValueError, match=f"offset {off} out of range"):
        probe._raise_for_status(1, _t(off), 16)


def test_status_zero_passes_and_unknown_words_raise():
    probe._raise_for_status(0, _t(1), 16)
    with pytest.raises(RuntimeError, match="status word 7"):
        probe._raise_for_status(7, _t(1), 16)
