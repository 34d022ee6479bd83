"""PyTorch port: ``python -m unet_tpu_torch doctor`` on a machine without a
CUDA device (the report, the exit code, isolated failures, the optional
modules)."""

import sys

import pytest
import torch

from unet_tpu_torch.__main__ import cli
from unet_tpu_torch.utils import doctor

CHECKS = ("versions", "devices", "mesh", "toolchain", "native decoder", "optional deps")


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_doctor_without_a_card_is_not_ready(no_card, capsys):
    assert cli(["doctor"]) == 1
    out = capsys.readouterr().out
    for name in CHECKS:
        assert name in out
    assert "FAIL  devices" in out and "no CUDA device" in out
    assert "blocking: devices, mesh" in out and "all checks passed" not in out
    assert "kernels" not in out  # opt-in


def test_native_decoder_check_passes_here(no_card, capsys):
    results = doctor.run_doctor()
    assert results["native decoder"][0]
    assert "ABI v4" in results["native decoder"][1]
    assert "ok   native decoder" in capsys.readouterr().out


@pytest.mark.parametrize("flag", ["--kernels", "--pallas"])
def test_kernels_check_without_a_card_fails(no_card, monkeypatch, capsys, flag):
    """The kernel check raises without a card, so it reports FAIL; no plain
    version runs in a kernel's place."""
    from unet_tpu_torch.ops import aug, blend, bn, probe

    calls = []
    for mod, name in ((blend, "blend_and_count_reference"), (bn, "bn_sum_sumsq_reference"),
                      (bn, "bn_bwd_sums_reference"), (aug, "fused_flip_scale_reference"),
                      (probe, "offset_copy_reference")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k: calls.append(_n))
    assert cli(["doctor", flag]) == 1
    out = capsys.readouterr().out
    assert "FAIL  kernels" in out and "CUDA" in out
    assert calls == []


def test_a_check_that_raises_is_reported(no_card, monkeypatch, capsys):
    """A failing check reports, never raises, and flips the exit code."""
    def boom():
        raise RuntimeError("decoder exploded")

    monkeypatch.setattr(doctor, "_native", boom)
    assert cli(["doctor"]) == 1
    out = capsys.readouterr().out
    assert "FAIL  native decoder" in out and "decoder exploded" in out
    assert "all checks passed" not in out


def test_exit_code_is_zero_only_when_every_check_passes(monkeypatch, capsys):
    for name in ("_versions", "_devices", "_toolchain", "_native", "_kernels"):
        monkeypatch.setattr(doctor, name, lambda: (True, "fine"))
    monkeypatch.setattr(doctor, "_mesh", lambda device: (True, "fine"))
    assert cli(["doctor", "--kernels"]) == 0
    assert "doctor: all checks passed" in capsys.readouterr().out
    monkeypatch.setattr(doctor, "_toolchain", lambda: (False, "no nvcc"))
    assert cli(["doctor"]) == 1
    out = capsys.readouterr().out
    assert "issues found" in out and "blocking" not in out  # toolchain is not blocking


def test_devices_check_needs_compute_capability_9(monkeypatch):
    class Props:
        name, total_memory, major, minor = "Some GPU", 16 * 2**30, 8, 0

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props)
    ok, detail = doctor._devices()
    assert not ok and "compute capability 8.0" in detail and "need 9.0" in detail
    Props.major = 9
    ok, detail = doctor._devices()
    assert ok and "Some GPU, 16.0 GiB" in detail


@pytest.mark.parametrize("hidden", [None, "matplotlib"])
def test_optional_deps_names_each_module_and_never_blocks(hidden, monkeypatch):
    """PIL and tqdm with the JAX package's reasons (its third, torch, is
    core here), then the plotting modules; a missing one is named with what
    it is for, and the check still passes: the PNGs are skipped, nothing
    else needs it."""
    from unet_tpu.utils import doctor as jax_doctor

    ok, want = jax_doctor._optional_deps()
    assert ok and want == "PIL, torch, tqdm"
    if hidden:
        monkeypatch.setitem(sys.modules, hidden, None)
    ok, detail = doctor._optional_deps()
    assert ok
    names = [part.split(" ")[0] for part in detail.split(", ")]
    assert names == ["PIL", "tqdm", "matplotlib", "seaborn", "pandas"]
    if hidden:
        assert "matplotlib MISSING (training and validation PNGs)" in detail
    else:
        assert "MISSING" not in detail
