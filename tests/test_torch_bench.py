"""PyTorch port: ``python -m unet_tpu_torch bench`` (``unet_tpu_torch/bench.py``
and ``bench_scaling.py``) on the CPU.

Each section runs at a small size (64² tiles, batch 2, 2 steps, xresnet18
where the section takes an architecture) with ``device="cpu"``; its keys
must be JAX's for that section (written out below with the line of
``unet_tpu/bench.py`` or ``unet_tpu/bench_scaling.py`` they come from)
plus the port's own, and every rate must be finite and positive. CPU
figures are not card figures: only the shape of the result is checked.

The orchestration (``run_benchmark``) is driven through the command line
with its child-process runner replaced by canned sections, so that the
output contract, the exit codes and the absence of any stand-in for a
failure are checked in a second; one cheap section and one failing one
run through the real runner. The card's ``kernels`` section is in
``tests/test_torch_cuda.py``; a whole ``bench --device cpu`` run is the
one ``slow`` test here.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unet_tpu_torch import bench, bench_scaling
from unet_tpu_torch.__main__ import build_parser, cli
from unet_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(tile=64, batch_size=2, steps=2, arch="xresnet18", device="cpu")

# JAX's result keys of each section
JAX_TRAIN = {"tile", "batch_size", "steps", "arch", "tpu_opt", "step_ms", "seconds",
             "tiles_per_sec", "tiles_per_sec_per_chip", "n_chips"}  # bench.py:144-155
JAX_PREDICT = {"tile", "batch_size", "seconds", "megapixels_per_sec"}  # bench.py:186-187
JAX_SERVING = {  # bench.py:261-324
    "live_mpix_s", "d2h_bytes_per_tile_argmax", "live_probs_mpix_s",
    "d2h_bytes_per_tile_probs", "artifact_mpix_s", "artifact_matches_live",
    "artifact_size_mb", "artifact_int8_mpix_s", "artifact_int8_size_mb",
    "artifact_int8_agree_pct", "tta_mpix_s", "tta_device_cost_factor", "tta_cost_factor",
    "streamed_scene_mpix_s"}
JAX_LOADER = {"python_raw_mpix_s", "native_raw_mpix_s", "python_deflate_mpix_s",
              "native_deflate_mpix_s", "native_jpeg_mpix_s"}  # bench.py:358-385
JAX_E2E = {"e2e_tiles_per_sec", "e2e_tiles_per_sec_sync", "overlap_efficiency",
           "h2d_mb_per_sec", "n_steps"}  # bench.py:480-486
JAX_SCALING = {"caveat", "per_device_batch", "tile"}  # bench_scaling.py:98-106
JAX_SCALING_N = {"step_ms", "ratio_vs_1dev", "global_batch"}  # bench_scaling.py:88-92
SECTIONS = ["train_parity_topology", "predict", "serving", "loader", "e2e_train",
            "scaling", "kernels"]  # bench.py:851-869, pallas -> kernels


def rates_ok(res: dict, keys) -> None:
    for k in keys:
        assert math.isfinite(res[k]) and res[k] > 0, (k, res[k])


def spread_ok(s: dict) -> None:
    assert s["min"] <= s["median"] <= s["max"] and s["n"] >= 1, s
    assert s["min"] > 0, s


@pytest.mark.parametrize("tpu_opt", [True, False])
def test_bench_train(tpu_opt):
    res = bench.bench_train(tpu_opt=tpu_opt, **SMALL)
    assert set(res) == JAX_TRAIN | {"spread", "launches", "launches_per_step", "device"}
    rates_ok(res, ["step_ms", "seconds", "tiles_per_sec", "tiles_per_sec_per_chip"])
    assert res["n_chips"] == 1 and res["tpu_opt"] is tpu_opt and res["steps"] == 2
    assert res["tiles_per_sec_per_chip"] == res["tiles_per_sec"]
    for s in res["spread"].values():
        spread_ok(s)
    assert res["spread"]["step_ms"]["n"] == 2
    # the CPU runs the plain versions: no kernel launches
    assert set(res["launches"]) == {"bn_sum_sumsq", "bn_bwd_sums", "flip_scale",
                                    "blend_count", "offset_copy"}
    assert not any(res["launches"].values()) and res["device"] == "cpu"


def test_bench_predict():
    res = bench.bench_predict(**SMALL)
    assert set(res) == JAX_PREDICT | {"steps", "spread", "device"}
    rates_ok(res, ["seconds", "megapixels_per_sec"])
    for s in res["spread"].values():
        spread_ok(s)


def test_bench_serving():
    res = bench.bench_serving(scene=128, **SMALL)
    assert set(res) == JAX_SERVING | {"spread", "host_ms_per_batch", "copy_host_ms_per_batch",
                                      "forward_ms", "seconds", "artifact_agree_pct",
                                      "launches", "device"}
    rates_ok(res, ["live_mpix_s", "live_probs_mpix_s", "artifact_mpix_s",
                   "artifact_int8_mpix_s", "tta_mpix_s", "streamed_scene_mpix_s",
                   "tta_device_cost_factor", "tta_cost_factor", "artifact_size_mb",
                   "artifact_int8_size_mb"])
    assert res["artifact_matches_live"] is True and res["artifact_agree_pct"] == 100.0
    assert 0 < res["artifact_int8_agree_pct"] <= 100
    assert res["artifact_int8_size_mb"] < 0.35 * res["artifact_size_mb"]
    assert res["d2h_bytes_per_tile_argmax"] == 64 * 64
    assert res["d2h_bytes_per_tile_probs"] == 3 * 64 * 64 * 4
    predictors = {"live", "live_probs", "artifact", "artifact_int8", "tta"}
    for key in ("host_ms_per_batch", "copy_host_ms_per_batch", "forward_ms"):
        assert set(res[key]) == predictors
        for s in res[key].values():
            spread_ok(s)
    assert set(res["seconds"]) == {"export", "load", "export_int8", "load_int8"}
    assert set(res["spread"]) == {f"{p}_mpix_s" for p in predictors} | {
        "streamed_scene_mpix_s"}


def test_bench_loader():
    res = bench.bench_loader(tile=64, n_tiles=4, bands=4)
    assert set(res) == JAX_LOADER | {"spread", "device"}
    rates_ok(res, JAX_LOADER)
    assert set(res["spread"]) == JAX_LOADER


def test_bench_e2e_train():
    res = bench.bench_e2e_train(tile=64, batch_size=2, n_tiles=4, device="cpu")
    assert set(res) == JAX_E2E | {"spread", "launches", "device"}
    rates_ok(res, ["e2e_tiles_per_sec", "e2e_tiles_per_sec_sync", "overlap_efficiency",
                   "h2d_mb_per_sec"])
    assert res["n_steps"] == 2
    assert res["spread"]["e2e_tiles_per_sec"]["n"] == 2


def test_bench_scaling_one_and_two_processes():
    res = bench_scaling.main((1, 2))
    assert set(res) == JAX_SCALING | {"n1", "n2", "device"}
    assert "CPU processes" in res["caveat"] and "NOT cards" in res["caveat"]
    for n in (1, 2):
        r = res[f"n{n}"]
        assert set(r) == JAX_SCALING_N | {"spread"}
        assert r["global_batch"] == 2 * n and r["step_ms"] > 0
        assert r["spread"]["step_ms"]["n"] == bench_scaling.STEPS
    assert res["n1"]["ratio_vs_1dev"] == 1.0


def test_loader_jpeg_stream_equals_jax_encoder():
    """The loader's JPEG stream comes from the port's encoder, byte-equal
    to JAX's (after its bit writer was made linear in the stream length)."""
    from unet_tpu.geo.jpeg import encode_baseline as jax_encode
    from unet_tpu_torch.geo.jpeg import encode_baseline

    arr = np.random.default_rng(0).integers(0, 255, (160, 120, 3)).astype(np.uint8)
    assert encode_baseline(arr, quality=90, subsampling="4:4:4") == jax_encode(
        arr, quality=90, subsampling="4:4:4")


# --- the kernels section ----------------------------------------------------------


def test_kernel_bounds_match_the_kernel_table():
    """The bound arithmetic at the main path's shapes (512² tiles, batch
    16) gives the bytes bounds of the kernel table (PERF.md): bn_stats per
    train step 0.285 / 0.571 ms, flip_scale 21.3 µs, blend_count 45.1 µs on
    the 4096² scene's first batch, offset_copy 2.45 ns."""
    from unet_tpu_torch.tiling.windows import generate_windows

    fwd = bwd = 0
    for c, h, count in timing.bn_sites(512):
        fwd += count * timing.bn_work((16, c, h, h), 2, False)[0]
        bwd += count * timing.bn_work((16, c, h, h), 2, True)[0]
    assert sum(count for *_, count in timing.bn_sites(512)) == 43
    assert timing.bound(fwd, 0) == (pytest.approx(0.2855, abs=5e-4), "bytes")
    assert timing.bound(bwd, 0)[0] == pytest.approx(0.5709, abs=5e-4)
    assert timing.bound(*timing.flip_work(16, 3, 512, 512)) == (
        pytest.approx(21.28e-3, abs=5e-5), "bytes")
    wins = generate_windows(4096, 4096, 512, 0.2)[:16]
    ms, by = timing.blend_bound_ms(16, 3, 512, 512, [w.y for w in wins], [w.x for w in wins])
    assert (round(ms * 1e3, 1), by) == (45.1, "bytes")
    assert timing.bound(*timing.offset_copy_work())[0] * 1e6 == pytest.approx(2.445, abs=1e-3)
    # every site scales with the tile: the shapes the bench gives at 256²
    assert timing.bn_sites(256)[-1] == (512, 8, 8)
    with pytest.raises(ValueError):
        timing.bn_sites(100)


def test_bench_kernels_refuses_the_cpu():
    with pytest.raises(RuntimeError, match="CPU has none"):
        bench.bench_kernels(tile=64, batch_size=2, device="cpu")


def test_spread():
    assert timing.spread([3.0, 1.0, 2.0]) == {"median": 2.0, "min": 1.0, "max": 3.0, "n": 3}


# --- orchestration -----------------------------------------------------------------


def test_section_child_process():
    """One cheap section through the real runner (a child process), then
    a failing one: its error comes back, nothing stands in for it."""
    res = bench._bench_section("bench_predict", dict(tile=32, batch_size=1, steps=1,
                                                     arch="xresnet18", device="cpu"), 300)
    assert set(res) == JAX_PREDICT | {"steps", "spread", "device"}
    assert res["megapixels_per_sec"] > 0 and res["device"] == "cpu"
    bad = bench._bench_section("bench_kernels", dict(device="cpu"), 300)
    assert set(bad) == {"error"} and "CPU has none" in bad["error"]


def test_child_past_its_timeout_is_killed():
    res = bench.run_child([sys.executable, "-c", "import time; time.sleep(60)"], 1)
    assert res == {"error": "section timed out after 1s"}


def canned(name: str) -> dict:
    """A section's result as the fake runner hands it back."""
    return {"bench_train": {"batch_size": 2, "tiles_per_sec_per_chip": 250.0},
            "bench_predict": {"megapixels_per_sec": 1.0}}.get(name, {"ok": name})


@pytest.fixture
def runner(monkeypatch):
    """Replace the child-process runner: ``calls`` records (section,
    kwargs); ``fail`` names the sections that fail."""
    state = {"calls": [], "fail": set()}

    def fake_section(fn_name, kwargs, timeout_s, round_floats=4):
        state["calls"].append((fn_name, kwargs))
        if fn_name in state["fail"]:
            return {"error": f"rc=1: {fn_name} failed"}
        return canned(fn_name)

    def fake_child(argv, timeout_s):
        state["calls"].append((argv[-1], {}))
        return {"error": "rc=1: scaling failed"} if "scaling" in state["fail"] else {"n1": {}}

    monkeypatch.setattr(bench, "_bench_section", fake_section)
    monkeypatch.setattr(bench, "run_child", fake_child)
    return state


def run_cli(capsys, *extra):
    code = cli(["bench", "--device", "cpu", "--tile", "64", "--batch-size", "2",
                "--steps", "2", *extra])
    out, err = capsys.readouterr()
    return code, out.strip().splitlines(), err.strip().splitlines()


def test_run_benchmark_output_contract(runner, capsys):
    code, out, err = run_cli(capsys)
    assert code == 0
    headline = {"metric": "train_tiles_per_sec_per_chip_512", "value": 250.0,
                "unit": "tiles/s/chip", "vs_baseline": 2.5}
    assert json.loads(out[0]) == headline and json.loads(out[-1]) == headline
    lines = [json.loads(line) for line in err]
    assert [d["section"] for d in lines[:-1]] == SECTIONS
    assert set(lines[-1]) == {"train", "baseline_note", "budget", "section_seconds", *SECTIONS}
    assert set(lines[-1]["section_seconds"]) == {"train", *SECTIONS}
    assert lines[-1]["train"] == canned("bench_train")
    # the CPU has no kernels: said so, not an error, and no child ran for it
    assert "skipped" in lines[-1]["kernels"] and "error" not in lines[-1]["kernels"]
    names = [c[0] for c in runner["calls"]]
    assert "bench_kernels" not in names
    assert names[0] == "bench_train" and runner["calls"][0][1] == dict(
        tile=64, batch_size=2, steps=2, device="cpu")
    assert all(kw.get("device", "cpu") == "cpu" for _, kw in runner["calls"])


def test_failed_section_exits_1_after_printing_everything(runner, capsys):
    runner["fail"] = {"bench_predict", "scaling"}
    code, out, err = run_cli(capsys)
    assert code == 1
    assert json.loads(out[0]) == json.loads(out[-1])
    lines = {d.get("section"): d for d in map(json.loads, err[:-1])}
    assert lines["predict"]["error"] == "rc=1: bench_predict failed"
    assert lines["scaling"]["error"] == "rc=1: scaling failed"
    assert "error" not in lines["serving"] and "stale" not in json.dumps(lines)
    # one call each: no retry, no smaller batch
    names = [c[0] for c in runner["calls"]]
    assert names.count("bench_predict") == 1 and names.count("bench_train") == 2
    assert bench.failed_sections(json.loads(err[-1])) == ["predict", "scaling"]


def test_failed_headline_exits_1_with_no_stand_in(runner, capsys):
    runner["fail"] = {"bench_train"}
    code, out, err = run_cli(capsys)
    assert code == 1 and out == []
    assert err[0] == "error: training benchmark failed: rc=1: bench_train failed"
    # asked once, at the batch size given
    assert runner["calls"] == [("bench_train", dict(tile=64, batch_size=2, steps=2,
                                                    device="cpu"))]


def test_budget_spent_skips_and_fails(runner, capsys, monkeypatch):
    monkeypatch.setenv("UNET_TPU_BENCH_BUDGET", "100")
    code, out, err = run_cli(capsys)
    assert code == 1 and runner["calls"] == []
    assert "skipped: bench budget exhausted" in err[0]


def test_cli_flags_are_jax_flags():
    from unet_tpu.__main__ import build_parser as jax_parser

    mine = vars(build_parser().parse_args(["bench"]))
    jax = vars(jax_parser().parse_args(["bench"]))
    assert mine == {**jax, "device": "cuda"}
    assert (jax["tile"], jax["batch_size"], jax["steps"]) == (512, 16, 20)
    help_text = subprocess.run([sys.executable, "-m", "unet_tpu_torch", "bench", "--help"],
                               capture_output=True, text=True, cwd=ROOT, check=True).stdout
    for flag in ("--tile", "--batch-size", "--steps", "--device"):
        assert flag in help_text


def test_without_a_card_bench_raises(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_benchmark(tile=64, batch_size=2, steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.bench_train(tile=64, batch_size=2, steps=2, arch="xresnet18")
    assert cli(["bench"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.slow
def test_whole_bench_on_the_cpu():
    """``python -m unet_tpu_torch bench --device cpu`` at 64² end to end:
    exit 0, the headline first and last, seven section lines and the
    detail, none with an error."""
    proc = subprocess.run(
        [sys.executable, "-m", "unet_tpu_torch", "bench", "--tile", "64", "--batch-size", "2",
         "--steps", "2", "--device", "cpu"], capture_output=True, text=True, cwd=ROOT,
        timeout=1800)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout.strip().splitlines()
    assert json.loads(out[0])["metric"] == "train_tiles_per_sec_per_chip_512"
    assert json.loads(out[-1]) == json.loads(out[0])
    lines = [json.loads(line) for line in proc.stderr.strip().splitlines()
             if line.startswith("{")]
    assert [d["section"] for d in lines[:-1]] == SECTIONS
    assert not bench.failed_sections(lines[-1])
    assert lines[-1]["serving"]["artifact_matches_live"] is True
