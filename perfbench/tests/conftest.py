"""A throwaway copy of the benchmark with two tiny cells, one a traffic
kind, for runs on the CPU: the copy gains them by new files and new
entries in its ``BENCHMARK.json`` alone. The training metrics and the
parity configuration, whose cells ``BENCHMARK.json`` does not hold yet,
come in as new entries too."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {
    "tiny.train": {
        "config": "xresnet34_tpu_opt", "traffic": "tiny_train",
        "mix": {"generator": "train_loop", "params": {
            "batch": 2, "tile": 64, "train_tiles": 8, "valid_tiles": 2, "epochs": 4,
            "lr": 0.001, "class_weights": "weighted", "hflip_p": 0.5, "vflip_p": 0.5,
            "loader_threads": 2}},
        # bf16 on the CPU at 64² reads loss 1e-3, gradient and change 0.1
        "limits": {"loss_gap": 0.01, "grad_gap": 0.5, "delta_gap": 0.5, "tiles_known": 0},
        "moves": "train_tiles_per_s"},
    "tiny.serve": {
        "config": "xresnet34_parity_sa", "traffic": "tiny_serve",
        "mix": {"generator": "scene_serve", "params": {
            "scene": 256, "patch": 64, "overlap": 0.2, "batch": 4}},
        # bf16 on the CPU at 256² reads at most 1e-2
        "limits": {"class_gap": 0.1},
        "moves": "serve_mpix_per_s"},
}


# the reference's model, whose cells BENCHMARK.json does not hold yet
PARITY = {"name": "xresnet34_parity_sa",
          "source": "https://github.com/fastai/fastai/blob/2.5.1/fastai/vision/models/unet.py",
          "file": "perfbench/configs/xresnet34_parity_sa.json", "reduced": [],
          "why": "what a reference user trains: fastai DynamicUnet over xresnet34 with blur, "
                 "last_cross and self-attention, bf16"}


def _metric(name, unit, better, source, moves=None, layer=None, bound=None):
    m = {"name": name, "unit": unit, "better": better, "source": source, "workloads": []}
    m.update({"bound": bound} if moves is None else {"layer": layer, "moves": moves})
    return m


TRAIN_METRICS = {
    "end_to_end": [_metric("train_tiles_per_s", "tiles/s", "higher", "host_clock", bound=0.25),
                   _metric("train_step_p95_ms", "ms", "lower", "device_trace", bound=0.25)],
    "per_layer": [
        _metric("loader_wait_ms.train", "ms", "lower", "host_clock", "train_tiles_per_s",
                "loader (data/loader.py)"),
        _metric("step_device_ms.train", "ms", "lower", "program_span", "train_tiles_per_s",
                "trainer step (train/loop.py)"),
        _metric("bn_stats_roofline", "%", "higher", "device_trace", "train_tiles_per_s",
                "kernels (ops/)"),
        _metric("flip_scale_roofline", "%", "higher", "device_trace", "train_tiles_per_s",
                "kernels (ops/)"),
        _metric("mfu.train", "%", "higher", "host_clock", "train_tiles_per_s",
                "model step (models/)"),
        _metric("idle_share.train", "%", "lower", "device_trace", "train_tiles_per_s", "device")],
}


def make_copy(dest: Path) -> Path:
    """The benchmark's files under ``dest`` plus the tiny cells; the
    program is reached through a link."""
    shutil.copytree(REPO / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dest / "unet_tpu_torch").symlink_to(REPO / "unet_tpu_torch")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    if PARITY["name"] not in {c["name"] for c in bench["configs"]}:
        bench["configs"].append(PARITY)
    for group, entries in TRAIN_METRICS.items():
        have = {m["name"] for m in bench[group]}
        bench[group] += [dict(m, workloads=[]) for m in entries if m["name"] not in have]
    for name, t in TINY.items():
        bench["workloads"].append({"name": name, "config": t["config"], "traffic": t["traffic"],
                                   "chips": 1, "why": "a CPU test's tiny cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and (m["name"] == t["moves"] or m.get("moves") == t["moves"]
                                     or m["name"] == "setup_s"):
                m["workloads"].append(name)
        (dest / "perfbench" / "traffic" / f"{t['traffic']}.json").write_text(json.dumps(t["mix"]))
        (dest / "perfbench" / "workloads" / f"{name}.json").write_text(json.dumps({
            "config": t["config"], "traffic": t["traffic"],
            "trace": {"after_frac": 0.0, "units": 1}, "limits": t["limits"]}))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest


@pytest.fixture(scope="session")
def tiny_repo(tmp_path_factory) -> Path:
    return make_copy(tmp_path_factory.mktemp("bench"))


def run_cell(repo: Path, capsys, cell: str, seed: int, trace: int = 0, seconds: float = 2.0):
    """(exit code, last stdout line as JSON or None, stderr) of one CPU run."""
    from perfbench import run

    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], repo=repo, device="cpu")
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return rc, (json.loads(lines[-1]) if lines else None), err
