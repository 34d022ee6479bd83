"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's cards. Set-up
(inputs and weights from the seed, the program built and warmed) is
followed by a window of ``--seconds``, then by the comparison with the
plain reference that decides ``correct``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, read from a
profiler trace of a slice of the window, with the card's busy time and a
breakdown. The last lines on standard error name each number compared
with its limit (earlier lines, the numbers read that the cell does not
compare); the last line on standard output is the result, as JSON.

Exits 2, printing no result, without the cards the cell needs; 3 when a
module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "unet_tpu"}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(repo: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = repo / ".perfbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv=None, repo: Path = REPO, device=None) -> int:
    """``device`` is for the tests: a CPU run that skips the look for a
    card; the command line never sets it."""
    args = parse(argv)
    cache_dirs(repo)
    if str(repo) not in sys.path:
        sys.path.insert(0, str(repo))
    import torch

    from perfbench.harness.context import Context, log
    from perfbench.harness.spec import Spec

    spec = Spec(repo)
    cell = spec.cell(args.workload)
    own = spec.cell_file(args.workload)
    if (own["config"], own["traffic"]) != (cell["config"], cell["traffic"]):
        raise ValueError(f"workloads/{args.workload}.json names {own['config']}, "
                         f"{own['traffic']}; BENCHMARK.json {cell['config']}, {cell['traffic']}")
    mix = spec.mix(cell["traffic"])
    generator = spec.generator(mix["generator"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
                f"cuda available: {torch.cuda.is_available()}, "
                f"cards: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)

    workdir = Path(tempfile.mkdtemp(prefix="perfbench-", dir=os.environ.get("TMPDIR")))
    try:
        ctx = Context(config=spec.config(cell["config"]), mix=mix, cell=own, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace), device=dev,
                      workdir=workdir, t_start=T_START)
        ctx.tracer.warm()
        out = generator.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    checks = {}
    for name, value in out["checks"]:  # the cell compares those it gives a limit
        if name in own["limits"]:
            checks[name] = {"value": value, "limit": own["limits"][name]}
        else:
            log(f"reading {name} {value!r} (not compared in this cell)")
    correct = (all(c["value"] <= c["limit"] for c in checks.values())
               and all(math.isfinite(value) for _, value in out["checks"]))

    metrics, breakdown = {}, None
    summary = ctx.tracer.summary()
    if args.trace:
        run = SimpleNamespace(config=ctx.config, mix=mix, cell=own, record=ctx.record,
                              spans=ctx.spans.seconds, trace=summary, e2e=out["e2e"])
        for m in spec.per_layer(args.workload):
            value = spec.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if summary is not None:
            breakdown = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    else:
        for m in spec.end_to_end(args.workload):
            metrics[m["name"]] = {"value": out["e2e"][m["name"]], "unit": m["unit"]}

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type,
                   "count": 1 if dev.type == "cuda" else 0,
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    if dev.type == "cuda":
        device_info["power_limit"] = power_limit()
    if args.trace:
        device_info["busy_s"] = summary["busy_s"] if summary else 0.0
        device_info["window_s"] = summary["window_s"] if summary else 0.0

    bad = loaded_forbidden()
    if bad:
        log(f"modules of JAX or of the JAX package were loaded: {bad}")
        return 3

    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps({"launches": _launches(), "e2e": out["e2e"],
                      "record": {k: v for k, v in ctx.record.items()
                                 if not isinstance(v, list)}}, default=str), flush=True)
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


def _launches() -> dict:
    """The program's own launch counters of its CUDA kernels."""
    from unet_tpu_torch.ops.aug import fused_flip_scale
    from unet_tpu_torch.ops.blend import blend_and_count
    from unet_tpu_torch.ops.bn import bn_bwd_sums, bn_sum_sumsq

    return {"bn_sum_sumsq": bn_sum_sumsq.launches, "bn_bwd_sums": bn_bwd_sums.launches,
            "flip_scale": fused_flip_scale.launches, "blend_count": blend_and_count.launches}


if __name__ == "__main__":
    sys.exit(main())
