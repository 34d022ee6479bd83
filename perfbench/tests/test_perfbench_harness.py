"""The benchmark's files against its contract, and tiny CPU runs of each
traffic kind through the whole harness."""

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from conftest import REPO, TINY, make_copy, run_cell

from perfbench.harness import spec as spec_mod
from perfbench.harness import tiff

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
FORBIDDEN = {"jax", "jaxlib", "flax", "unet_tpu"}


def test_benchmark_json_has_the_contracts_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (REPO / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    # a full check of 24 cells fits its day
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [w["traffic"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    for n in names:
        assert spec_mod.NAME.fullmatch(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec_mod.UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH[group]]
        assert len(got) == len(set(got)), group
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for path in (REPO / "perfbench").rglob("*"):
        if "__pycache__" not in path.parts:
            assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", str(path.relative_to(REPO))), path


@pytest.mark.parametrize("cell", CELLS)
def test_each_cells_files_are_found_by_name(cell):
    spec = spec_mod.Spec(REPO)
    w = spec.cell(cell)
    own = spec.cell_file(cell)
    assert (own["config"], own["traffic"]) == (w["config"], w["traffic"])
    config = spec.config(w["config"])
    assert config["reduced"] == [c for c in BENCH["configs"] if c["name"] == w["config"]][0]["reduced"]
    mix = spec.mix(w["traffic"])
    assert callable(spec.generator(mix["generator"]).run)
    e2e = {m["name"] for m in spec.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(spec.reader(m["name"]).read)


def test_a_metric_without_a_list_of_cells_is_read_where_its_end_to_end_metric_is(tmp_path):
    """A per-layer entry without ``workloads`` (the contract allows it) is
    read in every cell that reports the metric it moves; a metric split
    by what it moves is read by its family's file."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "idle_share.later", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "serve_mpix_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "perfbench").symlink_to(REPO / "perfbench")
    spec = spec_mod.Spec(tmp_path)
    for cell in CELLS:
        names = [m["name"] for m in spec.per_layer(cell)]
        assert ("idle_share.later" in names) == ("serve_mpix_per_s" in
                                                 {m["name"] for m in spec.end_to_end(cell)})
    family = (REPO / "perfbench" / "metrics" / "idle_share.py").resolve()
    for name in ("idle_share.later", "idle_share.serve", "idle_share.train"):
        assert Path(spec.reader(name).__file__).resolve() == family


def test_every_config_is_used_and_every_layer_name_is_listed_once():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    for layer in layers:
        assert "\n" not in layer and len(layer) <= 200


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (REPO / "perfbench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (REPO / "perfbench" / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN | {"unet_tpu_torch"}, (path, name)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import perfbench.reference.unet, perfbench.reference.train, "
            "perfbench.reference.serve, perfbench.reference.work\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'unet_tpu_torch', 'unet_tpu', 'jax'}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tiff_writer_is_read_by_the_program_and_reads_the_programs_maps(tmp_path):
    from unet_tpu_torch.geo import tiff as program_tiff
    from unet_tpu_torch.geo import write_raster

    g = torch.Generator().manual_seed(0)
    img = torch.randint(0, 256, (3, 70, 50), generator=g, dtype=torch.uint8).numpy()
    tiff.write(tmp_path / "a.tif", img, (500000.0, 0.2, 0.0, 5600000.0, 0.0, -0.2), 25832)
    data, info = program_tiff.read(str(tmp_path / "a.tif"))
    assert (data == img).all()
    assert info.transform == pytest.approx((500000.0, 0.2, 0.0, 5600000.0, 0.0, -0.2))
    assert (tiff.read(tmp_path / "a.tif") == img).all()
    cls = img[0] % 3
    write_raster(tmp_path / "m.tif", cls, transform=info.transform, crs=info.crs)
    assert (tiff.read(tmp_path / "m.tif")[0] == cls).all()


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cpu_run_of_each_traffic_kind(tiny_repo, capsys, cell, trace):
    rc, result, err = run_cell(tiny_repo, capsys, cell, seed=2 ** 31 + 11, trace=trace)
    assert rc == 0, err
    assert list(result)[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    spec = spec_mod.Spec(tiny_repo)
    if trace:
        expected = {m["name"] for m in spec.per_layer(cell)}
        assert set(result["metrics"]) <= expected
        # the CPU has no device metrics: no roofline, mfu or idle share
        assert not any(re.search(r"roofline|mfu|idle", n) for n in result["metrics"])
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(result["metrics"]) == {m["name"] for m in spec.end_to_end(cell)}
        assert all(math.isfinite(v["value"]) and v["value"] > 0
                   for v in result["metrics"].values())
    assert result["device"]["platform"] == "cpu"
    last = err.strip().splitlines()[-len(result["checks"]):]
    assert all(ln.startswith("check ") and " limit " in ln for ln in last)


def test_adding_a_cell_takes_only_new_files(tmp_path):
    """The tiny copy's cells live in new files and new entries only: no
    file the benchmark has differs."""
    copy = make_copy(tmp_path)
    for path in (REPO / "perfbench").rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts and "tests" not in path.parts:
            twin = copy / path.relative_to(REPO)
            assert twin.read_bytes() == path.read_bytes(), path
    old = json.loads((REPO / "BENCHMARK.json").read_text())
    new = json.loads((copy / "BENCHMARK.json").read_text())
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert [e["name"] for e in new[group][:len(old[group])]] == [e["name"] for e in old[group]]
    assert new["configs"][:len(old["configs"])] == old["configs"]
    assert new["workloads"][:len(old["workloads"])] == old["workloads"]


def test_without_a_card_the_measurement_fails_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    from perfbench import run

    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out, err = capsys.readouterr()
    assert rc == 2 and out == "" and "CUDA" in err


def test_a_run_in_a_directory_without_the_program_fails(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", CELLS[0], "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
