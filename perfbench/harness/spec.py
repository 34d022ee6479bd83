"""Finding a cell's files by name.

``BENCHMARK.json`` at the repository's root lists the configurations, the
cells and the metrics. Everything else is found under ``perfbench/`` by
the names it gives:

* ``configs/<config>.json`` (the entry's ``file``): a configuration;
* ``workloads/<cell>.json``: one cell's own settings (its traced slice and
  the limits of its comparison);
* ``traffic/<mix>.json``: a traffic mix, the parameters one generator reads,
  and ``traffic/<generator>.py``, that generator (``run(ctx) -> dict``);
* ``metrics/<metric>.py``: the reader of one per-layer metric
  (``read(run) -> float or None``); a metric split by the end-to-end
  metric it moves (``idle_share.serve``, ``idle_share.train``) without a
  file of its own is read by the family's, ``metrics/<name before the
  first dot>.py``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import List

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class Spec:
    def __init__(self, repo: Path):
        self.repo = Path(repo)
        self.root = self.repo / "perfbench"
        self.bench = json.loads((self.repo / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{[w['name'] for w in self.bench['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.repo / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def cell_file(self, name: str) -> dict:
        return json.loads((self.root / "workloads" / f"{name}.json").read_text())

    def mix(self, name: str) -> dict:
        return json.loads((self.root / "traffic" / f"{name}.json").read_text())

    def generator(self, name: str) -> ModuleType:
        return _load(self.root / "traffic" / f"{name}.py", f"perfbench_traffic_{name}")

    def reader(self, metric: str) -> ModuleType:
        path = self.root / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = self.root / "metrics" / f"{metric.split('.')[0]}.py"
        return _load(path, "perfbench_metric_" + re.sub(r"\W", "_", path.stem))

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics read in the cell's traced runs: those that
        list it, and those without a list whose end-to-end metric it
        reports."""
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.bench["per_layer"]
                if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def _load(path: Path, module_name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
