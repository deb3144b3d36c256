"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: ``configs/<name>.json`` (the entry's ``file``);
- a traffic mix: ``traffic/<name>.json``;
- a cell's limits for ``correct``: ``limits/<workload>.json``;
- a per-layer metric's reader: ``metrics/<name>.py``, with ``read(ctx)``;
- the program a configuration drives: ``programs/<program>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


def load_json(path):
    return json.loads(Path(path).read_text())


class Spec:
    def __init__(self, bench=None):
        self.bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")

    def cell(self, workload):
        for w in self.bench["workloads"]:
            if w["name"] == workload:
                return w
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")

    def config(self, name):
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        return load_json(ROOT / entry["file"])

    def traffic(self, name):
        return load_json(HERE / "traffic" / f"{name}.json")

    def limits(self, workload):
        return load_json(HERE / "limits" / f"{workload}.json")["limits"]

    def end_to_end(self, workload):
        """The cell's end-to-end metrics (a metric with ``workloads`` only
        where it lists the cell)."""
        return [m for m in self.bench["end_to_end"]
                if "workloads" not in m or workload in m["workloads"]]

    def per_layer(self, workload):
        """The cell's per-layer metrics: those that list it, and those with
        no list whose ``moves`` the cell reports."""
        mine = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in mine)]


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric):
    return load_module(HERE / "metrics" / f"{metric}.py", f"portbench_metric_{metric}").read


def program(name):
    return load_module(HERE / "programs" / f"{name}.py", f"portbench_program_{name}")
