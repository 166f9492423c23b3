"""``BENCHMARK.json`` and the files it names, found by name.

* a cell: an entry of ``workloads``;
* its configuration: ``configs/<config>.json`` (the entry's ``file``);
* its traffic: ``traffic/<traffic>.json``, which names its driver,
  ``drivers/<driver>.py``;
* its correctness limit: ``limits/<cell>.json``;
* a metric's reader: ``metrics/<name>.py``, or, where there is none,
  ``metrics/<name less its last .suffix>.py`` (one reader serves
  ``x.lat`` and ``x.fps``).
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Dict, List

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    def __init__(self, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.bench = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        entry = next(c for c in self.bench["configs"] if c["name"] == name)
        return _json(self.root / entry["file"])

    def metrics(self, cell: str) -> Dict[str, List[Dict]]:
        """The cell's end-to-end and per-layer metrics."""
        def ours(m):
            return "workloads" not in m or cell in m["workloads"]
        return {kind: [m for m in self.bench[kind] if ours(m)] for kind in ("end_to_end", "per_layer")}


def traffic(name: str) -> Dict:
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell: str) -> Dict:
    return _json(HERE / "limits" / f"{cell}.json")


def driver(name: str):
    return _module(HERE / "drivers" / f"{name}.py", f"portbench_driver_{name}")


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    return _module(path, "portbench_metric_" + metric.replace(".", "_").replace("-", "_"))
