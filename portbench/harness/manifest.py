"""``BENCHMARK.json`` and the files it names, found by name:

- a configuration: the ``file`` of its ``configs`` entry;
- a traffic mix: ``portbench/traffic/<traffic>.json``, whose ``driver``
  names the loop that drives it, ``portbench/drivers/<driver>.py``;
- a cell's limits on its compared numbers: ``portbench/limits/<workload>.json``;
- a metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` returns
  the value or None where it finds nothing to read.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
from pathlib import Path
from typing import List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((BENCH / "traffic" / f"{name}.json").read_text())

    def driver(self, workload: str):
        """The module of the cell's driver, named by its traffic file."""
        return importlib.import_module(f"portbench.drivers.{self.traffic(self.workload(workload)['traffic'])['driver']}")

    def limits(self, workload: str) -> dict:
        return json.loads((BENCH / "limits" / f"{workload}.json").read_text())

    def end_to_end(self, workload: str) -> List[dict]:
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end(workload)}

        def applies(m: dict) -> bool:
            return workload in m["workloads"] if "workloads" in m else m["moves"] in e2e

        return [m for m in self.data["per_layer"] if applies(m)]


@functools.lru_cache(maxsize=None)
def reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``; a metric
    whose arithmetic is another's loads that one's by this."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
