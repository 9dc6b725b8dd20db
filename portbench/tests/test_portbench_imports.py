"""What the benchmark loads, checked in fresh processes: nothing of JAX or
of the JAX package (top-level module names compared whole, so
``bts_tpu_torch`` is not ``bts_tpu``), and the plain reference alone loads
nothing of the program."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

EVERYTHING = """
import importlib, json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
import importlib.util
spec = importlib.util.spec_from_file_location("portbench_run", {root!r} + "/portbench/run.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
for name in ("portbench.harness.cell", "portbench.control", "portbench.faults",
             "portbench.counts.flops", "portbench.counts.lpg", "portbench.counts.peaks",
             "portbench.reference.model", "portbench.reference.train", "portbench.reference.quant"):
    importlib.import_module(name)
for folder in ("drivers", "reference/encoders"):
    for path in sorted(Path({root!r}, "portbench", folder).glob("[!_]*.py")):
        importlib.import_module("portbench." + folder.replace("/", ".") + "." + path.stem)
from portbench.harness import manifest
bench = manifest.Manifest()
for m in bench.data["end_to_end"] + bench.data["per_layer"]:
    manifest.reader(m["name"])
for w in bench.data["workloads"]:
    bench.traffic(w["traffic"]), bench.config(w["config"]), bench.limits(w["name"]), bench.driver(w["name"])
print(json.dumps(sorted(sys.modules)))
"""

REFERENCE = """
import importlib, json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
for name in ("portbench.reference.model", "portbench.reference.augment", "portbench.reference.train",
             "portbench.reference.quant"):
    importlib.import_module(name)
for path in sorted(Path({root!r}, "portbench", "reference", "encoders").glob("[!_]*.py")):
    importlib.import_module("portbench.reference.encoders." + path.stem)
print(json.dumps(sorted(sys.modules)))
"""


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=300, check=True)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_the_benchmark_loads_no_jax_and_no_jax_package():
    top = _modules(EVERYTHING)
    assert "bts_tpu_torch" in top and "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "bts_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    top = _modules(REFERENCE)
    assert "torch" in top
    assert not top & {"bts_tpu_torch", "jax", "jaxlib", "flax", "bts_tpu"}
