"""The check against faults planted under the timed path: a whole run of
each cell (set-up, window, check; no look for a card), at a tiny size on
the CPU, with the program broken underneath by each fault that the cell's
driver declares, must come out not correct.  The cells' own limits hold,
set at the cells' sizes on the card."""

from __future__ import annotations

import time

import pytest

from portbench import faults
from portbench.harness import cell, manifest

BENCH = manifest.Manifest()
CASES = [(w["name"], name) for w in BENCH.data["workloads"]
         for name in BENCH.driver(w["name"]).faults(BENCH.traffic(w["traffic"]))]


def _planted(workload, fault):
    return faults.planted(BENCH.driver(workload), fault, BENCH.traffic(BENCH.workload(workload)["traffic"]))


def _run(workload):
    return cell.run(workload, 2**31 + 101, 1.0, False, "cpu", time.perf_counter(), BENCH)


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_planted_fault_is_not_correct(small, workload, fault):
    with _planted(workload, fault):
        out, _ = _run(workload)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH.data["workloads"]])
def test_the_sound_run_reads_below_its_faults(small, workload):
    out, _ = _run(workload)
    sound = out["checks"]
    grossest = next(iter(BENCH.driver(workload).faults(BENCH.traffic(BENCH.workload(workload)["traffic"]))))
    with _planted(workload, grossest):
        broken = _run(workload)[0]["checks"]
    assert max(broken[k]["value"] / max(sound[k]["value"], 1e-12) for k in sound) > 3
