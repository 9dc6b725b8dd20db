"""The control at a size a test run holds: the plain reference with every
conv operand in fp8, in the program's place, must read above the
program's sound run and fail the cell's limits (on the card the same
readings are taken at the cells' own sizes by ``portbench/control.py``)."""

from __future__ import annotations

import pytest

from portbench import control
from portbench.harness import manifest

BENCH = manifest.Manifest()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH.data["workloads"]])
def test_the_fp8_control_fails_where_the_program_passes(small, workload):
    sound = control.program_reading(workload, 2**31 + 7, 0.5, "cpu")
    fp8 = control.control_reading(workload, 2**31 + 7, "cpu")
    limits = BENCH.limits(workload)
    assert any(fp8[k] > limits[k] for k in limits), (fp8, limits)
    assert any(fp8[k] > sound[k] for k in limits), (fp8, sound)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH.data["workloads"]])
def test_the_fp8_control_fails_at_the_cells_size(card, workload):
    fp8 = control.control_reading(workload, 2**31 + 11, "cuda")
    limits = BENCH.limits(workload)
    assert any(fp8[k] > limits[k] for k in limits), (fp8, limits)
