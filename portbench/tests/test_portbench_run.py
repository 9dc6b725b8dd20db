"""``portbench/run.py`` as the driver starts it: without a card it fails
and prints no result; in a directory that holds only ``BENCHMARK.json``
and the benchmark's files it fails; on a card one short run prints the
contract's line."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "densenet161_kitti.serve_b1", "--seed", str(2**31 + 3), "--seconds", "2"]


def _run(cwd: Path, *extra: str, timeout: int = 600):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS, *extra], cwd=cwd, capture_output=True,
                          text=True, timeout=timeout)


def _result(stdout: str):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_without_a_card_it_fails_and_prints_no_result():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = _run(ROOT, "--trace", "0")
    assert out.returncode != 0
    assert _result(out.stdout) is None
    assert "no CUDA card" in out.stderr


def test_with_only_the_benchmarks_files_it_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = _run(tmp_path, "--trace", "0")
    assert out.returncode != 0
    assert _result(out.stdout) is None


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_one_short_run_prints_the_contracts_line(card, trace):
    out = _run(ROOT, "--trace", trace)
    assert out.returncode == 0, out.stderr[-4000:]
    r = _result(out.stdout)
    assert list(r)[-1] == "checks" and r["correct"] is True
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace == "1":
        assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > r["device"]["busy_s"]
        assert "breakdown" in r and "model.mfu.serve" in r["metrics"]
    else:
        assert {"serve_images_per_s", "frame_latency_ms_p95", "peak_mem_gib", "setup_s"} <= set(r["metrics"])
    assert all(0 < m["value"] for m in r["metrics"].values())
