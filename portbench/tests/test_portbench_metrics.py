"""The benchmark's arithmetic on synthetic records, and the manifest: every
cell is built from its files by name."""

from __future__ import annotations

import json
import math

import pytest

from portbench.counts import lpg
from portbench.harness import cell, manifest, stats
from portbench.harness.trace import Trace, breakdown


def test_percentile_is_nearest_rank():
    values = list(range(1, 101))  # 1 .. 100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values[::-1], 50) == 50
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(list(range(1, 21)), 95) == 19  # ceil(0.95 * 20) = 19th
    with pytest.raises(ValueError):
        stats.percentile([], 95)


def test_rate_is_all_work_over_all_time():
    assert stats.rate(300, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_busy_time_is_the_union_not_the_sum():
    # three kernels on several streams, overlapping: the sum of their
    # durations (5.0) exceeds the 4.0 s window; the union is 3.0
    intervals = [(0.0, 2.0), (1.0, 3.0), (1.5, 2.5)]
    assert sum(e - s for s, e in intervals) == 5.0
    assert stats.covered(intervals, 0.0, 4.0) == 3.0
    assert stats.covered(intervals, 1.0, 2.0) == 1.0  # clipped to the window
    assert stats.covered([(0, 1), (1, 2)], 0, 2) == 2  # touching, not double


def test_gaps_are_the_uncovered_parts_longest_first():
    assert stats.gaps([(1.0, 2.0), (2.5, 3.0)], 0.0, 5.0) == [(3.0, 5.0), (0.0, 1.0), (2.0, 2.5)]
    assert stats.gaps([(0.0, 5.0)], 0.0, 5.0) == []


def _trace():
    # ops 11 and 12 run in the window; device records link to them by id,
    # one record links to an op of an earlier window (99), one is a copy
    ops = [("aten::conv", 0.0, 1.0, 11), ("bts_tpu_torch::lpg_fused_fwd", 1.0, 2.0, 12)]
    device = [
        ("cudnn_fprop", 0.5, 1.5, 11),
        ("void lpg_fwd_kernel<true, 8, 4, 4, __nv_bfloat16>(args)", 1.4, 1.6, 12),
        ("void lpg_fwd_kernel<true, 4, 4, 8, __nv_bfloat16>(args)", 1.7, 1.8, 12),
        ("left_over_kernel", 0.1, 0.2, 99),
        ("Memcpy DtoH (Device -> Pageable)", 2.0, 2.5, 12),
    ]
    return Trace((0.0, 4.0), device, ops)


def test_kernels_link_by_correlation_id():
    names = [n for n, _, _ in _trace().kernels()]
    assert names == ["cudnn_fprop", "void lpg_fwd_kernel<true, 8, 4, 4, __nv_bfloat16>(args)",
                     "void lpg_fwd_kernel<true, 4, 4, 8, __nv_bfloat16>(args)"]


def read(name, rec):
    return manifest.reader(name)(rec)


def test_readers_on_a_synthetic_window():
    tr = _trace()
    rec = {"kind": "serve", "trace": tr, "trace_images": 2, "images": 30, "window_s": 10.0,
           "latencies_s": [0.01 * i for i in range(1, 101)], "enqueue_s": [0.002, 0.004],
           "device_name": "NVIDIA H100 80GB HBM3", "model": {"compute_dtype": "bfloat16"},
           "flops_per_image": 989e12 / 100, "batch": 1, "height": 64, "width": 96}
    busy = stats.covered([(0.1, 0.2), (0.5, 1.6), (1.7, 1.8), (2.0, 2.5)], 0.0, 4.0)
    for kind in ("serve", "train"):
        assert read(f"device.launches_per_image.{kind}", rec) == 3 / 2
        # busy per traced image against the untraced window's 1/3 s per image
        assert read(f"device.idle_pct.{kind}", rec) == pytest.approx(100 * (1 - busy / 2 / (10.0 / 30)))
        assert read(f"driver.enqueue_ms.{kind}", rec) == pytest.approx(3.0)
        assert read(f"model.mfu.{kind}", rec) == pytest.approx(3.0)  # 3 images/s at 1/100 of the peak's FLOP
    assert tr.busy_s() == pytest.approx(busy)
    assert read("serve_images_per_s", rec) == 3.0
    assert read("train_images_per_s", rec) is None
    assert read("frame_latency_ms_p95", rec) == pytest.approx(950.0)
    # K1 at k = 8 and k = 4 on a 1 x 64 x 96 frame, bound by their bytes
    bound = sum(max(f / 67e12, b / 3.35e12) for f, b in (lpg.k1(1, 64, 96, k, 2) for k in (8, 4)))
    assert read("kernels.lpg_roofline.serve", rec) == pytest.approx(100 * bound / 0.3)
    assert read("kernels.lpg_roofline.train", rec) == pytest.approx(100 * bound / 0.3)
    rec["device_name"] = "a card without a table entry"
    assert read("model.mfu.serve", rec) is None and read("kernels.lpg_roofline.serve", rec) is None


def test_readers_find_nothing_without_a_trace():
    rec = {"kind": "train", "trace": None, "enqueue_s": [], "images": 3, "window_s": 1.0}
    assert read("device.launches_per_image.train", rec) is None
    assert read("device.idle_pct.train", rec) is None
    assert read("driver.enqueue_ms.train", rec) is None


def test_breakdown_names_device_ops_and_idle_gaps():
    b = breakdown(_trace(), top=2)
    assert [n for n, _ in b["device_ops"]] == ["cudnn_fprop", "Memcpy DtoH (Device -> Pageable)"]
    assert b["idle_gaps"][0] == ["(no host op)", pytest.approx(1.5)]  # 2.5 .. 4.0
    assert len(b["device_ops"]) <= 2 and len(b["idle_gaps"]) <= 2


BENCH = manifest.Manifest()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH.data["workloads"]])
def test_every_cell_is_built_from_its_files_by_name(workload):
    drv, _ = cell.driver(workload, 2**31 + 5, "cpu", BENCH)
    w = BENCH.workload(workload)
    assert drv.m["name"] == w["config"]
    limits = BENCH.limits(workload)
    assert limits and all(v > 0 for v in limits.values())
    e2e = {m["name"] for m in BENCH.end_to_end(workload)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = BENCH.per_layer(workload)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in BENCH.end_to_end(workload) + layer:
        assert callable(manifest.reader(m["name"]))


def test_manifest_keeps_the_contracts_shape():
    data = BENCH.data
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in data["end_to_end"] + data["per_layer"]]
    assert len(names) == len(set(names))
    for c in data["configs"]:
        assert json.loads((BENCH.root / c["file"]).read_text())["name"] == c["name"]
    for m in data["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert math.isclose(sum(w["chips"] for w in data["workloads"]), len(data["workloads"]))
