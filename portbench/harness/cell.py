"""One run of one cell: set-up, the window, the traced window (``trace``),
the check against the reference, and the result line's fields."""

from __future__ import annotations

import time

import numpy as np
import torch

from . import manifest, program
from .trace import breakdown


def seeds(seed: int) -> dict:
    """Independent streams from the run's seed (any whole number >= 0)."""
    s = np.random.SeedSequence(seed).generate_state(4)
    return dict(zip(("program", "weights", "inputs", "sample"), (int(x) for x in s)))


def driver(workload: str, seed: int, device, bench=None):
    """The cell's driver, built from its files, and the manifest."""
    bench = bench or manifest.Manifest()
    w = bench.workload(workload)
    return bench.driver(workload).Driver(bench.config(w["config"]), bench.traffic(w["traffic"]), seeds(seed),
                                         device), bench


def run(workload: str, seed: int, seconds: float, trace: bool, device, t0: float, bench=None):
    """(the result line's fields, notes for standard error); ``t0`` is the
    process's start on ``time.perf_counter``'s clock."""
    before_s = time.perf_counter() - t0  # imports and the interpreter
    drv, bench = driver(workload, seed, device, bench)
    cuda = torch.device(device).type == "cuda"
    build_s = program.build_kernels() if cuda else 0.0
    t_setup = time.perf_counter()
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    driver_setup_s = time.perf_counter() - t_setup
    rec = drv.window(seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec.update(kind=drv.kind, setup_s=setup_s, build_s=build_s, window_peak_bytes=window_peak)
    if trace:
        rec.update(drv.traced())
    peak = max(setup_peak, torch.cuda.max_memory_allocated()) if cuda else 0
    from ..counts import flops  # after the window: FlopCounterMode brings sympy, seconds of imports

    b, h, w = drv.heads()
    rec.update(batch=b, height=h, width=w, model=drv.m["model"],
               flops_per_image=flops.per_image(drv.m["model"], drv.kind, h, w),
               device_name=torch.cuda.get_device_name(device) if cuda else "cpu")
    drv.free()
    checks = drv.check()
    limits = bench.limits(workload)
    correct = all(k in checks and checks[k] <= v for k, v in limits.items())

    metrics = {}
    for m in (bench.per_layer(workload) if trace else bench.end_to_end(workload)):
        value = manifest.reader(m["name"])(rec)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} read nothing")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": correct, "attempted": len(rec["enqueue_s"]), "failed": 0, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu", "kind": rec["device_name"],
                      "count": 1, "memory_peak_bytes": peak}}
    if trace:
        tr = rec["trace"]
        out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = breakdown(tr)
    out["checks"] = {k: {"value": checks[k], "limit": v} for k, v in limits.items() if k in checks}
    notes = {"imports_s": before_s, "build_s": build_s, "driver_setup_s": driver_setup_s, "setup_s": setup_s,
             **{k: v for k, v in checks.items() if k not in limits}}
    if trace:  # how much slower a traced image is than an untraced one
        notes["trace_slowdown"] = (rec["trace_loop_s"] / rec["trace_images"]) / (rec["window_s"] / rec["images"])
    return out, notes
