"""The port's eval-mode BatchNorm kernel (K7) in a traced window, found by
its name as the profiler reports it (``bn_act_kernel<...>``)."""

from __future__ import annotations

KERNEL = "bn_act_kernel<"


def per_image(rec: dict):
    """(device ms, launches) of K7 per traced image, or None where the
    window holds no trace or no launch of it."""
    tr = rec.get("trace")
    times = [e - s for name, s, e in tr.kernels() if KERNEL in name] if tr is not None else []
    if not times:
        return None
    return 1e3 * sum(times) / rec["trace_images"], len(times) / rec["trace_images"]
