"""Device time and launches per span of the program: the ``bts.*`` ranges
that ``bts_tpu_torch/utils/profiling.py::span`` opens while a profiler
records, found in the traced window's ops (:class:`trace.Trace`) on the
profiler's clock.

A kernel counts as :meth:`Trace.kernels` counts it (linked by correlation id
to an op of the window, copies left out) and goes to the innermost span
whose interval holds its op's start: a span's **self** time, its children's
kernels going to them.  Intervals, not threads, decide: the ops autograd's
threads run in the backward start inside ``bts.backward``, where the calling
thread waits.  Spans nest (each is a context of one thread, and no other
thread opens one while the calling thread runs).  A kernel whose op starts
in no span counts nowhere.  A trace of a program without spans has none:
every reader then reads None.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .trace import NOT_KERNELS, Trace

PREFIX = "bts."


def self_times(trace: Trace) -> Dict[str, Tuple[float, int]]:
    """{span name: (device seconds, launches)} of the kernels whose op
    starts inside a span of that name and inside none of its children."""
    spans = sorted(((s, e, n) for n, s, e, _ in trace.ops if n.startswith(PREFIX)), key=lambda x: (x[0], -x[1]))
    op_start = {c: s for _, s, _, c in trace.ops if c}
    kernels = sorted((op_start[c], e - s) for n, s, e, c in trace.device
                     if c in op_start and not n.startswith(NOT_KERNELS))
    out: Dict[str, Tuple[float, int]] = {}
    open_spans: list = []  # the spans holding the current time, innermost last
    i = 0
    for t, seconds in kernels:
        while i < len(spans) and spans[i][0] <= t:
            while open_spans and open_spans[-1][1] < spans[i][0]:
                open_spans.pop()
            open_spans.append(spans[i])
            i += 1
        while open_spans and open_spans[-1][1] < t:
            open_spans.pop()
        if open_spans:
            name = open_spans[-1][2]
            total, n = out.get(name, (0.0, 0))
            out[name] = (total + seconds, n + 1)
    return out


def _per_image(rec: dict, name: str, field: int):
    tr = rec.get("trace")
    got = self_times(tr).get(name) if tr is not None else None
    return got[field] / rec["trace_images"] if got is not None else None


def device_ms_per_image(rec: dict, name: str):
    """The self device ms per traced image of the span ``name``, or None."""
    got = _per_image(rec, name, 0)
    return got * 1e3 if got is not None else None


def launches_per_image(rec: dict, name: str):
    """The kernels launched per traced image inside the span ``name`` and
    none of its children, or None."""
    return _per_image(rec, name, 1)
