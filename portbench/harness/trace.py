"""The traced window: ``torch.profiler`` over the host's ops and the card,
its records reduced to plain lists that the per-layer readers take.

Tracing slows the host: at b1 a frame's wall time grows ~1.5x, with the
card's activity traced alone as with the host's ops too (NVIDIA H100 80GB
HBM3), while the card's busy time per image stays put.  So a reader takes
the card's busy time per image from the trace and any wall time from the
untraced window (:func:`traced` returns the traced loop's own time, for
the slowdown).

On a CUDA card torch.profiler reads kernel records from CUPTI, which hands
them over in buffers; at the end of a window its default flush returns
only the buffers whose records are all complete, so a window can miss its
own last kernels and the next one list them.  So :func:`window` forces the
flush (``cuptiActivityFlushAll`` with the forced flag) after synchronising,
before the window stops, and a kernel counts only where the profiler links
it by correlation id to an op called in the window.  (The same remedy as
``bts_tpu_torch/utils/profiling.py``, copied here so that the yardstick
does not change with the program.)
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Tuple

import torch

from . import stats

CUPTI_ACTIVITY_FLAG_FLUSH_FORCED = 1
LABEL = "portbench.window"  # the record_function around the traced loop
NOT_KERNELS = ("Memcpy", "Memset")


@functools.lru_cache(maxsize=None)
def _cupti():
    """The CUPTI library that torch.profiler loaded into this process."""
    maps = Path("/proc/self/maps").read_text().splitlines()
    paths = [line.split()[-1] for line in maps if "libcupti" in line]
    if not paths:
        raise RuntimeError("no CUPTI library in this process: torch.profiler cannot trace the card")
    lib = ctypes.CDLL(paths[0])
    lib.cuptiActivityFlushAll.argtypes = [ctypes.c_uint32]
    lib.cuptiActivityFlushAll.restype = ctypes.c_int
    return lib


@dataclass
class Trace:
    """A traced window's records, times in seconds on the profiler's clock."""

    window: Tuple[float, float]
    device: List[Tuple[str, float, float, int]] = field(default_factory=list)  # name, start, end, linked id
    ops: List[Tuple[str, float, float, int]] = field(default_factory=list)  # name, start, end, correlation id

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        return stats.covered([(s, e) for _, s, e, _ in self.device], *self.window)

    def kernels(self) -> List[Tuple[str, float, float]]:
        """The device kernels launched by ops of the window (no copies)."""
        op_ids = {c for _, _, _, c in self.ops if c}
        return [(n, s, e) for n, s, e, c in self.device if c in op_ids and not n.startswith(NOT_KERNELS)]


def _flush() -> None:
    err = _cupti().cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)
    if err:
        raise RuntimeError(f"cuptiActivityFlushAll failed: CUPTI error {err}")


def traced(device, loop) -> dict:
    """Run ``loop()`` (which returns {'images', 'window_s', ...}) traced:
    the :class:`Trace` (``trace``), the loop's images (``trace_images``)
    and its own seconds (``trace_loop_s``)."""
    with window(device) as got:
        rec = loop()
    return {"trace": got[0], "trace_images": rec["images"], "trace_loop_s": rec["window_s"]}


@contextlib.contextmanager
def window(device):
    """Profile the body; yields a list that holds the :class:`Trace` once
    the body has run (the card synchronised, CUPTI flushed by force)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out: list = []
    with profile(activities=activities) as prof:
        with record_function(LABEL):
            yield out
            if cuda:
                torch.cuda.synchronize()
        if cuda:
            _flush()
    out.append(records(prof))


def records(prof) -> Trace:
    events = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    device, ops, win = [], [], None
    for r in events:
        s = r.start_ns() * 1e-9
        e = s + r.duration_ns() * 1e-9
        name = r.name()
        if r.device_type() == cuda:
            if not r.is_user_annotation():  # a record_function's mirror on the device timeline is no work
                device.append((name, s, e, r.linked_correlation_id()))
        elif r.device_type() == cpu:
            if name == LABEL:
                win = (s, e)
            elif r.linked_correlation_id() == 0:
                ops.append((name, s, e, r.correlation_id()))
    if win is None:
        raise RuntimeError(f"the traced window holds no {LABEL} record")
    return Trace(win, device, ops)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and the
    ``top`` longest gaps in which the device ran nothing, each named by what
    the host was doing then (the innermost op running at its midpoint)."""
    by_op: dict = {}
    for name, s, e, _ in trace.device:
        inside = min(e, trace.window[1]) - max(s, trace.window[0])
        if inside > 0:
            by_op[name[:160]] = by_op.get(name[:160], 0.0) + inside
    idle = []
    for lo, hi in stats.gaps([(s, e) for _, s, e, _ in trace.device], *trace.window)[:top]:
        mid = (lo + hi) / 2
        inner = [o for o in trace.ops if o[1] <= mid <= o[2]]
        idle.append([min(inner, key=lambda o: o[2] - o[1])[0][:160] if inner else "(no host op)", hi - lo])
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}
