"""torch.profiler windows whose device records are this window's, all of them.

On a CUDA card torch.profiler reads kernel records from CUPTI, which hands
them over in buffers.  The flush at the end of a window returns only the
buffers whose records are all complete (CUPTI's default flush), so a record
still being completed waits for a later flush: one window then lists none
of its own kernels and the next lists a kernel it never launched (seen on
an H100 with torch 2.11 after many timed launches).  Two remedies, used by
every kernel count of the port's checks:

- ``window`` forces the flush (``cuptiActivityFlushAll`` with
  ``CUPTI_ACTIVITY_FLAG_FLUSH_FORCED``) after synchronising, before the
  window stops, so every record of its launches is delivered in it;
- ``launched_kernels`` counts only the device kernels that the profiler
  links (by correlation id) to an op called in the window, so a record
  left over from an earlier window cannot be counted.  A kernel launched
  outside every op is not seen: each of the port's kernels launches inside
  its torch.library op, and a cast launches inside ``aten::to``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path
from typing import Callable, Iterable

import torch

CUPTI_ACTIVITY_FLAG_FLUSH_FORCED = 1


@functools.lru_cache(maxsize=None)
def _cupti():
    """The CUPTI library torch.profiler loaded into this process."""
    maps = Path("/proc/self/maps")
    paths = [line.split()[-1] for line in maps.read_text().splitlines() if "libcupti" in line]
    if not paths:
        raise RuntimeError("no CUPTI library in this process: torch.profiler cannot trace the card")
    lib = ctypes.CDLL(paths[0])
    lib.cuptiActivityFlushAll.argtypes = [ctypes.c_uint32]
    lib.cuptiActivityFlushAll.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def window():
    """A torch.profiler window over the CPU and the card; on leaving it the
    card is synchronised and CUPTI's buffers are flushed by force."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
        err = _cupti().cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)
        if err:
            raise RuntimeError(f"cuptiActivityFlushAll failed: CUPTI error {err}")


def launched_kernels(fn: Callable[[], object], ops: Iterable[str] = ()) -> dict:
    """One call of ``fn`` (after one call outside the window) in a
    ``window``: ``kernels``, the names of the device kernels its ops
    launched, and ``by_op``, for each op named in ``ops`` the kernels
    launched inside each of its calls.  A device record counts where its
    linked correlation id is that of an op of the window (the profiler's
    own records: an op has linked id 0, a kernel its op's id)."""
    fn()
    torch.cuda.synchronize()
    with window() as prof:
        fn()
    records = prof.profiler.kineto_results.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    op_ids = {r.correlation_id() for r in records if r.device_type() == cpu and r.linked_correlation_id() == 0}
    op_ids.discard(0)
    device = [(r.name(), r.linked_correlation_id()) for r in records if r.device_type() == cuda]

    def names(within: set) -> list:
        return [name for name, op in device if op in within]

    def subtree(e) -> set:  # the op ids of a CPU event and its descendants
        return ({e.id} & op_ids).union(*(subtree(c) for c in e.cpu_children))

    return {"kernels": names(op_ids),
            "by_op": {op: [names(subtree(e)) for e in prof.events() if e.name == op] for op in ops}}
