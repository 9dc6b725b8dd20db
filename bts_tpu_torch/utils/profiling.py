"""torch.profiler windows whose device records are this window's, all of
them, and the spans the port opens inside them.

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
  left over from an earlier window cannot be counted; a window that lists
  none of its kernels (still seen once with the forced flush) is run
  again.  A kernel launched
  outside every op is not seen: each of the port's kernels launches inside
  its torch.library op, and a cast launches inside ``aten::to``.

The port names its layers with :func:`span`: a ``record_function`` range,
opened only while a profiler records, so the spans reach whoever runs the
profiler (``window``, ``bts_main --profile``, a benchmark's traced window)
on the profiler's clock, beside the ops whose kernels they hold.  The
profiler's records are their only store.  The names, each opened at one
place:

- ``bts.predict`` (ident: the batch's ordinal), ``cli/bts_test.py``: one
  batch of ``predict`` / ``predict_banded``;
- ``bts.train_step`` (ident: the step), ``training/trainer.py``: one step;
- ``bts.input``: upload and preprocessing, or augmentation;
- ``bts.encoder``, ``bts.decoder``: ``models/bts.py::BtsModel.forward``
  (remat's recompute runs in the backward, inside ``bts.backward``);
- ``bts.lpg``: the LPG heads inside the decoder (plane maths, K1, the
  strided guidance, or K5 and K6 on the fused tail);
- ``bts.loss``: the silog loss and the step's logged loss and depth;
- ``bts.backward``: the backward (autograd's threads run it while the
  calling thread waits inside the span) and the gradient all-reduce;
- ``bts.optimizer``: zero_grad, the gradient norm, AdamW and the schedule.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path
from typing import Callable, Iterable, Optional

import torch
from torch.autograd import _profiler_enabled

CUPTI_ACTIVITY_FLAG_FLUSH_FORCED = 1
WINDOWS = 3  # launched_kernels: windows tried before one that lost records is returned
_CLOSED = contextlib.nullcontext()  # what span returns while no profiler records


def span(name: str, ident: Optional[object] = None):
    """A context naming a layer of the port in the profiler's records: a
    ``record_function(name, ident)`` while a profiler records, outside
    ``torch.compile`` and ``torch.export`` tracing; otherwise one shared
    no-op (~0.7 us a use against ~12 us for an unguarded
    ``record_function``, NVIDIA H100 host)."""
    if not _profiler_enabled() or torch.compiler.is_compiling():
        return _CLOSED
    return torch.profiler.record_function(name, None if ident is None else str(ident))


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
def window(device="cuda"):
    """A torch.profiler window over the CPU and, for a CUDA ``device``, the
    card; on leaving it the card is synchronised and CUPTI's buffers are
    flushed by force."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
            err = _cupti().cuptiActivityFlushAll(CUPTI_ACTIVITY_FLAG_FLUSH_FORCED)
            if err:
                raise RuntimeError(f"cuptiActivityFlushAll failed: CUPTI error {err}")


def launched_kernels(fn: Callable[[], object], ops: Iterable[str] = ()) -> dict:
    """One call of ``fn`` (after one call outside the window) in a
    ``window``: ``kernels``, the names of the device kernels its ops
    launched, and ``by_op``, for each op named in ``ops`` the kernels
    launched inside each of its calls.  A device record counts where its
    linked correlation id is that of an op of the window (the profiler's
    own records: an op has linked id 0, a kernel its op's id).

    A window that lists no kernel at all, or none under some call of an op
    named in ``ops``, lost records (every caller's ``fn`` launches kernels,
    and a forced flush still missed them now and then on an H100): it is
    run again, up to ``WINDOWS`` windows, and the last one is returned;
    ``windows`` says how many ran."""
    fn()
    torch.cuda.synchronize()
    for n in range(1, WINDOWS + 1):
        result = _one_window(fn, tuple(ops))
        if result["kernels"] and all(all(calls) for calls in result["by_op"].values()):
            break
    return dict(result, windows=n)


def _one_window(fn: Callable[[], object], ops: tuple) -> dict:
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
