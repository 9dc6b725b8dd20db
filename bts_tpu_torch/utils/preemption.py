"""Preemption-safe training: SIGTERM -> finish the step -> checkpoint -> exit 0;
counterpart of ``bts_tpu/utils/preemption.py``.

    SIGTERM -> finish the in-flight step -> final checkpoint
            -> exit 0 (the scheduler restarts the command; sample-exact
               resume continues the data stream at the saved step)

Several processes may see the signal at different steps.  A rank that left
the loop a step early would leave the others waiting in the next collective
until the grace window kills the job, losing the checkpoint the guard exists
to write.  So with more than one process ``should_stop`` decides only at
every ``sync_freq``-th step, where every rank contributes its flag to a
global OR (a MAX all-reduce), and all ranks break at the same step.
"""

from __future__ import annotations

import signal
from typing import Iterable

import torch
import torch.distributed as dist

from bts_tpu_torch.parallel import distributed as parallel


class PreemptionGuard:
    """Install signal handlers that request a cooperative training stop.
    Only the main thread may install signal handlers (CPython's rule).
    ``device``: where the flag's all-reduce runs (a CUDA device for NCCL)."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,), sync_freq: int = 10,
                 device="cpu"):
        self.sync_freq = max(1, int(sync_freq))
        self.device = torch.device(device)
        self._flag = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._flag = True
        print(
            f"[bts_tpu_torch] received signal {signum}: will checkpoint and stop at "
            "the next step boundary",
            flush=True,
        )

    @property
    def preempted(self) -> bool:
        """This process's flag, for reporting after the loop."""
        return self._flag

    def should_stop(self, step: int) -> bool:
        """True when every process should break after ``step``: one process,
        its flag at once; several, the OR of every rank's flag, taken only
        when ``step % sync_freq == 0`` so that all ranks enter the
        all-reduce at the same step."""
        if parallel.world() == 1:
            return self._flag
        if step % self.sync_freq != 0:
            return False
        flag = torch.tensor([int(self._flag)], dtype=torch.int32, device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def uninstall(self) -> None:
        """Restore the previous handlers."""
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
