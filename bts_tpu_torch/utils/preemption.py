"""Preemption-safe training: SIGTERM -> finish the step -> checkpoint -> exit 0;
counterpart of ``bts_tpu/utils/preemption.py`` for one process.

    SIGTERM -> finish the in-flight step -> final checkpoint
            -> exit 0 (the scheduler restarts the command; sample-exact
               resume continues the data stream at the saved step)

The JAX package ORs the stop flag over processes at a fixed step cadence;
the port trains on one process until data parallelism is ported
(ROADMAP.md), and a multi-process guard raises.
"""

from __future__ import annotations

import signal
from typing import Iterable


class PreemptionGuard:
    """Install signal handlers that request a cooperative training stop.
    Only the main thread may install signal handlers (CPython's rule)."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,)):
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            raise NotImplementedError(
                "the multi-process preemption stop is not ported to bts_tpu_torch yet "
                "(ROADMAP.md, 'DDP/ZeRO')"
            )
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
        return self._flag

    def should_stop(self, step: int) -> bool:
        """True once a signal has arrived (one process: no cadence needed)."""
        return self._flag

    def uninstall(self) -> None:
        """Restore the previous handlers."""
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()
