"""Best online-eval metric tracking and best-checkpoint retention;
counterpart of ``bts_tpu/evaluation/best.py``.

``bts_main`` keeps the best value of each of the 9 metrics across online
evals (silog .. log_rms lower is better, d1 .. d3 higher) and, on an
improvement, a per-metric "best" checkpoint that replaces the previous one.
The best values persist in a JSON sidecar beside the checkpoints, so a
resumed run competes against its own history; each improved metric gets a
``CheckpointManager(max_to_keep=1)`` under ``ckpt_best/<metric>/`` holding
the weights only, ``{"model": state_dict, "step": step}``, which
``utils/weights.py::read_weights`` restores.
"""

from __future__ import annotations

import json
import math
import os
import shutil
from typing import Dict, List, Sequence

from bts_tpu_torch.evaluation.metrics import METRIC_NAMES

# silog..log_rms improve downward; d1/d2/d3 (delta accuracies) upward
LOWER_BETTER = frozenset(METRIC_NAMES[:6])
HIGHER_BETTER = frozenset(METRIC_NAMES[6:])


class BestTracker:
    """Track per-metric best eval values across a run, persisted to JSON."""

    def __init__(self, logdir: str, filename: str = "best_eval.json"):
        self.path = os.path.join(logdir, filename)
        self.best: Dict[str, dict] = {}
        if os.path.exists(self.path):
            try:
                with open(self.path) as f:
                    self.best = json.load(f)
            except (json.JSONDecodeError, OSError):
                self.best = {}

    def update(self, step: int, results: Sequence[float], persist: bool = True) -> List[str]:
        """Record one eval's 9-metric results (ordered like METRIC_NAMES);
        return the improved metric names.  Non-finite values never count.

        ``persist=False`` defers the sidecar write to an explicit
        :meth:`persist`: ``bts_main`` writes the sidecar only after the
        matching best checkpoints are on disk, so a crash between the two
        cannot leave a bar that (strict </> on resume) suppresses re-saving a
        best that was never stored.
        """
        improved = []
        for name, value in zip(METRIC_NAMES, results):
            value = float(value)
            if not math.isfinite(value):
                continue
            prev = self.best.get(name)
            better = (
                prev is None
                or (name in LOWER_BETTER and value < prev["value"])
                or (name in HIGHER_BETTER and value > prev["value"])
            )
            if better:
                self.best[name] = {"value": value, "step": int(step)}
                improved.append(name)
        if improved and persist:
            self.persist()
        return improved

    def persist(self) -> None:
        """Atomically write the current bar to the JSON sidecar."""
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.best, f, indent=1)
        os.replace(tmp, self.path)

    def reset(self) -> None:
        """Drop the bar and delete the sidecar (``--retrain`` into a reused
        logdir: a step-0 run must not compete against the old run's bests)."""
        self.best = {}
        if os.path.exists(self.path):
            os.remove(self.path)


class BestCheckpoints:
    """One ``max_to_keep=1`` manager per improved metric, made when first
    needed under ``root/<metric>/``: a later best replaces the previous one."""

    def __init__(self, root: str):
        self.root = root
        self._mgrs: Dict[str, object] = {}

    def save(self, metrics: Sequence[str], step: int, model) -> None:
        """Save the weights of ``model`` for each improved metric and return
        once every file is written.  One copy of the ``state_dict`` to the
        CPU per eval, however many metrics improved; the optimizer is left
        out (the per-metric best files of the reference hold weights only)."""
        from bts_tpu_torch.utils.checkpoint import CheckpointManager

        host = {"model": {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()},
                "step": int(step)}
        for name in metrics:
            mgr = self._mgrs.get(name)
            if mgr is None:
                mgr = self._mgrs[name] = CheckpointManager(os.path.join(self.root, name), max_to_keep=1)
            mgr.save(step, host)

    def reset(self) -> None:
        """Delete all per-metric best checkpoints (``--retrain`` counterpart
        of :meth:`BestTracker.reset`)."""
        self._mgrs.clear()
        if os.path.isdir(self.root):
            shutil.rmtree(self.root)
