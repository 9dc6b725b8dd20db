"""Checkpoints: model, optimizer, schedule and step in one ``torch.save``
file per saved step, with auto-resume; counterpart of
``bts_tpu/utils/checkpoint.py`` (orbax there).

``<directory>/<step>.pt`` holds ``Trainer.state_dict()``; the newest
``max_to_keep`` files are kept.  A file is written under a temporary name
and renamed, so a run killed while saving leaves the previous checkpoint
whole.  ``--retrain`` (``restore_for_retrain``) restores the weights and BN
statistics and leaves the step, optimizer and schedule fresh.
"""

from __future__ import annotations

import os
from typing import List, Optional

import torch


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        names = (n[: -len(".pt")] for n in os.listdir(self.directory) if n.endswith(".pt"))
        return sorted(int(n) for n in names if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: dict) -> str:
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, step: Optional[int] = None, map_location="cpu") -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        return torch.load(self.path(step), map_location=map_location, weights_only=True)


def restore_for_retrain(mgr: CheckpointManager, trainer) -> None:
    """--retrain semantics: restore weights and BN statistics into
    ``trainer``'s model; step, optimizer and schedule stay fresh."""
    trainer.model.load_state_dict(mgr.restore()["model"])
