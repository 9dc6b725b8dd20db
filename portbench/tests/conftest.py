"""Shared fixtures of the benchmark's own tests: ``small`` shrinks every
configuration and traffic mix to a size the CPU runs in seconds (the
widths stay; the frames, crops, pools and batches shrink, each traffic mix
by its driver's ``shrink``)."""

from __future__ import annotations

import copy
import importlib
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench.harness import manifest  # noqa: E402

CROP_HW = (64, 96)


@pytest.fixture
def small(monkeypatch):
    config, traffic = manifest.Manifest.config, manifest.Manifest.traffic

    def small_config(self, name):
        c = copy.deepcopy(config(self, name))
        c["train"].update(input_height=CROP_HW[0], input_width=CROP_HW[1])
        return c

    def small_traffic(self, name):
        t = traffic(self, name)
        return importlib.import_module(f"portbench.drivers.{t['driver']}").shrink(copy.deepcopy(t))

    monkeypatch.setattr(manifest.Manifest, "config", small_config)
    monkeypatch.setattr(manifest.Manifest, "traffic", small_traffic)
    torch.set_num_threads(min(4, torch.get_num_threads()))


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
