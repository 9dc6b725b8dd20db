"""The card: presence, name, power limit; and the modules a run must not
have loaded."""

from __future__ import annotations

import shutil
import subprocess
import sys
from typing import List, Optional

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "bts_tpu")  # top-level module names, compared whole


def require(chips: int) -> None:
    """Exit with code 3, printing no result, unless ``chips`` CUDA cards are here."""
    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA card (torch.cuda.is_available() is False); the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        sys.exit(f"portbench: the cell needs {chips} cards, torch sees {torch.cuda.device_count()}")


def power_limit_w() -> Optional[float]:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run([smi, "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})
