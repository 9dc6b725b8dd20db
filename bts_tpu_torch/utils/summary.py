"""TensorBoard logging; the port's copy of ``bts_tpu/utils/summary.py``.

Scalars (loss / lr / grad norm / images per second) and image summaries of
depth maps, through tensorboardX when it is importable; without it the
writer records nothing.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SummaryWriter:
    def __init__(self, logdir: str):
        try:
            from tensorboardX import SummaryWriter as TBWriter
        except ImportError:
            self._w = None
        else:
            self._w = TBWriter(logdir)

    def scalars(self, step: int, values: Dict[str, float]) -> None:
        if self._w is None:
            return
        for k, v in values.items():
            self._w.add_scalar(k, float(v), step)

    def depth_image(self, step: int, tag: str, depth: np.ndarray, max_depth: Optional[float] = None) -> None:
        """Log a depth map as a normalized grayscale image (HW array)."""
        if self._w is None:
            return
        d = np.asarray(depth, np.float32)
        hi = float(max_depth) if max_depth else max(float(d.max()), 1e-6)
        img = np.clip(d / hi, 0, 1)[None]  # CHW
        self._w.add_image(tag, img, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
