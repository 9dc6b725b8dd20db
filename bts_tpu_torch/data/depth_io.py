"""16-bit PNG depth encode/decode with the reference scaling conventions.

The port's copy of ``bts_tpu/data/depth_io.py`` (numpy, Pillow).

SURVEY.md §2.2/§2.10: KITTI depth PNGs store ``uint16 = meters * 256``;
NYU-Depth-v2 stores ``uint16 = meters * 1000``.  Predictions are written back
with the same scaling by ``bts_test.py``.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

DEPTH_SCALE = {"kitti": 256.0, "nyu": 1000.0}


def depth_scale_for(dataset: str) -> float:
    try:
        return DEPTH_SCALE[dataset]
    except KeyError:
        raise ValueError(f"unknown dataset {dataset!r}; expected kitti|nyu") from None


def depth_to_png(depth_m: np.ndarray, dataset: str) -> np.ndarray:
    """Meters (float) -> uint16 PNG values, clipped to the uint16 range."""
    scaled = np.asarray(depth_m, dtype=np.float64) * depth_scale_for(dataset)
    return np.clip(np.round(scaled), 0, 65535).astype(np.uint16)


def depth_from_png(png_values: np.ndarray, dataset: str) -> np.ndarray:
    """uint16 PNG values -> meters (float32)."""
    return np.asarray(png_values, dtype=np.float32) / depth_scale_for(dataset)


def write_depth_png(path: str, depth_m: np.ndarray, dataset: str) -> None:
    Image.fromarray(depth_to_png(depth_m, dataset)).save(path)


def read_depth_png(path: str, dataset: str) -> np.ndarray:
    arr = np.array(Image.open(path))
    return depth_from_png(arr, dataset)
