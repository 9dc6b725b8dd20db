"""Crop geometry contracts: KB-crop, garg/eigen eval crops, NYU border crop.

The port's copy of ``bts_tpu/data/crops.py`` (numpy only).

Reference behavior per SURVEY.md §2.10/§2.13:
- KB-crop (KITTI): crop to 352x1216 with ``top = h - 352``,
  ``left = (w - 1216) / 2`` — removes the hood/sky band and centers.
- garg crop (KITTI eval): valid-mask rows [0.40810811 h, 0.99189189 h),
  cols [0.03594771 w, 0.96405229 w).
- eigen crop (NYU eval): rows 45:471, cols 41:601.
- NYU border crop (train-time): image/depth cropped to rows 45:472,
  cols 43:608 to remove the white Kinect border.

All pure functions on numpy arrays, run once per sample on the host before
the device transfer.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

KB_CROP_HEIGHT = 352
KB_CROP_WIDTH = 1216


def kb_crop_box(height: int, width: int) -> Tuple[int, int, int, int]:
    """(top, left, h, w) of the KITTI KB-crop for a full-resolution image."""
    top = int(height - KB_CROP_HEIGHT)
    left = int((width - KB_CROP_WIDTH) / 2)
    return top, left, KB_CROP_HEIGHT, KB_CROP_WIDTH


def kb_crop(image: np.ndarray) -> np.ndarray:
    """Apply the KB-crop to an HWC (or HW) array."""
    top, left, h, w = kb_crop_box(image.shape[0], image.shape[1])
    return image[top : top + h, left : left + w]


def garg_crop_mask(height: int, width: int) -> np.ndarray:
    """Boolean KITTI garg-crop evaluation mask (True inside the crop)."""
    mask = np.zeros((height, width), dtype=bool)
    mask[
        int(0.40810811 * height) : int(0.99189189 * height),
        int(0.03594771 * width) : int(0.96405229 * width),
    ] = True
    return mask


def eigen_crop_mask(height: int, width: int, dataset: str = "nyu") -> np.ndarray:
    """Boolean eigen-crop evaluation mask.

    NYU: fixed pixel box 45:471, 41:601.  KITTI variant (eigen_crop flag with
    kitti) uses proportional rows like garg but cols 0.0359..0.9641.
    """
    mask = np.zeros((height, width), dtype=bool)
    if dataset == "nyu":
        mask[45:471, 41:601] = True
    else:
        mask[
            int(0.3324324 * height) : int(0.91351351 * height),
            int(0.0359477 * width) : int(0.96405229 * width),
        ] = True
    return mask


def nyu_border_crop(image: np.ndarray) -> np.ndarray:
    """NYU train-time border crop (rows 45:472, cols 43:608) for HWC/HW arrays."""
    return image[45:472, 43:608]
