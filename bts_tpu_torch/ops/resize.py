"""Nearest-neighbour x2 upsampling feeding each decoder ``upconv`` stage;
counterpart of ``bts_tpu/ops/resize.py::upsample_nearest_2x`` in NCHW."""

from __future__ import annotations

import torch


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), each pixel repeated in a 2x2 block."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)
