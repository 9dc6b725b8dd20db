"""Test/eval-time preprocessing; counterpart of the eval part of
``bts_tpu/data/augment.py``.  Training augmentation is not ported yet
(ROADMAP.md, training slice).  Layout NHWC, as the JAX functions."""

from __future__ import annotations

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_image(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB (..., 3) -> ImageNet-normalized, f32."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=img.device)
    return (img - mean) / std


def eval_preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> [0, 1] -> ImageNet-normalized f32 (B, H, W, 3)."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    return normalize_image(images)
