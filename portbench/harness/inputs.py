"""The one generator of the benchmark's inputs, driven by a traffic file's
parameters and the run's seed.

Frames are uint8 (N, H, W, 3): a smooth colour field (a coarse random grid,
bilinearly upsampled) plus pixel noise, so that the encoder sees edges and
texture rather than white noise.  Depth is (N, H, W) float32: ``sparse``
(KITTI's LiDAR: a share of the pixels uniform in [low, high), the rest 0,
no return) or ``dense`` (NYU's Kinect: every pixel uniform in [low, high)).
Everything is drawn on ``device`` from one ``torch.Generator`` and then
copied to pinned host memory, where the program's feed finds it.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

GRID = 32  # pixels per cell of the coarse colour grid
NOISE = 12.0  # standard deviation of the pixel noise, in uint8 steps


def frames(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    coarse = torch.rand(n, 3, max(h // GRID, 2), max(w // GRID, 2), generator=gen, device=device) * 255.0
    img = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    img = img + torch.randn(n, 3, h, w, generator=gen, device=device) * NOISE
    return img.clamp_(0.0, 255.0).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def depths(gen: torch.Generator, n: int, h: int, w: int, spec: dict, device) -> torch.Tensor:
    lo, hi = spec["low"], spec["high"]
    d = lo + (hi - lo) * torch.rand(n, h, w, generator=gen, device=device)
    if spec["kind"] == "sparse":
        d = torch.where(torch.rand(n, h, w, generator=gen, device=device) < spec["fraction"], d, 0.0)
    elif spec["kind"] != "dense":
        raise ValueError(f"depth kind must be sparse or dense, got {spec['kind']!r}")
    return d


def pinned(t: torch.Tensor) -> torch.Tensor:
    host = t.cpu()
    return host.pin_memory() if torch.cuda.is_available() else host


def serve_pool(traffic: dict, focal: float, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """The batches the window cycles through: ``pool_frames`` distinct frames
    in batches of ``batch``.  With ``clips`` = batch > 1, batch t holds frame
    t of each clip, clip c being pool frames [c*L, (c+1)*L), L = pool/batch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n, b = traffic["pool_frames"], traffic["batch"]
    if n % b:
        raise ValueError(f"pool_frames {n} is not a multiple of batch {b}")
    pool = frames(gen, n, traffic["frame_height"], traffic["frame_width"], device)
    clip_len = n // b
    order = torch.arange(n, device=device).view(b, clip_len).t().reshape(-1)  # t-major: batch t, clip c
    pool = pinned(pool[order])
    focal_b = pinned(torch.full((b,), focal, dtype=torch.float32))
    return [{"image": pool[i * b:(i + 1) * b], "focal": focal_b} for i in range(clip_len)]


def train_pool(traffic: dict, focal: float, seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """``pool_batches`` distinct batches of ``batch`` frames with depth."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b, h, w = traffic["batch"], traffic["frame_height"], traffic["frame_width"]
    out = []
    for _ in range(traffic["pool_batches"]):
        out.append({"image": pinned(frames(gen, b, h, w, device)),
                    "depth": pinned(depths(gen, b, h, w, traffic["depth"], device)),
                    "focal": pinned(torch.full((b,), focal, dtype=torch.float32))})
    return out
