"""Input preparation in plain PyTorch: the eval preprocessing and the
training augmentation of BTS, worked out again from the raw frames.

Layout NHWC: images (B, H, W, 3) uint8, depths (B, H, W).  The training
chain (BTS's ``bts_dataloader.py``, on the card): a random rotation within
+-degree (image bilinear, depth nearest, zero fill, as three 1-D shears
about the centre), a random crop, a random left-right flip, and with
probability 1/2 the photometric jitter (gamma and brightness in
[0.9, 1.1] (NYU brightness [0.75, 1.25]), a colour per channel in
[0.9, 1.1]), then ImageNet normalisation.

The draws of step ``s`` come from a CPU ``torch.Generator`` seeded with
``numpy.random.SeedSequence([seed, s]).generate_state(1)[0]``, in the
order angle, top, left, flip, gate, gamma, brightness, colours: the rule
the system under test states for reproducible augmentation.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
SHEAR_MAX_SLICES = 128


def normalize(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, dtype=torch.float32, device=img.device)
    std = torch.tensor(STD, dtype=torch.float32, device=img.device)
    return (img - mean) / std


def eval_preprocess(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> normalised f32 (B, H, W, 3)."""
    return normalize(images.float() / 255.0)


def draws(seed: int, step: int, b: int, h: int, w: int, out_h: int, out_w: int,
          dataset: str, degree: float) -> Dict[str, torch.Tensor]:
    """The random numbers of one step's augmentation, one entry per sample."""
    gen = torch.Generator().manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(1)[0]))

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (b,), generator=gen)

    bmin, bmax = (0.75, 1.25) if dataset == "nyu" else (0.9, 1.1)
    return {
        "angle": uniform(-degree, degree) * (math.pi / 180.0),
        "top": torch.randint(0, h - out_h + 1, (b,), generator=gen),
        "left": torch.randint(0, w - out_w + 1, (b,), generator=gen),
        "flip": torch.rand(b, generator=gen) < 0.5,
        "gate": torch.rand(b, generator=gen) < 0.5,
        "gamma": uniform(0.9, 1.1),
        "brightness": uniform(bmin, bmax),
        "colors": uniform(0.9, 1.1, b, 3),
    }


def _shear(img, t, axis: int, order: int, k: int):
    """out[.., p, ..] = in[.., p + t, ..] along spatial ``axis`` (0 = H, 1 = W)
    of (B, H, W, C), ``t`` (B, n) varying along the other axis; linear
    (order 1) or nearest (order 0) weights over 2k + 2 integer shifts, zero
    fill."""
    dim = 1 + axis
    pad = [0, 0, 0, 0, 0, 0]
    pad[2 * (3 - dim)], pad[2 * (3 - dim) + 1] = k, k + 1
    padded = torch.nn.functional.pad(img, pad)
    size = img.shape[dim]
    bshape = [img.shape[0], 1, 1, 1]
    bshape[2 - axis] = t.shape[1]
    out = torch.zeros_like(img)
    for d in range(-k, k + 2):
        if order == 0:
            weight = (torch.round(t) == d).to(img.dtype)
        else:
            weight = torch.clamp_min(1.0 - torch.abs(t - d), 0.0).to(img.dtype)
        out = out + weight.reshape(bshape) * padded.narrow(dim, k + d, size)
    return out


def _extents(h: int, w: int, degree: float):
    a = math.radians(abs(degree))
    return (int(math.ceil(math.tan(a / 2.0) * (h - 1) / 2.0)) + 1,
            int(math.ceil(math.sin(a) * (w - 1) / 2.0)) + 1)


def _rotate_shear(img, angle, order: int, degree: float):
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    _, h, w, _ = img.shape
    kx, ky = _extents(h, w, degree)
    a13 = torch.tan(angle / 2.0)[:, None]
    a2 = -torch.sin(angle)[:, None]
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[None, :] - (h - 1) / 2.0
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - (w - 1) / 2.0
    out = _shear(img, a13 * yy, 1, order, kx)
    out = _shear(out, a2 * xx, 0, order, ky)
    out = _shear(out, a13 * yy, 1, order, kx)
    return out[..., 0] if squeeze else out


def rotate(img, depth, angle, degree: float):
    h, w = img.shape[1], img.shape[2]
    kx, ky = _extents(h, w, degree)
    if 4 * (kx + 1) + 2 * (ky + 1) > SHEAR_MAX_SLICES:
        # the system rotates such frames by a 2-D gather instead; no cell does
        raise NotImplementedError(f"rotation within {degree} degrees of a {h}x{w} frame")
    return _rotate_shear(img, angle, 1, degree), _rotate_shear(depth, angle, 0, degree)


def augment(images, depths, d: Dict[str, torch.Tensor], out_h: int, out_w: int, degree: float,
            do_random_rotate: bool):
    """uint8 images (B, H, W, 3) and depths (B, H, W) -> normalised images
    (B, out_h, out_w, 3) and depths (B, out_h, out_w), f32."""
    d = {k: v.to(images.device) for k, v in d.items()}
    img, depth = images.float() / 255.0, depths.float()
    if do_random_rotate:
        img, depth = rotate(img, depth, d["angle"], degree)
    bi = torch.arange(img.shape[0], device=img.device).view(-1, 1, 1)
    rows = (d["top"][:, None] + torch.arange(out_h, device=img.device))[:, :, None]
    cols = (d["left"][:, None] + torch.arange(out_w, device=img.device))[:, None, :]
    img, depth = img[bi, rows, cols], depth[bi, rows, cols]
    flip = d["flip"]
    img = torch.where(flip.view(-1, 1, 1, 1), img.flip(2), img)
    depth = torch.where(flip.view(-1, 1, 1), depth.flip(2), depth)
    jit = torch.clamp(img, 0.0, 1.0) ** d["gamma"].view(-1, 1, 1, 1)
    jit = torch.clamp(jit * d["brightness"].view(-1, 1, 1, 1) * d["colors"][:, None, None, :], 0.0, 1.0)
    img = torch.where(d["gate"].view(-1, 1, 1, 1), jit, torch.clamp(img, 0.0, 1.0))
    return normalize(img), depth
