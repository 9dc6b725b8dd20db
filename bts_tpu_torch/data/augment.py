"""Training augmentation and eval preprocessing on the card, batched;
counterpart of ``bts_tpu/data/augment.py``.  Layout NHWC, as the JAX
functions: images (B, H, W, 3), depths (B, H, W).

The reference chain (``bts_dataloader.py``), after the host's fixed crops:
random rotation (+-degree; image bilinear, depth nearest, zero fill) ->
random crop to (input_height, input_width) -> random left-right flip ->
with p=0.5 the photometric jitter (gamma [0.9, 1.1], brightness [0.9, 1.1]
(NYU [0.75, 1.25]), per-channel colour [0.9, 1.1]) -> ImageNet normalise.

Each function takes its random draws as tensors, one entry per sample, so a
test can hand both packages the same draws.  :func:`augment_batch` draws
them (:func:`draw_augment`) from an explicit CPU ``torch.Generator``, so a
(seed, step) pair gives the same batch on every device.  JAX's PRNG streams
are not reproduced.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SHEAR_MAX_SLICES = 128  # above this many static slices the rotation gathers instead


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


def _per_sample(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with ``ndim`` dimensions in all."""
    return x.reshape((-1,) + (1,) * (ndim - 1))


def _map_coordinates(img, src_y, src_x, order: int):
    """``jax.scipy.ndimage.map_coordinates`` with mode 'constant', cval 0, on
    a batch: img (B, H, W, C), coordinates (B, H', W') -> (B, H', W', C)."""
    b, h, w, _ = img.shape
    bi = torch.arange(b, device=img.device).view(b, 1, 1)

    def tap(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        v = img[bi, iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
        return torch.where(valid[..., None], v, 0.0)

    if order == 0:
        return tap(torch.round(src_y).long(), torch.round(src_x).long())
    y0, x0 = torch.floor(src_y), torch.floor(src_x)
    wy1, wx1 = src_y - y0, src_x - x0
    ys = ((y0.long(), 1.0 - wy1), (y0.long() + 1, wy1))
    xs = ((x0.long(), 1.0 - wx1), (x0.long() + 1, wx1))
    out = None
    for iy, wy in ys:
        for ix, wx in xs:
            term = (wy * wx)[..., None] * tap(iy, ix)
            out = term if out is None else out + term
    return out


def rotate_image(img: torch.Tensor, angle: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Rotate each (B, H, W, C) or (B, H, W) sample about its centre by
    ``angle[b]`` radians; order 1 bilinear, 0 nearest, zero fill outside the
    source frame (a gather, as ``map_coordinates``)."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    _, h, w, _ = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    cos, sin = _per_sample(torch.cos(angle), 3), _per_sample(torch.sin(angle), 3)
    src_y = cos * yy - sin * xx + cy
    src_x = sin * yy + cos * xx + cx
    out = _map_coordinates(img, src_y, src_x, order)
    return out[..., 0] if squeeze else out


def _shear(img: torch.Tensor, t: torch.Tensor, axis: int, order: int, k: int) -> torch.Tensor:
    """1-D resample of a (B, H, W, C) batch along spatial ``axis`` (0 = H,
    1 = W): out[.., p, ..] = in[.., p + t[b, q], ..] where ``t`` (B, n) varies
    along the other spatial axis, linear (order 1) or nearest (order 0),
    zero fill; a weighted sum of 2k+2 static slices of the zero-padded
    input (``bts_tpu/data/augment.py::_shear``)."""
    dim = 1 + axis
    pad = [0, 0, 0, 0, 0, 0]  # F.pad order: C, W, H
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
        piece = padded.narrow(dim, k + d, size)
        out = out + weight.reshape(bshape) * piece
    return out


def _shear_extents(h: int, w: int, max_degree: float):
    """(kx, ky): the static shift bounds of the three shears at |angle| <=
    max_degree."""
    a_max = math.radians(abs(max_degree))
    kx = int(math.ceil(math.tan(a_max / 2.0) * (h - 1) / 2.0)) + 1
    ky = int(math.ceil(math.sin(a_max) * (w - 1) / 2.0)) + 1
    return kx, ky


def rotate_image_shear(img: torch.Tensor, angle: torch.Tensor, order: int,
                       max_degree: float) -> torch.Tensor:
    """Rotation about the centre by three shears (Paeth),
    R(a) = ShearX(tan a/2) . ShearY(-sin a) . ShearX(tan a/2), built only from
    static slices and weighted adds; the same source map as
    :func:`rotate_image` with each pass interpolating in 1-D.  ``max_degree``
    bounds the shifts, so the slice count does not depend on the draw."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    _, h, w, _ = img.shape
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    kx, ky = _shear_extents(h, w, max_degree)
    a13 = torch.tan(angle / 2.0)[:, None]
    a2 = -torch.sin(angle)[:, None]
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[None, :] - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    out = _shear(img, a13 * yy, axis=1, order=order, k=kx)
    out = _shear(out, a2 * xx, axis=0, order=order, k=ky)
    out = _shear(out, a13 * yy, axis=1, order=order, k=kx)
    return out[..., 0] if squeeze else out


def rotate(img, depth, angle, degree: float):
    """Image bilinear, depth nearest, by ``angle`` (B,) radians.  Small
    bounds (the reference trains at 1.0 and 2.5 degrees) take the shear path;
    above 128 static slices the gather (``random_rotate``'s rule)."""
    h, w = img.shape[1], img.shape[2]
    kx, ky = _shear_extents(h, w, degree)
    if 4 * (kx + 1) + 2 * (ky + 1) <= SHEAR_MAX_SLICES:
        return (rotate_image_shear(img, angle, 1, degree),
                rotate_image_shear(depth, angle, 0, degree))
    return rotate_image(img, angle, 1), rotate_image(depth, angle, 0)


def crop(img, depth, top, left, out_h: int, out_w: int):
    """Per-sample crop at (top[b], left[b]); the same window for image and depth."""
    bi = torch.arange(img.shape[0], device=img.device).view(-1, 1, 1)
    rows = (top[:, None] + torch.arange(out_h, device=img.device))[:, :, None]
    cols = (left[:, None] + torch.arange(out_w, device=img.device))[:, None, :]
    return img[bi, rows, cols], depth[bi, rows, cols]


def flip(img, depth, do):
    """Left-right flip of the samples where ``do[b]``."""
    return (torch.where(_per_sample(do, 4), img.flip(2), img),
            torch.where(_per_sample(do, 3), depth.flip(2), depth))


def color(img, gamma, brightness, colors):
    """Gamma / brightness / per-channel colour jitter on a [0, 1] image;
    gamma, brightness (B,), colors (B, 3)."""
    out = torch.clamp(img, 0.0, 1.0) ** _per_sample(gamma, 4)
    out = out * _per_sample(brightness, 4) * colors[:, None, None, :]
    return torch.clamp(out, 0.0, 1.0)


@dataclass
class AugmentDraws:
    """The random numbers of one batch's augmentation, one entry per sample."""

    angle: torch.Tensor  # radians, U(-degree, degree) degrees
    top: torch.Tensor  # crop offsets, int64
    left: torch.Tensor
    flip: torch.Tensor  # bool
    gate: torch.Tensor  # bool: apply the photometric jitter
    gamma: torch.Tensor
    brightness: torch.Tensor
    colors: torch.Tensor  # (B, 3)

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(**{f.name: getattr(self, f.name).to(device) for f in fields(self)})

    def rows(self, start: int, stop: int) -> "AugmentDraws":
        """The draws of samples [start, stop)."""
        return AugmentDraws(**{f.name: getattr(self, f.name)[start:stop] for f in fields(self)})


def draw_augment(gen: torch.Generator, b: int, h: int, w: int, out_h: int, out_w: int,
                 dataset: str = "kitti", degree: float = 1.0) -> AugmentDraws:
    """Draw a batch's augmentation from ``gen`` (a CPU generator)."""

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape or (b,), generator=gen)

    bmin, bmax = (0.75, 1.25) if dataset == "nyu" else (0.9, 1.1)
    return AugmentDraws(
        angle=uniform(-degree, degree) * (math.pi / 180.0),
        top=torch.randint(0, h - out_h + 1, (b,), generator=gen),
        left=torch.randint(0, w - out_w + 1, (b,), generator=gen),
        flip=torch.rand(b, generator=gen) < 0.5,
        gate=torch.rand(b, generator=gen) < 0.5,
        gamma=uniform(0.9, 1.1),
        brightness=uniform(bmin, bmax),
        colors=uniform(0.9, 1.1, b, 3),
    )


def apply_augment(images, depths, draws: AugmentDraws, *, out_h: int, out_w: int,
                  degree: float, do_random_rotate: bool):
    """The reference's train-time chain with the given draws: [0, 1] or uint8
    images (B, H, W, 3) and depths (B, H, W) -> normalised images and depths
    (B, out_h, out_w[, 3]), f32."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    img, depth = images, depths.float()
    if do_random_rotate:
        img, depth = rotate(img, depth, draws.angle, degree)
    img, depth = crop(img, depth, draws.top, draws.left, out_h, out_w)
    img, depth = flip(img, depth, draws.flip)
    jittered = color(img, draws.gamma, draws.brightness, draws.colors)
    img = torch.where(_per_sample(draws.gate, 4), jittered, torch.clamp(img, 0.0, 1.0))
    return normalize_image(img), depth


def augment_batch(images, depths, gen: torch.Generator, *, out_h: int, out_w: int,
                  dataset: str = "kitti", degree: float = 1.0, do_random_rotate: bool = True,
                  share: tuple = (0, 1)):
    """Draw from ``gen`` and apply on the images' device: (B, H, W, 3) uint8
    or [0, 1] images and (B, H, W) depths -> (B, out_h, out_w, 3) normalised
    images and (B, out_h, out_w) depths.

    ``share`` (r, N): the images are rank r's B rows of a data-parallel batch
    of N*B; the draws are made for all N*B samples and rank r keeps those of
    rows [r*B, (r+1)*B), so the batch is augmented as one process would."""
    b, h, w = images.shape[:3]
    r, n = share
    draws = draw_augment(gen, n * b, h, w, out_h, out_w, dataset, degree)
    draws = draws.rows(r * b, (r + 1) * b).to(images.device)
    return apply_augment(images, depths, draws, out_h=out_h, out_w=out_w, degree=degree,
                         do_random_rotate=do_random_rotate)
