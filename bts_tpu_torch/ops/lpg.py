"""Local Planar Guidance (LPG) in PyTorch; counterpart of ``bts_tpu/ops/lpg.py``.

Math contract (BTS paper eq. 5): for scale k in {2, 4, 8}, given per-cell
plane coefficients (n1, n2, n3, n4) on the (H/k, W/k) grid, the full-res
depth at in-patch coordinates (u, v) is ``n4 / (n1*u + n2*v + n3)`` with
patch-centred u = (i - (k-1)/2) / k (u the column, v the row).

The functions keep the JAX layout so they compare like with like: plane
(B, h, w, 4), raw (B, h, w, 3), depth (B, h*k, w*k).  All maths is f32.

- :func:`lpg_reference`, :func:`lpg_strided`, :func:`plane_from_spherical`:
  plain PyTorch.
- :func:`local_planar_guidance`: the public LPG op, dispatched to the Hopper
  kernels (``ops/lpg_cuda.py``: K3 forward, K4 backward) or to
  :func:`lpg_reference`.
- :func:`lpg_scaled_from_raw`: the fused head the decoder calls, dispatched
  to the Hopper kernels (``ops/lpg_cuda.py``: K1 forward, K2 backward) or
  to the plain version, which autograd differentiates.
"""

from __future__ import annotations

import math

import torch

from bts_tpu_torch.ops.lpg_cuda import _plane_cells, lpg_fused, lpg_fused_plain, lpg_plane
from bts_tpu_torch.ops.lpg_cuda import lpg_plane_plain as lpg_reference  # noqa: F401

USE_PALLAS_CHOICES = ("auto", "always", "never")


def _check_setting(use_pallas: str) -> None:
    if use_pallas not in USE_PALLAS_CHOICES:
        raise ValueError(f"use_pallas must be one of {USE_PALLAS_CHOICES}, got {use_pallas!r}")


def check_divisible(height: int, width: int, shards: int, shards_w: int, k: int = 8) -> None:
    """Refuse a spatial split that cuts an LPG cell (the counterpart of
    ``bts_tpu/ops/lpg_pallas.py::_check_divisible``): the plane grid of the
    coarsest head, (H/k, W/k), must split evenly over ``shards`` x
    ``shards_w`` bands, so every band of every head holds whole cells and
    K1/K2 run on each band unchanged.  The practical constraint:
    ``input_height/(8*spatial_shards)`` and ``input_width/(8*spatial_shards_w)``
    are integers."""
    grid = (height / k, width / k)
    for dim, (size, n) in enumerate(zip((height, width), (shards, shards_w)), start=1):
        if size % (k * n):
            raise ValueError(
                f"LPG (k={k}): dim {dim} of plane grid {grid} is sharded {n}-way but "
                f"{grid[dim - 1]:g} % {n} != 0 — choose --spatial_shards/--spatial_shards_w so "
                f"input_height/(8*shards) and input_width/(8*shards_w) are integers")


def lpg_strided(plane_eq: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """LPG evaluated at every ``stride``-th full-res pixel (exact): equals
    ``lpg_reference(plane_eq, k)[:, ::stride, ::stride]`` without building the
    full-res map.  With e = k // stride, full-res row m*stride falls in cell
    m // e at in-patch index (m % e) * stride.  On a spatial band of whole
    cells (:func:`check_divisible`) the band's first row is a cell's first,
    so the in-patch index of its local row m is the global one."""
    if k % stride:
        raise ValueError(f"stride {stride} must divide k {k}")
    e = k // stride
    b, h, w, _ = plane_eq.shape
    n1, n2, n3, n4 = _plane_cells(plane_eq)
    i = torch.arange(e, dtype=torch.float32, device=plane_eq.device) * stride
    off = (i - (k - 1) * 0.5) / k
    u = off.view(1, 1, 1, 1, e)
    v = off.view(1, 1, e, 1, 1)
    return (n4 / (n1 * u + n2 * v + n3)).reshape(b, h * e, w * e)


def plane_from_spherical(raw3: torch.Tensor, max_depth: float) -> torch.Tensor:
    """reduction_1x1 head transform: raw (B, h, w, 3) -> (n1, n2, n3, n4) f32,

        theta = sigmoid(x0) * pi/3, phi = sigmoid(x1) * 2pi,
        n4 = sigmoid(x2) * max_depth, n = (sin t cos p, sin t sin p, cos t).
    """
    x = raw3.float()
    theta = torch.sigmoid(x[..., 0]) * (math.pi / 3)
    phi = torch.sigmoid(x[..., 1]) * (math.pi * 2)
    dist = torch.sigmoid(x[..., 2]) * max_depth
    n1 = torch.sin(theta) * torch.cos(phi)
    n2 = torch.sin(theta) * torch.sin(phi)
    n3 = torch.cos(theta)
    return torch.stack([n1, n2, n3, dist], dim=-1)


def local_planar_guidance(plane_eq: torch.Tensor, k: int, use_pallas: str = "auto") -> torch.Tensor:
    """The public LPG op: plane_eq (B, h, w, 4) -> depth (B, h*k, w*k) f32.

    "never" computes :func:`lpg_reference`; "auto" and "always" go through
    :class:`~bts_tpu_torch.ops.lpg_cuda.Lpg`, which launches K3 and, in the
    backward, K4 on a CUDA tensor (or raises) and computes the plain
    versions on a CPU tensor."""
    _check_setting(use_pallas)
    if use_pallas == "never":
        return lpg_reference(plane_eq, k)
    return lpg_plane(plane_eq, k)


def lpg_scaled_from_raw(
    raw3: torch.Tensor, k: int, max_depth: float, use_pallas: str = "auto"
) -> torch.Tensor:
    """Fused head: raw reduction_1x1 output (B, h, w, 3) -> depth/max_depth
    (B, h*k, w*k) f32.  ``max_depth`` cancels: n4 = sigmoid(x2) * max_depth
    is divided by it again, so neither path multiplies by it.

    ``use_pallas`` keeps the config's name for the kernel switch: "auto" and
    "always" go through :func:`~bts_tpu_torch.ops.lpg_cuda.lpg_fused`, the
    registered op that launches K1 and, in the backward, K2 on a CUDA tensor
    (or raises);
    "never" selects the plain version, differentiated by autograd.  A CPU
    tensor always computes the plain versions.
    """
    del max_depth
    _check_setting(use_pallas)
    if use_pallas == "never":
        return lpg_fused_plain(raw3, k)
    return lpg_fused(raw3, k)
