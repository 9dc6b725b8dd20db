"""Bytes and operations of the LPG head kernels, from a head's shape.

A head at scale k on a (B, H, W) frame has a (B, H/k, W/k) grid of cells,
each with 3 raw plane parameters in the compute dtype.  Each input byte is
counted read once and each output byte written once:

- K1, the forward (``lpg_fused_fwd``): reads the raw parameters, writes
  the f32 depth / max_depth at every pixel.  Per cell the spherical
  transform (3 sigmoids, 2 sines, 2 cosines and 5 products: ~40 FLOP); per
  pixel the denominator n1*u + n2*v + n3 (2 FMA) and the quotient:
  5 FLOP.
- K2, the backward (``lpg_fused_bwd``): reads the raw parameters and the
  f32 cotangent at every pixel, writes the parameters' gradient in the
  compute dtype.  Per pixel the reciprocal, the cotangent's share and the
  four patch sums: ~14 FLOP; per cell the chain through the transform:
  ~60 FLOP.
"""

from __future__ import annotations

from typing import Tuple

CELL_FLOPS_FWD, PIXEL_FLOPS_FWD = 40, 5
CELL_FLOPS_BWD, PIXEL_FLOPS_BWD = 60, 14


def cells(b: int, h: int, w: int, k: int) -> Tuple[int, int]:
    """(cells, pixels) of the head at scale k on a (b, h, w) frame."""
    if h % k or w % k:
        raise ValueError(f"a {h}x{w} frame does not split into {k}x{k} cells")
    return b * (h // k) * (w // k), b * h * w


def k1(b: int, h: int, w: int, k: int, raw_bytes: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one K1 launch."""
    c, p = cells(b, h, w, k)
    return c * CELL_FLOPS_FWD + p * PIXEL_FLOPS_FWD, c * 3 * raw_bytes + p * 4


def k2(b: int, h: int, w: int, k: int, raw_bytes: int) -> Tuple[float, float]:
    """(FLOP, bytes) of one K2 launch."""
    c, p = cells(b, h, w, k)
    return c * CELL_FLOPS_BWD + p * PIXEL_FLOPS_BWD, 2 * c * 3 * raw_bytes + p * 4


def bound_s(flops: float, nbytes: float, flop_peak: float, byte_peak: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / flop_peak, nbytes / byte_peak)
