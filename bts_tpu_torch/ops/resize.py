"""Static-shape resize helpers of the decoder (NCHW); counterpart of
``bts_tpu/ops/resize.py``.

- :func:`upsample_nearest_2x` feeds each ``upconv`` stage (the literal form);
- :func:`fold_up2x_kernel` folds a 3x3 kernel over that upsample, for the
  fused form (``models/layers.py::UpConv``) and K6 (``ops/tail_cuda.py``);
- :func:`downsample_nearest`: nearest 1/f by a strided slice from index 0.
  No caller on the main path (the LPG maps come at a stride from
  ``ops/lpg.py::lpg_strided``); the public op surface matches the JAX
  package's.
"""

from __future__ import annotations

import torch


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, 2H, 2W), each pixel repeated in a 2x2 block."""
    b, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(b, c, h, 2, w, 2).reshape(b, c, 2 * h, 2 * w)


def downsample_nearest(x: torch.Tensor, factor: int) -> torch.Tensor:
    """(B, C, H, W) -> every ``factor``-th row and column from index 0 (a
    view): nearest 1/factor for an integer factor, as ``interpolate(mode=
    'nearest')`` takes it for exact factors."""
    return x[:, :, ::factor, ::factor]


def fold_up2x_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """A 3x3 kernel (..., 3, 3) folded over the nearest-2x upsample before
    it: (..., 4, 4) f32, K''[a, b] = sum over u, v in {0, 1} of K[a-u, b-v],
    so that ``conv3x3_SAME(upsample_nearest_2x(x), K)`` is the stride-2
    transposed conv of x with K'' flipped.  The taps are summed in f32 in
    the JAX package's order (``bts_tpu/models/layers.py::
    _up2x_conv_dilated``); the caller rounds to its compute dtype once."""
    k = kernel.float()
    k4 = k.new_zeros(k.shape[:-2] + (4, 4))
    for u in (0, 1):
        for v in (0, 1):
            k4[..., u:u + 3, v:v + 3] += k
    return k4
