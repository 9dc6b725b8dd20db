"""Bytes of the eval-mode BatchNorm kernel (K7) in a serving forward, from
the shapes of the plain reference's BatchNorm calls at the cell's batch and
frame size, on the meta device (the program runs one K7 launch per
BatchNorm call of its serving forward).

A call is found where the reference subtracts a BatchNorm's running mean
from an activation, ``x - mean``, as every BatchNorm of the reference
(``model.Model.bn`` and an encoder's own) normalises in eval mode.  Each
call reads x and writes y, N*C*H*W elements each in the compute dtype, and
reads four f32 per-channel vectors (mean, var, weight, bias):
2 * N*C*H*W * dtype bytes + 16 * C.  Its few operations an element (the
affine map; a SiLU's exp and division) are far under what the card does a
byte, so bytes bound it."""

from __future__ import annotations

import functools
from typing import Tuple

import torch
from torch.overrides import TorchFunctionMode

from ..reference import model as ref_model

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}
PARAM_BYTES = 4 * 4  # mean, var, weight and bias of one channel, f32
SUBTRACT = (torch.Tensor.__sub__, torch.Tensor.sub, torch.sub)


class _Calls(TorchFunctionMode):
    """(elements, channels) of x at each ``x - mean``, mean a view of one of
    ``means``."""

    def __init__(self, means):
        super().__init__()
        self.means = {id(t) for t in means}
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in SUBTRACT and len(args) == 2 and id(getattr(args[1], "_base", None)) in self.means:
            self.calls.append((args[0].numel(), args[0].shape[1]))
        return func(*args, **(kwargs or {}))


@functools.lru_cache(maxsize=None)
def calls(encoder: str, bts_size: int, max_depth: float, b: int, h: int, w: int) -> Tuple[Tuple[int, int], ...]:
    """(elements, channels) of each BatchNorm call of one forward of a
    (b, 3, h, w) batch, in order."""
    p = {n: torch.empty(s, device="meta") for n, s in ref_model.state_shapes(encoder, bts_size)}
    mode = _Calls([t for n, t in p.items() if n.endswith(".running_mean")])
    with mode, torch.no_grad():
        ref_model.forward(p, torch.empty(b, 3, h, w, device="meta"), None, encoder=encoder, bts_size=bts_size,
                          max_depth=max_depth)
    return tuple(mode.calls)


def nbytes(elements: int, channels: int, dtype: str) -> int:
    """Bytes one K7 call moves."""
    return 2 * elements * DTYPE_BYTES[dtype] + PARAM_BYTES * channels
