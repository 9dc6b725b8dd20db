"""The model's FLOPs per image, as published: counted once with
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference's
forward on the meta device, at the cell's shapes (convs and matmuls, 2
FLOP per multiply-add).  The reference's UpConv is the literal nearest
upsample and 3x3 conv, so the count does not follow the program's
implementation (the fused UpConv's 4/9 of the MACs, remat's recompute).
A training step counts three forwards (forward, and a backward of twice
its cost)."""

from __future__ import annotations

import functools

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref_model


@functools.lru_cache(maxsize=None)
def forward_per_image(encoder: str, bts_size: int, max_depth: float, h: int, w: int) -> float:
    p = {n: torch.empty(s, device="meta") for n, s in ref_model.state_shapes(encoder, bts_size)}
    image = torch.empty(1, 3, h, w, device="meta")
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref_model.forward(p, image, None, encoder=encoder, bts_size=bts_size, max_depth=max_depth)
    return float(counter.get_total_flops())


def per_image(model: dict, kind: str, h: int, w: int) -> float:
    """FLOPs per image of a serving forward or a training step."""
    fwd = forward_per_image(model["encoder"], model["bts_size"], model["max_depth"], h, w)
    return 3 * fwd if kind == "train" else fwd
