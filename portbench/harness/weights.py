"""Seeded weights, made on the device in a few large calls.

Given the names and shapes of a ``state_dict`` (read from a model built on
the meta device), :func:`make_state` draws:

- conv kernels (4-D): He normal, std sqrt(2 / fan_in), clipped at two
  standard deviations, so that activations keep their scale through a deep
  ReLU network in eval mode; a kernel with 3 outputs (the last conv of an
  LPG head, BTS's only 3-channel output) at ``HEAD_SCALE`` of that, so the
  planes tilt by tens of degrees, as a trained model's do, and the LPG's
  denominators n1*u + n2*v + n3 stay away from 0 (tilts past ~55 degrees
  make them cross it, and rounding there is amplified without bound);
- conv biases: normal, std 0.05;
- BatchNorm: scale 1 + U(-0.1, 0.1), times the encoder's ``bn_scale`` of
  that BatchNorm (``reference/encoders/``), shift normal std 0.05, running
  mean 0, running variance 1.

All from one ``torch.Generator`` on ``device`` seeded with ``seed``, in
float32 (the dtype parameters are kept in), so the same seed gives the same
state on the same kind of device.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Tuple

import torch

BIAS_STD = 0.05
HEAD_SCALE = 0.1
BN_SCALE_SPREAD = 0.1


def make_state(shapes: Iterable[Tuple[str, torch.Size]], seed: int, device,
               bn_scale: Callable[[str], float] = lambda _: 1.0) -> Dict[str, torch.Tensor]:
    shapes = list(shapes)
    names = {n for n, _ in shapes}
    gen = torch.Generator(device=device).manual_seed(seed)
    normal_leaves = [(n, s) for n, s in shapes if len(s) == 4 or n.endswith(".bias")]
    total = sum(math.prod(s) for _, s in normal_leaves)
    flat = torch.randn(total, generator=gen, device=device)
    scales = torch.rand(sum(math.prod(s) for n, s in shapes if _is_bn_weight(n, names)),
                        generator=gen, device=device)
    out, i, j = {}, 0, 0
    for n, s in shapes:
        k = math.prod(s)
        if len(s) == 4:
            std = math.sqrt(2.0 / math.prod(s[1:])) * (HEAD_SCALE if s[0] == 3 else 1.0)
            out[n] = (flat[i:i + k].clamp_(-2.0, 2.0) * std).view(s)
            i += k
        elif n.endswith(".bias"):
            out[n] = (flat[i:i + k] * BIAS_STD).view(s)
            i += k
        elif _is_bn_weight(n, names):
            spread = 1.0 + (2.0 * scales[j:j + k] - 1.0) * BN_SCALE_SPREAD
            out[n] = (spread * bn_scale(n[:-len(".weight")])).view(s)
            j += k
        elif n.endswith(".running_mean"):
            out[n] = torch.zeros(s, device=device)
        elif n.endswith(".running_var"):
            out[n] = torch.ones(s, device=device)
        else:
            raise ValueError(f"no rule for {n} {tuple(s)}")
    return out


def _is_bn_weight(name: str, names: set) -> bool:
    return name.endswith(".weight") and name[:-len("weight")] + "running_mean" in names


def model_state(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded state of the configuration's model, by the names and shapes
    of the plain reference (the program's ``load_state_dict`` refuses a
    model that differs)."""
    from ..reference import encoders
    from ..reference.model import state_shapes

    return make_state(state_shapes(model["encoder"], model["bts_size"]), seed, device,
                      encoders.bn_scale(model["encoder"]))
