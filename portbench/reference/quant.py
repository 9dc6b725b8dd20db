"""The control: the reference with every conv's operands and result
rounded to fp8.

The configurations state bfloat16 compute; the nearest precision below is
fp8.  ``fp8`` rounds a tensor as fp8 training and inference do: scaled
per tensor so that its largest magnitude lands on the format's largest
(e4m3, max 448, in the forward), cast, and scaled back.  In the backward
the incoming gradient is rounded the same way in e5m2 (max 57344) and
passed straight through.  Accumulation stays float32.
"""

from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)
