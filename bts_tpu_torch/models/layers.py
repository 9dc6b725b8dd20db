"""Decoder building blocks (nn.Module, NCHW); counterpart of
``bts_tpu/models/layers.py``.

Conventions, as in the JAX package:
- weights are kept in f32 and cast per conv to the compute ``dtype``, which
  is also the dtype of every activation between modules;
- BatchNorm uses eps 1.1e-5, runs in f32 and casts back; this slice serves,
  so it applies the running statistics only;
- ELU inside the decoder, ReLU inside the dense-ASPP cells.

Module attribute names are the upstream torch names that
``bts_tpu/utils/torch_converter.py::decoder_mapping`` uses, so a converted
``state_dict`` loads with no renaming.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.ops.resize import upsample_nearest_2x

BN_EPS = 1.1e-5


def pad2(kernel: int, style: str, size: int) -> Tuple[int, int]:
    """(low, high) padding of one axis of length ``size`` for a stride-2
    conv or pool.  ``"same"`` is TF SAME: ``(k//2 - 1, k//2)`` for an even
    size, ``(k//2, k//2)`` for an odd one.  ``"torch"`` is torchvision's
    symmetric ``k//2``.  The two give equal output sizes but windows one
    input pixel apart, so torch-pretrained weights need ``"torch"``."""
    if style == "same":
        total = max(((size + 1) // 2 - 1) * 2 + kernel - size, 0)
        return total // 2, total - total // 2
    if style != "torch":
        raise ValueError(f"pad_style must be 'same' or 'torch', got {style!r}")
    return kernel // 2, kernel // 2


def pad_stride2(x: torch.Tensor, kernel: int, style: str, value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor for a stride-2 ``kernel`` window (see :func:`pad2`)."""
    top, bottom = pad2(kernel, style, x.shape[-2])
    left, right = pad2(kernel, style, x.shape[-1])
    return F.pad(x, (left, right, top, bottom), value=value)


class Conv2d(nn.Conv2d):
    """Conv with an f32 weight, computed in ``dtype`` (flax's ``param_dtype``
    f32 with ``dtype`` = compute).  ``padding`` defaults to stride-1 SAME."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: int,
        *,
        stride: int = 1,
        padding: Optional[int] = None,
        dilation: int = 1,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        if padding is None:
            padding = dilation * (kernel // 2)
        super().__init__(
            in_channels, out_channels, kernel,
            stride=stride, padding=padding, dilation=dilation, bias=bias,
        )
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(
            x.to(self.dtype), self.weight.to(self.dtype), bias,
            self.stride, self.padding, self.dilation,
        )


class ConvBlock(Conv2d):
    """SAME conv + ELU, the decoder's basic fusion block (``act=None``: no
    activation)."""

    def __init__(self, in_channels, out_channels, kernel=3, *, act: Optional[Callable] = F.elu,
                 dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel, dtype=dtype)
        self.act = act

    def forward(self, x):
        y = super().forward(x)
        return self.act(y) if self.act is not None else y


class BatchNorm(nn.Module):
    """Inference BatchNorm in f32 with the reference lineage's eps; the
    result is cast back to the input dtype.  Parameter and buffer names are
    torch's (weight, bias, running_mean, running_var)."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class UpConv(nn.Module):
    """Nearest x2 upsample -> 3x3 SAME conv -> ELU (reference ``upconv``).

    The JAX package fuses the two into one lhs-dilated conv by default; this
    is the literal form (``layers.py::_up2x_conv_literal``), the same
    function.  A fused form is later work."""

    def __init__(self, in_channels: int, features: int, dtype=torch.float32):
        super().__init__()
        self.conv = ConvBlock(in_channels, features, 3, dtype=dtype)

    def forward(self, x):
        return self.conv(upsample_nearest_2x(x))


class AtrousConv(nn.Module):
    """Dense-ASPP cell (reference ``atrous_conv``):

        [BN] -> ReLU -> 1x1 conv (2*out) -> BN -> ReLU -> 3x3 dilated conv.

    ``apply_bn_first`` is False only for the first (rate-3) cell.
    """

    def __init__(self, in_channels: int, features: int, dilation: int,
                 apply_bn_first: bool = True, dtype=torch.float32):
        super().__init__()
        self.first_bn = BatchNorm(in_channels) if apply_bn_first else None
        self.conv1 = Conv2d(in_channels, features * 2, 1, dtype=dtype)
        self.bn = BatchNorm(features * 2)
        self.conv2 = Conv2d(features * 2, features, 3, dilation=dilation, dtype=dtype)

    def forward(self, x):
        if self.first_bn is not None:
            x = self.first_bn(x)
        x = self.conv1(F.relu(x))
        return self.conv2(F.relu(self.bn(x)))


class Reduction1x1(nn.Module):
    """Plane-coefficient head (reference ``reduction_1x1``): 1x1 convs
    ``conv0, conv1, ...`` halving ``num_filters`` with ELU between, ending in
    1 channel (``is_final``) or 3 raw spherical plane parameters.  Returns
    the raw head output; the caller applies the transform."""

    def __init__(self, in_channels: int, num_filters: int, is_final: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.convs = []
        nf, c, j = num_filters, in_channels, 0
        while nf >= 4:
            out = (1 if is_final else 3) if nf < 8 else nf
            conv = Conv2d(c, out, 1, dtype=dtype)
            self.add_module(f"conv{j}", conv)
            self.convs.append(conv)
            c, j = out, j + 1
            if nf < 8:
                break
            nf //= 2

    def forward(self, x):
        for conv in self.convs[:-1]:
            x = F.elu(conv(x))
        return self.convs[-1](x)
