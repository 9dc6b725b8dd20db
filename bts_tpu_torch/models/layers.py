"""Decoder building blocks (nn.Module, NCHW); counterpart of
``bts_tpu/models/layers.py``.

Conventions, as in the JAX package:
- weights are kept in f32 and cast per conv to the compute ``dtype``, which
  is also the dtype of every activation between modules;
- BatchNorm uses eps 1.1e-5, runs in f32 and casts back; in train mode it
  normalises by the batch statistics and folds them into the running ones
  as flax does (momentum 0.99 on the old value, biased batch variance);
- ELU inside the decoder, ReLU inside the dense-ASPP cells.

Module attribute names are the upstream torch names that
``bts_tpu/utils/torch_converter.py::decoder_mapping`` uses, so a converted
``state_dict`` loads with no renaming.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional, Tuple

import torch
import torch.distributed.nn.functional as dist_fn
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from bts_tpu_torch.ops.resize import upsample_nearest_2x

BN_EPS = 1.1e-5
BN_MOMENTUM = 0.99  # flax's: running = 0.99 * running + 0.01 * batch

_remat = threading.local()  # .recomputing: inside a checkpoint's recompute


def recomputing() -> bool:
    """True while a :func:`checkpoint` re-runs its function in the backward."""
    return getattr(_remat, "recomputing", False)


@contextlib.contextmanager
def _recompute_scope(inner):
    prev = recomputing()
    _remat.recomputing = True
    try:
        with inner:
            yield
    finally:
        _remat.recomputing = prev


def checkpoint(fn, *args, policy=None):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` whose
    recompute leaves BatchNorm's running statistics alone, as flax's
    ``nn.remat`` discards the recompute's mutations.  ``policy`` (optional)
    is a selective-checkpoint policy: what it saves is not recomputed."""

    def context_fn():
        if policy is None:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            fwd, rec = torch.utils.checkpoint.create_selective_checkpoint_contexts(policy)
        return fwd, _recompute_scope(rec)

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


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
    f32 with ``dtype`` = compute).  ``padding`` defaults to stride-1 SAME;
    ``groups`` > 1 is a grouped conv (ResNeXt, depthwise)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel: int,
        *,
        stride: int = 1,
        padding: Optional[int] = None,
        dilation: int = 1,
        groups: int = 1,
        bias: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        if padding is None:
            padding = dilation * (kernel // 2)
        super().__init__(
            in_channels, out_channels, kernel,
            stride=stride, padding=padding, dilation=dilation, groups=groups, bias=bias,
        )
        self.dtype = dtype

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(
            x.to(self.dtype), self.weight.to(self.dtype), bias,
            self.stride, self.padding, self.dilation, self.groups,
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
    """BatchNorm in f32 with the reference lineage's eps; the result is cast
    back to the input dtype.  Parameter and buffer names are torch's
    (weight, bias, running_mean, running_var).

    Train mode (``module.train()``) is flax's ``BatchNorm(train=True)``: the
    batch mean and the biased batch variance E[x^2] - E[x]^2 (clipped at 0)
    normalise, and ``running = 0.99 * running + 0.01 * batch`` updates the
    buffers, except while a :func:`checkpoint` recomputes or when
    ``track_stats`` is False (``--bn_no_track_stats``).  torch's own
    batch_norm would fold the unbiased variance into the running one.

    ``process_group`` (set by a data-parallel ``Trainer``): the batch is
    split over its ranks, and the moments are those of the global batch, as
    flax takes them over a data-sharded batch under ``jit``: the per-channel
    sums of x and x^2 and the count go through one autograd all-reduce, and
    every rank folds the same global moments into its running statistics.
    Every rank must then run the same train-mode forwards in the same order,
    a checkpoint's recompute included."""

    def __init__(self, num_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.track_stats = True
        self.process_group = None

    def _moments(self, xf):
        """Batch mean and E[x^2] per channel, over the process group if any."""
        if self.process_group is None:
            return xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() // c)
        sums = torch.cat([xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count])
        sums = dist_fn.all_reduce(sums, group=self.process_group)
        return sums[:c] / sums[-1], sums[c:-1] / sums[-1]

    def forward(self, x):
        shape = (1, -1, 1, 1)
        xf = x.float()
        if self.training:
            mean, mean_sq = self._moments(xf)
            var = (mean_sq - mean * mean).clamp_min(0.0)
            if self.track_stats and not recomputing():
                with torch.no_grad():
                    m = BN_MOMENTUM
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)
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
    the raw head output; the caller applies the transform.  With
    ``num_filters`` < 4 the chain is empty and the input passes through, as
    in the JAX module (reduc1x1 below bts_size 128); ``out_channels`` is the
    channel count the head returns."""

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
        self.out_channels = c

    def forward(self, x):
        for conv in self.convs[:-1]:
            x = F.elu(conv(x))
        return self.convs[-1](x) if self.convs else x
