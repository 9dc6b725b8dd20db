"""Decoder building blocks (nn.Module, NCHW); counterpart of
``bts_tpu/models/layers.py``.

Conventions, as in the JAX package:
- weights are kept in f32 and cast per conv to the compute ``dtype``, which
  is also the dtype of every activation between modules (one exception:
  EfficientNet's squeeze-excite, ``encoders/efficientnet.py::SqueezeExcite``,
  runs its two 1x1 convs as f32 ``F.linear`` on the pooled vector and
  rounds only the gate);
- BatchNorm uses eps 1.1e-5 (EfficientNet's 1e-3, the TF lineage's, where
  its encoder passes it), runs in f32 and casts back; in train mode it
  normalises by the batch statistics and folds them into the running ones
  as flax does (momentum 0.99 on the old value, biased batch variance);
- ELU inside the decoder, ReLU inside the dense-ASPP cells.

Spatial sharding (``parallel/spatial.py``): inside ``spatial.use(bands)``
every window op here runs on this rank's band: :class:`Conv2d`,
:func:`stride2` (the stride-2 convs and pools with their SAME padding),
:func:`avg_pool2` and :class:`UpConv` fetch the halo their output band
needs and compute that band; 1x1 convs, BatchNorm and the pointwise ops
need none.  Outside it they run whole tensors.

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

from bts_tpu_torch.ops import bn_cuda
from bts_tpu_torch.ops.resize import fold_up2x_kernel, upsample_nearest_2x
from bts_tpu_torch.parallel import spatial

BN_EPS = 1.1e-5
BN_MOMENTUM = 0.99  # flax's: running = 0.99 * running + 0.01 * batch

_remat = threading.local()  # .recomputing: inside a checkpoint's recompute


def recomputing() -> bool:
    """True while a :func:`checkpoint` re-runs its function in the backward."""
    return getattr(_remat, "recomputing", False)


@contextlib.contextmanager
def _recompute_scope(inner, bands):
    prev = recomputing()
    _remat.recomputing = True
    try:
        with inner, spatial.use(bands):
            yield
    finally:
        _remat.recomputing = prev


def checkpoint(fn, *args, policy=None):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` whose
    recompute leaves BatchNorm's running statistics alone, as flax's
    ``nn.remat`` discards the recompute's mutations, and runs on the
    spatial bands of the forward (the backward may run on another thread).
    ``policy`` (optional) is a selective-checkpoint policy: what it saves is
    not recomputed."""
    bands = spatial.current()

    def context_fn():
        if policy is None:
            fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
        else:
            fwd, rec = torch.utils.checkpoint.create_selective_checkpoint_contexts(policy)
        return fwd, _recompute_scope(rec, bands)

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


def _banded(x, fn, spec_h, spec_w, up=False, value=0.0):
    """``fn`` (an op with no padding of its own, see ``spatial._need`` for
    the specs) on the window of the whole tensor that this rank's output
    band needs; returns that band."""
    win, (oy, oh), (ox, ow) = spatial.current().window(x, spec_h, spec_w, up, value)
    with spatial.use(None):
        if oh and ow:
            return fn(win).narrow(-2, oy, oh).narrow(-1, ox, ow)
        # an empty band (H/16 or H/32 in more bands than rows): fn on a
        # minimal input, cut to nothing, keeps fn's weights and the window in
        # the graph, so this rank runs every backward exchange the others do
        span = [1 if spec[0] == "up" else spec[1] for spec in (spec_h, spec_w)]
        out = fn(win.new_zeros(win.shape[0], win.shape[1], *span))
        return out.new_zeros(*out.shape[:2], oh, ow) + (out.sum() + win.sum().to(out.dtype)) * 0


def stride2(fn, x: torch.Tensor, kernel: int, style: str, value: float = 0.0) -> torch.Tensor:
    """``fn`` (a stride-2 ``kernel`` window with no padding of its own: a
    conv or a pool) on ``x`` padded by :func:`pad_stride2`.  On a spatial
    band the padding is the whole tensor's (TF SAME depends on its size)
    and the band's windows keep the global stride phase."""
    bands = spatial.current()
    if bands is None:
        return fn(pad_stride2(x, kernel, style, value))
    (top, bottom), (left, right) = (pad2(kernel, style, n) for n in bands.global_size(x))
    return _banded(x, fn, ("win", kernel, 2, top, top + bottom), ("win", kernel, 2, left, left + right),
                   value=value)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, no padding (DenseNet's transitions)."""
    if spatial.current() is None:
        return F.avg_pool2d(x, 2)
    spec = ("win", 2, 2, 0, 0)
    return _banded(x, lambda t: F.avg_pool2d(t, 2), spec, spec)


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
        weight = self.weight.to(self.dtype)
        k, stride = self.kernel_size[0], self.stride[0]
        if spatial.current() is None or (k == 1 and stride == 1 and x.shape[-2] and x.shape[-1]):
            # a whole tensor, or a 1x1 conv, which needs no halo
            return F.conv2d(x.to(self.dtype), weight, bias, self.stride, self.padding, self.dilation, self.groups)
        span = self.dilation[0] * (k - 1) + 1
        specs = [("win", span, stride, p, 2 * p) for p in self.padding]
        return _banded(x, lambda t: F.conv2d(t.to(self.dtype), weight, bias, self.stride, 0, self.dilation,
                                             self.groups), *specs)


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
    """BatchNorm in f32 with the reference lineage's eps (``eps``, default
    ``BN_EPS``); the result is cast back to the input dtype.  Parameter and
    buffer names are torch's (weight, bias, running_mean, running_var).

    Train mode (``module.train()``) is flax's ``BatchNorm(train=True)``: the
    batch mean and the biased batch variance E[x^2] - E[x]^2 (clipped at 0)
    normalise, and ``running = 0.99 * running + 0.01 * batch`` updates the
    buffers, except while a :func:`checkpoint` recomputes or when
    ``track_stats`` is False (``--bn_no_track_stats``).  torch's own
    batch_norm would fold the unbiased variance into the running one.

    ``process_group`` (set by a data-parallel or spatial ``Trainer``): the
    batch, or each frame's bands, are split over its ranks, and the moments
    are those of the global batch, as flax takes them over a sharded batch
    under ``jit``: the per-channel
    sums of x and x^2 and the count go through one autograd all-reduce, and
    every rank folds the same global moments into its running statistics.
    Every rank must then run the same train-mode forwards in the same order,
    a checkpoint's recompute included.

    Eval mode under no grad, on an NCHW-contiguous f32 or bf16 CUDA tensor
    of under 2**31 elements, runs the same arithmetic as one kernel
    (``ops/bn_cuda.py``, K7), the activation included where asked; every
    other case runs it as PyTorch ops (``bn_cuda.normalize``)."""

    def __init__(self, num_features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
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

    def forward(self, x, act: str = "none"):
        """The BatchNorm of x, then the activation ``act``: "none", "relu"
        (the ReLU that follows the module at DenseNet's and ResNet's sites)
        or "silu" (EfficientNet's), fused into K7."""
        if (not (self.training or torch.is_grad_enabled()) and x.is_cuda and x.dtype in bn_cuda.DTYPES
                and x.is_contiguous() and bn_cuda.fits(x)):
            return bn_cuda.bn_act(x, self.running_mean, self.running_var, self.weight, self.bias, self.eps, act)
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
        return bn_cuda.normalize(xf, mean, var, self.weight, self.bias, self.eps, x.dtype, act)


def _phase_conv_transpose_2x(x, weight, bias):
    """``F.conv_transpose2d(x, weight, bias, stride=2, padding=1)`` for a
    4x4 ``weight`` (cin, cout, 4, 4) as one stride-1 2x2 conv with a block
    of cout channels per output phase, then an interleave.  Output pixel
    (2m + p, 2n + q) takes taps p, p + 2 (rows) and q, q + 2 (columns) of
    the flipped kernel over input rows m - 1 + p, m + p and columns
    n - 1 + q, n + q: the phase block of the conv over the input padded by
    one, read at (m + p, n + q)."""
    b, _, h, w = x.shape
    k = weight.flip(-2, -1).transpose(0, 1)  # (cout, cin, 4, 4)
    cout = k.shape[0]
    phases = torch.cat([k[:, :, p::2, q::2] for p in (0, 1) for q in (0, 1)])  # (4 cout, cin, 2, 2)
    y = F.conv2d(F.pad(x, (1, 1, 1, 1)), phases, bias.repeat(4)).view(b, 2, 2, cout, h + 1, w + 1)
    out = y.new_empty(b, cout, 2 * h, 2 * w)
    for p in (0, 1):
        for q in (0, 1):
            out.view(b, cout, h, 2, w, 2)[:, :, :, p, :, q] = y[:, p, q, :, p:p + h, q:q + w]
    return out


class _DeterministicUpConvT(torch.autograd.Function):
    """The fused UpConv's stride-2 transposed conv (padding 1) with a
    forward that repeats bit for bit on a card: computed by
    :func:`_phase_conv_transpose_2x`, whose conv takes cuDNN's forward
    algorithms.  The backward is the transposed conv's own
    (``aten.convolution_backward``), as autograd of ``F.conv_transpose2d``
    would run it."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        ctx.save_for_backward(x, weight)
        return _phase_conv_transpose_2x(x, weight, bias)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        return torch.ops.aten.convolution_backward(
            grad, x, weight, [weight.shape[1]], [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
            list(ctx.needs_input_grad))


class UpConv(nn.Module):
    """Nearest x2 upsample -> 3x3 SAME conv -> ELU (reference ``upconv``).

    ``fused=True`` (the default, as in the JAX package) computes the same
    function without the upsampled tensor: the 3x3 kernel folded over the
    upsample (``ops/resize.py::fold_up2x_kernel``, f32 tap sums rounded to
    the compute dtype once) in one stride-2 transposed conv, the
    counterpart of ``bts_tpu/models/layers.py::_up2x_conv_dilated``.  Its
    autograd backward stays at the input's resolution too, as the JAX
    default ``upconv_bwd="dilated"`` does.  ``fused=False`` is the literal
    two-op form (``_up2x_conv_literal``).  Either way the parameters are
    ``conv.weight`` (cout, cin, 3, 3) and ``conv.bias``.

    ``deterministic`` (set for f32): the forward repeats bit for bit
    (``_DeterministicUpConvT``).  On an H100 cuDNN's f32 algorithm for the
    transposed conv sums in an order that varies between calls, and its
    deterministic ones take up to 7.7x as long; its bf16 forward repeats,
    and bf16 keeps it.  The backward, like every conv's backward, takes
    cuDNN's default algorithms."""

    def __init__(self, in_channels: int, features: int, dtype=torch.float32, fused: bool = True):
        super().__init__()
        self.conv = ConvBlock(in_channels, features, 3, dtype=dtype)
        self.fused = fused
        self.deterministic = dtype == torch.float32

    def forward(self, x):
        if spatial.current() is None:
            return self._whole(x)
        # a band: output rows [o0, o1) take input rows (o0 - 1) // 2 .. o1 // 2
        return _banded(x, self._whole, ("up",), ("up",), up=True)

    def _whole(self, x):
        if not self.fused:
            return self.conv(upsample_nearest_2x(x))
        conv = self.conv
        # conv3x3_SAME(up2x(x), K) == conv_transpose2d(x, flip(K''), stride 2, padding 1),
        # the transposed conv's weight being (cin, cout, 4, 4)
        weight = fold_up2x_kernel(conv.weight).to(conv.dtype).transpose(0, 1).flip(-2, -1)
        x, bias = x.to(conv.dtype), conv.bias.to(conv.dtype)
        if self.deterministic:
            y = _DeterministicUpConvT.apply(x, weight, bias)
        else:
            y = F.conv_transpose2d(x, weight, bias, stride=2, padding=1)
        return conv.act(y)


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
        x = F.relu(x) if self.first_bn is None else self.first_bn(x, act="relu")
        return self.conv2(self.bn(self.conv1(x), act="relu"))


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
