"""EfficientNet-B5 backbone (nn.Module, NCHW), as BTS's encoder.

Tan & Le 2019 (arXiv:1905.11946): B0's layout scaled by width 1.6 and
depth 2.2, channels rounded to multiples of 8.  A 3x3/2 stem to 48
channels, then stages of (expansion, kernel, stride, channels, repeats)

    (1,3,1,24,3) (6,3,2,40,5) (6,5,2,64,5) (6,3,2,128,7)
    (6,5,1,176,7) (6,5,2,304,9) (6,3,1,512,3)

39 blocks, then a 1x1 head to 2048.  The first stage's blocks are
depthwise-separable (depthwise k x k, BN+SiLU, squeeze-excite, 1x1
project, BN), the others MBConv (1x1 expand, BN+SiLU, depthwise k x k,
BN+SiLU, squeeze-excite, 1x1 project, BN); a block whose stride is 1 and
whose width does not change adds its input.  The squeeze-excite is a
global mean, a 1x1 conv with bias to ``SE_RATIO`` of the block's input
width, SiLU, a 1x1 conv with bias back, a sigmoid and a channel-wise
multiply.  BatchNorm eps is 1e-3, the TF lineage's.  Stochastic depth is
not applied (the identity at inference; training runs without it).

Module names are timm's ``tf_efficientnet_b5``: ``conv_stem``, ``bn1``,
``blocks.<stage>.<block>.{conv_pw,bn1,conv_dw,bn2,se.conv_reduce,
se.conv_expand,conv_pwl,bn3}`` (the first stage's ``conv_dw``, ``bn1``,
``se.*``, ``conv_pw``, ``bn2``), ``conv_head``, ``bn2``, so a timm
``state_dict`` (AdaBins' ``tf_efficientnet_b5_ap``) loads by name.  TF-ported
weights want TF-SAME windows: ``encoder_pad=auto`` resolves to ``same`` for
this encoder (``encoders.resolved_pad``).  Stride-2 depthwise windows
pad through ``layers.stride2`` with their own kernel size; stride-1 convs
pad k//2 on each side, as TF-SAME does at stride 1.

Feature taps at strides 2/4/8/16/32, as AdaBins (arXiv:2011.14141) taps
this encoder for the depth decoder: the outputs of ``blocks.0`` (24),
``blocks.1`` (40), ``blocks.2`` (64), ``blocks.4`` (176), and ``bn2``
after ``conv_head`` (2048) before its SiLU, where AdaBins taps the head
before ``bn2``: like every encoder of the port the last tap is
pre-activation, and the decoder applies its ReLU.

Spans: ``bts.dwconv`` holds each depthwise conv with its padding and its
BN+SiLU, ``bts.se`` each squeeze-excite.  ``remat`` (``--remat``)
recomputes each block in the backward without updating BN statistics
(``layers.checkpoint``).  The squeeze-excite's mean runs over the whole
frame, which a spatial band does not hold: ``create_model`` refuses
``--spatial_shards`` with this encoder.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.models.layers import BatchNorm, Conv2d, checkpoint, stride2
from bts_tpu_torch.utils.profiling import span

# (expansion, kernel, stride, channels) per stage, and B5's repeats
B5_STAGES = ((1, 3, 1, 24), (6, 3, 2, 40), (6, 5, 2, 64), (6, 3, 2, 128), (6, 5, 1, 176), (6, 5, 2, 304),
             (6, 3, 1, 512))
B5_REPEATS = (3, 5, 5, 7, 7, 9, 3)
STEM, HEAD = 48, 2048
BN_EPS = 1e-3
SE_RATIO = 0.25
TAPS = (0, 1, 2, 4)  # the stages whose outputs are the taps at H/2 .. H/16


class SqueezeExcite(nn.Module):
    """x * sigmoid(conv_expand(silu(conv_reduce(mean(x))))), per channel.

    The two 1x1 convs act on a (B, C) vector: they run as ``F.linear`` on
    their f32 weights, the mean taken in f32 and the gate rounded once to x's
    dtype: 7 launches a block, with no weight casts or layout transposes,
    where convs in the compute dtype took 12 (on an H100, 17.75 against 29.94
    launches an image of the b16 serving forward, whose host enqueue is
    within ~25% of the card's time)."""

    def __init__(self, channels: int, reduced: int, dtype=torch.float32):
        super().__init__()
        self.conv_reduce = Conv2d(channels, reduced, 1, dtype=dtype)
        self.conv_expand = Conv2d(reduced, channels, 1, dtype=dtype)

    def forward(self, x):
        with span("bts.se"):
            r, e = self.conv_reduce, self.conv_expand
            s = F.silu(F.linear(x.mean((2, 3), dtype=torch.float32), r.weight.flatten(1), r.bias))
            gate = torch.sigmoid(F.linear(s, e.weight.flatten(1), e.bias)).to(x.dtype)
            return x * gate[:, :, None, None]


class _Block(nn.Module):
    """What the two kinds of block share: the depthwise conv and its
    BatchNorm (named by the subclass), the squeeze-excite, the skip."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, pad_style: str):
        super().__init__()
        self.kernel, self.stride, self.pad_style = kernel, stride, pad_style
        self.has_skip = stride == 1 and cin == cout

    def depthwise(self, x, bn):
        with span("bts.dwconv"):
            y = stride2(self.conv_dw, x, self.kernel, self.pad_style) if self.stride == 2 else self.conv_dw(x)
            return bn(y, act="silu")

    def skip(self, x, y):
        return x + y if self.has_skip else y


def _dw(channels: int, kernel: int, stride: int, dtype) -> Conv2d:
    # stride 2 pads explicitly (layers.stride2), stride 1 by k//2 on each side
    return Conv2d(channels, channels, kernel, stride=stride, padding=0 if stride == 2 else kernel // 2,
                  groups=channels, bias=False, dtype=dtype)


class DepthwiseSeparable(_Block):
    """timm's DepthwiseSeparableConv: conv_dw, bn1 (+SiLU), se, conv_pw, bn2."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, dtype=torch.float32,
                 pad_style: str = "same"):
        super().__init__(cin, cout, kernel, stride, pad_style)
        self.conv_dw = _dw(cin, kernel, stride, dtype)
        self.bn1 = BatchNorm(cin, BN_EPS)
        self.se = SqueezeExcite(cin, int(cin * SE_RATIO), dtype)
        self.conv_pw = Conv2d(cin, cout, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(cout, BN_EPS)

    def forward(self, x):
        y = self.se(self.depthwise(x, self.bn1))
        return self.skip(x, self.bn2(self.conv_pw(y)))


class InvertedResidual(_Block):
    """timm's InvertedResidual (MBConv): conv_pw, bn1 (+SiLU), conv_dw, bn2
    (+SiLU), se, conv_pwl, bn3."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand: int, dtype=torch.float32,
                 pad_style: str = "same"):
        super().__init__(cin, cout, kernel, stride, pad_style)
        mid = cin * expand
        self.conv_pw = Conv2d(cin, mid, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(mid, BN_EPS)
        self.conv_dw = _dw(mid, kernel, stride, dtype)
        self.bn2 = BatchNorm(mid, BN_EPS)
        self.se = SqueezeExcite(mid, int(cin * SE_RATIO), dtype)
        self.conv_pwl = Conv2d(mid, cout, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm(cout, BN_EPS)

    def forward(self, x):
        y = self.bn1(self.conv_pw(x), act="silu")
        y = self.se(self.depthwise(y, self.bn2))
        return self.skip(x, self.bn3(self.conv_pwl(y)))


class EfficientNet(nn.Module):
    def __init__(self, repeats: Sequence[int] = B5_REPEATS, dtype: torch.dtype = torch.float32,
                 pad_style: str = "same", remat: bool = False):
        """``repeats``: the blocks of each stage (B5's by default; the tests
        build one a stage at full widths)."""
        super().__init__()
        self.pad_style = pad_style
        self.remat = remat
        # the stride-2 stem pads explicitly (layers.stride2), so its conv has none
        self.conv_stem = Conv2d(3, STEM, 3, stride=2, padding=0, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(STEM, BN_EPS)
        stages, cin = [], STEM
        for (expand, kernel, stride, cout), n in zip(B5_STAGES, repeats):
            blocks = []
            for j in range(n):
                s = stride if j == 0 else 1
                blocks.append(DepthwiseSeparable(cin, cout, kernel, s, dtype, pad_style) if expand == 1 else
                              InvertedResidual(cin, cout, kernel, s, expand, dtype, pad_style))
                cin = cout
            stages.append(nn.Sequential(*blocks))
        self.blocks = nn.Sequential(*stages)
        self.conv_head = Conv2d(cin, HEAD, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(HEAD, BN_EPS)
        self.channels = tuple(B5_STAGES[i][3] for i in TAPS) + (HEAD,)

    def forward(self, x):
        x = self.bn1(stride2(self.conv_stem, x, 3, self.pad_style), act="silu")
        feats = []
        remat = self.remat and torch.is_grad_enabled()
        for i, stage in enumerate(self.blocks):
            for block in stage:
                x = checkpoint(block, x) if remat else block(x)
            if i in TAPS:
                feats.append(x)  # H/2 (24), H/4 (40), H/8 (64), H/16 (176)
        feats.append(self.bn2(self.conv_head(x)))  # H/32, before the activation
        return feats
