"""MobileNetV2 backbone (nn.Module, NCHW); counterpart of
``bts_tpu/models/encoders/mobilenetv2.py``.

Sandler et al. 2018: a 3x3/2 stem (32 channels), then inverted residuals
(expansion t, channels c, repeats n, stride s)
    (1,16,1,1) (6,24,2,2) (6,32,3,2) (6,64,4,2) (6,96,3,1)
    (6,160,3,2) (6,320,1,1)
and a 1x1 conv to 1280.  ReLU6 activations, BN after every conv, depthwise
3x3 convs with ``groups=channels``.  Module names are torchvision's
(``features.0.{0,1}`` the stem, ``features.<j>.conv.*`` the inverted
residuals, ``features.18.{0,1}`` the last conv), which
``torch_converter.mobilenetv2_mapping`` names.

Feature taps at strides 2/4/8/16/32 for the BTS decoder:
    16 (H/2), 24 (H/4), 32 (H/8), 96 (H/16), 1280 (H/32, before the ReLU6;
    the decoder applies a ReLU).

``remat`` (``--remat``) recomputes each inverted residual in the backward
without updating BN statistics (``layers.checkpoint``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.models.layers import BatchNorm, Conv2d, checkpoint, pad_stride2

# (expansion, channels, repeats, stride)
_MBV2_CONFIG = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)
TAP_CHANNELS = (16, 24, 32, 96)  # the taps at H/2 .. H/16, after the last block of each


def _conv_bn(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1, dtype=torch.float32):
    """torchvision's Conv2dNormActivation without its activation: the
    activation (and a stride-2 window's padding) is applied by the caller."""
    padding = 0 if stride == 2 else kernel // 2
    return nn.Sequential(Conv2d(cin, cout, kernel, stride=stride, padding=padding, groups=groups,
                                bias=False, dtype=dtype), BatchNorm(cout))


class InvertedResidual(nn.Module):
    def __init__(self, in_channels: int, features: int, stride: int = 1, expand: int = 6,
                 dtype=torch.float32, pad_style: str = "same"):
        super().__init__()
        hidden = in_channels * expand
        self.stride = stride
        self.pad_style = pad_style
        self.use_res = stride == 1 and in_channels == features
        layers = [_conv_bn(in_channels, hidden, 1, dtype=dtype)] if expand != 1 else []
        layers += [_conv_bn(hidden, hidden, 3, stride, groups=hidden, dtype=dtype),
                   Conv2d(hidden, features, 1, bias=False, dtype=dtype), BatchNorm(features)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        *expand, depthwise, project, bn = self.conv
        y = x
        for m in expand:  # none when the expansion is 1
            y = F.relu6(m(y))
        if self.stride == 2:
            y = pad_stride2(y, 3, self.pad_style)
        y = bn(project(F.relu6(depthwise(y))))
        return x + y if self.use_res else y


class MobileNetV2(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32, pad_style: str = "same", remat: bool = False):
        super().__init__()
        self.pad_style = pad_style
        self.remat = remat
        features = [_conv_bn(3, 32, 3, 2, dtype=dtype)]
        ch, self.taps = 32, []
        for t, c, n, s in _MBV2_CONFIG:
            for i in range(n):
                features.append(InvertedResidual(ch, c, s if i == 0 else 1, t, dtype, pad_style))
                ch = c
            if c in TAP_CHANNELS:
                self.taps.append(len(features) - 1)
        features.append(_conv_bn(ch, 1280, 1, dtype=dtype))
        self.features = nn.Sequential(*features)
        self.channels = TAP_CHANNELS + (1280,)

    def forward(self, x):
        f = self.features
        x = F.relu6(f[0](pad_stride2(x, 3, self.pad_style)))
        feats = []
        remat = self.remat and torch.is_grad_enabled()
        for j in range(1, len(f) - 1):
            x = checkpoint(f[j], x) if remat else f[j](x)
            if j in self.taps:
                feats.append(x)  # H/2 (16), H/4 (24), H/8 (32), H/16 (96)
        feats.append(f[-1](x))  # H/32, before the activation
        return feats
