"""ResNet-50/101 and ResNeXt-50/101 backbones (nn.Module, NCHW); counterpart
of ``bts_tpu/models/encoders/resnet.py``.

Bottleneck-v1 topology with the stride on the 3x3 conv (torchvision's);
ResNeXt is the same network with grouped 3x3 convs.  Module names are
torchvision's (``conv1``, ``bn1``, ``layer{1..4}.{b}.conv{1,2,3}`` /
``bn{1,2,3}`` / ``downsample.{0,1}``), which
``torch_converter.resnet_mapping`` names.

Stride-2 windows (the 7x7 stem, the 3x3 max pool and each stage's first
3x3 conv) pad through ``layers.stride2`` under ``pad_style``; the stride-1
3x3 convs pad 1 on each side, and the stride-2 1x1 projection needs none.

Returns features at strides 2/4/8/16/32:
    [stem after ReLU (64), stage1 (256), stage2 (512), stage3 (1024), stage4 (2048)]

``remat`` (``--remat``) recomputes each bottleneck in the backward without
updating BN statistics (``layers.checkpoint``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.models.layers import BatchNorm, Conv2d, checkpoint, stride2


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, inner: int, features: int, stride: int = 1, groups: int = 1,
                 dtype=torch.float32, pad_style: str = "same"):
        super().__init__()
        self.stride = stride
        self.pad_style = pad_style
        self.conv1 = Conv2d(in_channels, inner, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(inner)
        # stride 2 pads explicitly (layers.stride2), stride 1 symmetrically by 1
        self.conv2 = Conv2d(inner, inner, 3, stride=stride, padding=0 if stride == 2 else 1,
                            groups=groups, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(inner)
        self.conv3 = Conv2d(inner, features, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm(features)
        self.downsample = None
        if in_channels != features or stride != 1:
            self.downsample = nn.Sequential(
                Conv2d(in_channels, features, 1, stride=stride, bias=False, dtype=dtype),
                BatchNorm(features),
            )

    def forward(self, x):
        y = self.bn1(self.conv1(x), act="relu")
        y = stride2(self.conv2, y, 3, self.pad_style) if self.stride == 2 else self.conv2(y)
        y = self.bn2(y, act="relu")
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet(nn.Module):
    def __init__(
        self,
        stage_sizes: Tuple[int, ...] = (3, 4, 6, 3),
        groups: int = 1,
        width_per_group: int = 64,
        dtype: torch.dtype = torch.float32,
        pad_style: str = "same",
        remat: bool = False,
    ):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.pad_style = pad_style
        self.remat = remat
        # the stride-2 stem pads explicitly (layers.stride2), so its conv has none
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=0, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(64)
        ch = 64
        for i, num_blocks in enumerate(self.stage_sizes):
            out_ch = 256 * 2**i
            inner = 64 * 2**i if groups == 1 else groups * width_per_group * 2**i
            blocks = []
            for b in range(num_blocks):
                stride = 2 if (b == 0 and i > 0) else 1
                blocks.append(Bottleneck(ch, inner, out_ch, stride, groups, dtype, pad_style))
                ch = out_ch
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.channels = (64,) + tuple(256 * 2**i for i in range(len(self.stage_sizes)))

    def forward(self, x):
        feats = []
        x = self.bn1(stride2(self.conv1, x, 7, self.pad_style), act="relu")
        feats.append(x)  # stride 2, 64 channels
        x = stride2(_max_pool, x, 3, self.pad_style, value=float("-inf"))
        remat = self.remat and torch.is_grad_enabled()
        for i in range(len(self.stage_sizes)):
            for block in getattr(self, f"layer{i + 1}"):
                x = checkpoint(block, x) if remat else block(x)
            feats.append(x)  # strides 4, 8, 16, 32
        return feats
