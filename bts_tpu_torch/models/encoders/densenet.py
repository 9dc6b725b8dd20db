"""DenseNet-121/161 backbones (nn.Module, NCHW); counterpart of
``bts_tpu/models/encoders/densenet.py``.

Topology (Huang et al. 2017): 7x7/2 conv -> BN -> ReLU -> 3x3/2 max pool,
dense blocks of BN-ReLU-1x1(4g)-BN-ReLU-3x3(g) layers, transitions
BN-ReLU-1x1(ch/2)-2x2 avg pool (VALID) between blocks, final BN ``norm5``.
Module names are torchvision's (``features.conv0``,
``features.denseblock1.denselayer1.norm1``, ...), which
``torch_converter.densenet_mapping`` names.

Feature taps for the BTS decoder (strides 2/4/8/16/32): relu0, pool0,
transition1, transition2, norm5 (pre-ReLU; the decoder applies the ReLU).

``remat`` (``--remat``) recomputes dense-block activations in the backward,
with the JAX package's three granularities (``--remat_policy``):
'layer' checkpoints each dense layer (saves layer inputs), 'block' each
dense block (saves block boundaries only), 'convs' each layer but keeps its
two conv outputs, so only BN/ReLU are recomputed.  Recomputation does not
update BN statistics (``layers.checkpoint``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy

from bts_tpu_torch.models.layers import BatchNorm, Conv2d, avg_pool2, checkpoint, stride2

REMAT_POLICIES = ("layer", "block", "convs")


def _save_convs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of 'convs': keep conv outputs (the JAX
    package's ``dense_1x1_out``/``dense_3x3_out``), recompute the rest."""
    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


def _run_layers(layers: Sequence[nn.Module], x):
    for layer in layers:
        x = layer(x)
    return x


class DenseLayer(nn.Module):
    def __init__(self, in_channels: int, growth_rate: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = BatchNorm(in_channels)
        self.conv1 = Conv2d(in_channels, 4 * growth_rate, 1, bias=False, dtype=dtype)
        self.norm2 = BatchNorm(4 * growth_rate)
        self.conv2 = Conv2d(4 * growth_rate, growth_rate, 3, bias=False, dtype=dtype)

    def forward(self, x):
        y = self.conv1(self.norm1(x, act="relu"))
        y = self.conv2(self.norm2(y, act="relu"))
        return torch.cat([x, y], dim=1)


class Transition(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = BatchNorm(in_channels)
        self.conv = Conv2d(in_channels, out_channels, 1, bias=False, dtype=dtype)

    def forward(self, x):
        return avg_pool2(self.conv(self.norm(x, act="relu")))


class DenseNet(nn.Module):
    def __init__(
        self,
        growth_rate: int = 32,
        block_config: Tuple[int, ...] = (6, 12, 24, 16),
        num_init_features: int = 64,
        dtype: torch.dtype = torch.float32,
        pad_style: str = "same",
        remat: bool = False,
        remat_policy: str = "layer",
    ):
        super().__init__()
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, got {remat_policy!r}")
        self.block_config = tuple(block_config)
        self.pad_style = pad_style
        self.remat = remat
        self.remat_policy = remat_policy
        f = nn.ModuleDict()
        # the stride-2 stem pads explicitly (layers.pad2), so its conv has none
        f["conv0"] = Conv2d(3, num_init_features, 7, stride=2, padding=0, bias=False, dtype=dtype)
        f["norm0"] = BatchNorm(num_init_features)
        ch = num_init_features
        channels = [ch, ch]
        for i, num_layers in enumerate(self.block_config):
            block = nn.ModuleDict()
            for layer in range(1, num_layers + 1):
                block[f"denselayer{layer}"] = DenseLayer(ch, growth_rate, dtype)
                ch += growth_rate
            f[f"denseblock{i + 1}"] = block
            if i != len(self.block_config) - 1:
                f[f"transition{i + 1}"] = Transition(ch, ch // 2, dtype)
                ch //= 2
                if i < 2:
                    channels.append(ch)
        f["norm5"] = BatchNorm(ch)
        channels.append(ch)
        self.features = f
        self.channels = tuple(channels)  # of the five taps, strides 2..32

    def _run_block(self, layers: Sequence[nn.Module], x):
        if not (self.remat and torch.is_grad_enabled()):
            return _run_layers(layers, x)
        if self.remat_policy == "block":
            return checkpoint(_run_layers, layers, x)
        policy = _save_convs if self.remat_policy == "convs" else None
        for layer in layers:
            x = checkpoint(layer, x, policy=policy)
        return x

    def forward(self, x):
        f = self.features
        feats = []
        x = stride2(f["conv0"], x, 7, self.pad_style)
        x = f["norm0"](x, act="relu")
        feats.append(x)  # relu0: H/2
        x = stride2(_max_pool, x, 3, self.pad_style, value=float("-inf"))
        feats.append(x)  # pool0: H/4
        for i in range(len(self.block_config)):
            x = self._run_block(list(f[f"denseblock{i + 1}"].values()), x)
            if i != len(self.block_config) - 1:
                x = f[f"transition{i + 1}"](x)
                if i < 2:
                    feats.append(x)  # transition1: H/8, transition2: H/16
        feats.append(f["norm5"](x))  # H/32, pre-ReLU
        return feats
