"""Backbone registry (reference ``--encoder`` flag); counterpart of
``bts_tpu/models/encoders/__init__.py``, with all seven of its names.

Each encoder returns 5 NCHW feature maps at strides 2/4/8/16/32, the last
pre-activation (the decoder applies the ReLU).  Module names are
torchvision's, so a torchvision ``state_dict`` loads by name.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bts_tpu_torch.models.encoders.densenet import DenseNet
from bts_tpu_torch.models.encoders.mobilenetv2 import MobileNetV2
from bts_tpu_torch.models.encoders.resnet import ResNet

# name -> (constructor kwargs, feature channels at strides 2/4/8/16/32)
ENCODERS = {
    "densenet121_bts": dict(
        cls=DenseNet,
        kwargs=dict(growth_rate=32, block_config=(6, 12, 24, 16), num_init_features=64),
        channels=(64, 64, 128, 256, 1024),
    ),
    "densenet161_bts": dict(
        cls=DenseNet,
        kwargs=dict(growth_rate=48, block_config=(6, 12, 36, 24), num_init_features=96),
        channels=(96, 96, 192, 384, 2208),
    ),
    "resnet50_bts": dict(
        cls=ResNet,
        kwargs=dict(stage_sizes=(3, 4, 6, 3)),
        channels=(64, 256, 512, 1024, 2048),
    ),
    "resnet101_bts": dict(
        cls=ResNet,
        kwargs=dict(stage_sizes=(3, 4, 23, 3)),
        channels=(64, 256, 512, 1024, 2048),
    ),
    "resnext50_bts": dict(
        cls=ResNet,
        kwargs=dict(stage_sizes=(3, 4, 6, 3), groups=32, width_per_group=4),
        channels=(64, 256, 512, 1024, 2048),
    ),
    "resnext101_bts": dict(
        cls=ResNet,
        kwargs=dict(stage_sizes=(3, 4, 23, 3), groups=32, width_per_group=8),
        channels=(64, 256, 512, 1024, 2048),
    ),
    "mobilenetv2_bts": dict(
        cls=MobileNetV2,
        kwargs=dict(),
        channels=(16, 24, 32, 96, 1280),
    ),
}


def _spec(name: str) -> dict:
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; choose from {sorted(ENCODERS)}")
    return ENCODERS[name]


def build_encoder(name: str, dtype=torch.float32, pad_style: str = "same",
                  remat: bool = False, remat_policy: str = "layer"):
    """The encoder ``name``; ``remat`` checkpoints each dense layer or block
    (DenseNet, by ``remat_policy``), bottleneck (ResNet, ResNeXt) or inverted
    residual (MobileNetV2)."""
    spec = _spec(name)
    kwargs = dict(spec["kwargs"])
    if spec["cls"] is DenseNet:
        kwargs["remat_policy"] = remat_policy  # a DenseNet knob, as in the JAX package
    return spec["cls"](dtype=dtype, pad_style=pad_style, remat=remat, **kwargs)


def freeze_prefixes(name: str, num_blocks: int) -> Tuple[str, ...]:
    """Encoder submodule names frozen by --fix_first_conv_block(s), in
    torchvision names: the stem plus the first one (``_block``) or two
    (``_blocks``) stages; the JAX package's ``freeze_prefixes`` in flax
    names.  DenseNet: each dense block with the transition after it;
    ResNet: ``layer1``, ``layer2``; MobileNetV2: the 16-channel block
    ``features.1``, then the two 24-channel blocks."""
    spec = _spec(name)
    cls = spec["cls"]
    if cls is DenseNet:
        cfg = spec["kwargs"]["block_config"]
        names = ["features.conv0", "features.norm0"]
        for stage in range(min(num_blocks, len(cfg))):
            names.append(f"features.denseblock{stage + 1}")
            if stage < len(cfg) - 1:
                names.append(f"features.transition{stage + 1}")
    elif cls is ResNet:
        sizes = spec["kwargs"]["stage_sizes"]
        names = ["conv1", "bn1"] + [f"layer{i + 1}" for i in range(min(num_blocks, len(sizes)))]
    else:
        stages = (("features.1",), ("features.2", "features.3"))
        names = ["features.0"] + [n for stage in stages[:num_blocks] for n in stage]
    return tuple(names)


def encoder_channels(name: str) -> Tuple[int, ...]:
    return _spec(name)["channels"]
