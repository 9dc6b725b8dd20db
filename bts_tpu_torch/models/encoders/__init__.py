"""Backbone registry (reference ``--encoder`` flag); counterpart of
``bts_tpu/models/encoders/__init__.py``.

Each encoder returns 5 NCHW feature maps at strides 2/4/8/16/32, the last
pre-activation.  Only the DenseNets are ported so far; the other names of
the JAX registry raise until their port lands (ROADMAP.md, "Modules to
port").
"""

from __future__ import annotations

from typing import Tuple

import torch

from bts_tpu_torch.models.encoders.densenet import DenseNet

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
}
NOT_PORTED = ("resnet50_bts", "resnet101_bts", "resnext50_bts", "resnext101_bts", "mobilenetv2_bts")


def _spec(name: str) -> dict:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"encoder {name!r} is not ported to bts_tpu_torch yet (ROADMAP.md, "
            "'Modules to port': remaining encoders)"
        )
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; choose from {sorted(ENCODERS)}")
    return ENCODERS[name]


def build_encoder(name: str, dtype=torch.float32, pad_style: str = "same"):
    spec = _spec(name)
    return spec["cls"](dtype=dtype, pad_style=pad_style, **spec["kwargs"])


def encoder_channels(name: str) -> Tuple[int, ...]:
    return _spec(name)["channels"]
