"""Backbone registry (reference ``--encoder`` flag); counterpart of
``bts_tpu/models/encoders/__init__.py``, with all seven of its names, and
``efficientnet_b5_bts``, which the JAX package does not have.

Each encoder returns 5 NCHW feature maps at strides 2/4/8/16/32, the last
pre-activation (the decoder applies the ReLU).  Module names are
torchvision's (timm's for EfficientNet), so such a ``state_dict`` loads by
name.  A spec may add ``pretrained_pad`` (the stride-2 geometry its
published weights want, where it is not torchvision's) and ``unbanded``
(why the encoder cannot run on spatial bands).
"""

from __future__ import annotations

from typing import Tuple

import torch

from bts_tpu_torch.models.encoders.densenet import DenseNet
from bts_tpu_torch.models.encoders.efficientnet import EfficientNet
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
    "efficientnet_b5_bts": dict(
        cls=EfficientNet,
        kwargs=dict(),
        channels=(24, 40, 64, 176, 2048),
        pretrained_pad="same",  # TF-ported weights (timm's tf_efficientnet_b5*)
        unbanded="its squeeze-excite takes a global mean over each whole frame, which a spatial band does not hold",
    ),
}


def _spec(name: str) -> dict:
    if name not in ENCODERS:
        raise ValueError(f"unknown encoder {name!r}; choose from {sorted(ENCODERS)}")
    return ENCODERS[name]


def build_encoder(name: str, dtype=torch.float32, pad_style: str = "same",
                  remat: bool = False, remat_policy: str = "layer"):
    """The encoder ``name``; ``remat`` checkpoints each dense layer or block
    (DenseNet, by ``remat_policy``), bottleneck (ResNet, ResNeXt), inverted
    residual (MobileNetV2) or block (EfficientNet)."""
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
    ``features.1``, then the two 24-channel blocks; EfficientNet (timm's
    names): ``blocks.0``, ``blocks.1``."""
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
    elif cls is EfficientNet:
        names = ["conv_stem", "bn1"] + [f"blocks.{i}" for i in range(num_blocks)]
    else:
        stages = (("features.1",), ("features.2", "features.3"))
        names = ["features.0"] + [n for stage in stages[:num_blocks] for n in stage]
    return tuple(names)


def encoder_channels(name: str) -> Tuple[int, ...]:
    return _spec(name)["channels"]


def pretrained_pad(name: str) -> str:
    """The stride-2 geometry of the encoder's published weights: torchvision's
    (``"torch"``), or TF-SAME for weights ported from TensorFlow."""
    return _spec(name).get("pretrained_pad", "torch")


def resolved_pad(cfg) -> str:
    """Resolve ``encoder_pad='auto'`` of a Config: --pretrained_model weights
    need their own stride-2 window alignment (:func:`pretrained_pad`; see
    models/layers.py::pad2), torch's for torchvision weights, TF-SAME for
    TF-ported ones (EfficientNet's); scratch training keeps the TF-SAME
    geometry the parity tests pin."""
    if cfg.encoder_pad != "auto":
        return cfg.encoder_pad
    return pretrained_pad(cfg.encoder) if cfg.pretrained_model else "same"


def check_bands(name: str) -> None:
    """Raise where the encoder cannot run on spatial bands (--spatial_shards)."""
    why = _spec(name).get("unbanded")
    if why:
        raise ValueError(f"--spatial_shards/--spatial_shards_w > 1 is not supported with --encoder {name}: {why}")
