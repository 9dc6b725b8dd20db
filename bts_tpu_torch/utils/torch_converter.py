"""torchvision / upstream torch key names <-> the flax tree of ``bts_tpu``.

The port's own copy of the numpy-only mapping part of
``bts_tpu/utils/torch_converter.py``, for all seven encoders (the port
imports nothing of the JAX package; ``tests/test_torch_port_model.py`` holds
the copy equal to the original).  The port's modules are named by the torch keys, so these
mappings are what carries a ``bts_tpu`` checkpoint over
(``utils/weights.py``).

Layout rules:
- torch conv weight  (cout, cin, kh, kw) -> flax kernel (kh, kw, cin, cout)
- torch depthwise    (ch, 1, kh, kw)     -> flax grouped (kh, kw, 1, ch)
- torch BN weight/bias/running_mean/running_var ->
  flax BatchNorm {scale, bias} params + {mean, var} batch_stats.
  (the JAX BatchNorm wrapper nests an nn.BatchNorm named 'BatchNorm_0')

Each encoder family gets an explicit (flax_path, torch_key, kind) mapping.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# kind: how the torch tensor maps onto the flax leaf
K_CONV = "conv"  # transpose (2,3,1,0)
K_DEPTHWISE = "dw"  # transpose (2,3,1,0) (ch,1,kh,kw)->(kh,kw,1,ch)
K_DIRECT = "direct"  # 1-D BN vectors

MapEntry = Tuple[Tuple[str, ...], str, str]  # (flax path, torch key, kind)


def _bn(flax_prefix: Tuple[str, ...], torch_prefix: str) -> List[MapEntry]:
    """Our BatchNorm wrapper: <prefix>/BatchNorm_0/{scale,bias} params and
    batch_stats {mean,var} (paths returned against the respective trees)."""
    inner = flax_prefix + ("BatchNorm_0",)
    return [
        (inner + ("scale",), torch_prefix + ".weight", K_DIRECT),
        (inner + ("bias",), torch_prefix + ".bias", K_DIRECT),
        (inner + ("mean",), torch_prefix + ".running_mean", K_DIRECT),
        (inner + ("var",), torch_prefix + ".running_var", K_DIRECT),
    ]


def densenet_mapping(block_config: Tuple[int, ...]) -> List[MapEntry]:
    """torchvision densenet121/161 <-> bts_tpu.models.encoders.densenet."""
    m: List[MapEntry] = [(("Conv_0", "kernel"), "features.conv0.weight", K_CONV)]
    m += _bn(("BatchNorm_0",), "features.norm0")
    li = 0
    for b, num_layers in enumerate(block_config):
        for l in range(1, num_layers + 1):
            src = f"features.denseblock{b + 1}.denselayer{l}"
            dst = f"DenseLayer_{li}"
            li += 1
            m += _bn((dst, "BatchNorm_0"), f"{src}.norm1")
            m.append(((dst, "Conv_0", "kernel"), f"{src}.conv1.weight", K_CONV))
            m += _bn((dst, "BatchNorm_1"), f"{src}.norm2")
            m.append(((dst, "Conv_1", "kernel"), f"{src}.conv2.weight", K_CONV))
        if b < len(block_config) - 1:
            src = f"features.transition{b + 1}"
            dst = f"Transition_{b}"
            m += _bn((dst, "BatchNorm_0"), f"{src}.norm")
            m.append(((dst, "Conv_0", "kernel"), f"{src}.conv.weight", K_CONV))
    m += _bn(("BatchNorm_1",), "features.norm5")
    return m


def resnet_mapping(stage_sizes: Tuple[int, ...], downsample_first: bool = True) -> List[MapEntry]:
    """torchvision resnet50/101 + resnext50_32x4d/resnext101_32x8d <->
    bts_tpu.models.encoders.resnet (bottleneck-v1, global Bottleneck_j counter).

    Our Bottleneck projects the residual when channels or stride change;
    torchvision's 'downsample' exists on the same blocks (first of each
    stage, including stage 0's channel expansion 64->256).
    """
    m: List[MapEntry] = [(("Conv_0", "kernel"), "conv1.weight", K_CONV)]
    m += _bn(("BatchNorm_0",), "bn1")
    j = 0
    for stage, num_blocks in enumerate(stage_sizes):
        for b in range(num_blocks):
            src = f"layer{stage + 1}.{b}"
            dst = f"Bottleneck_{j}"
            j += 1
            m.append(((dst, "Conv_0", "kernel"), f"{src}.conv1.weight", K_CONV))
            m += _bn((dst, "BatchNorm_0"), f"{src}.bn1")
            m.append(((dst, "Conv_1", "kernel"), f"{src}.conv2.weight", K_CONV))
            m += _bn((dst, "BatchNorm_1"), f"{src}.bn2")
            m.append(((dst, "Conv_2", "kernel"), f"{src}.conv3.weight", K_CONV))
            m += _bn((dst, "BatchNorm_2"), f"{src}.bn3")
            has_downsample = b == 0  # stage 0: channel expand; others: stride
            if has_downsample:
                m.append(((dst, "Conv_3", "kernel"), f"{src}.downsample.0.weight", K_CONV))
                m += _bn((dst, "BatchNorm_3"), f"{src}.downsample.1")
    return m


_MBV2_CONFIG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
                (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def mobilenetv2_mapping() -> List[MapEntry]:
    """torchvision mobilenet_v2 <-> bts_tpu.models.encoders.mobilenetv2."""
    m: List[MapEntry] = [(("Conv_0", "kernel"), "features.0.0.weight", K_CONV)]
    m += _bn(("BatchNorm_0",), "features.0.1")
    j = 0  # InvertedResidual counter (ours); torch features index = j+1
    for t, c, n, s in _MBV2_CONFIG:
        for i in range(n):
            src = f"features.{j + 1}.conv"
            dst = f"InvertedResidual_{j}"
            j += 1
            if t != 1:
                m.append(((dst, "Conv_0", "kernel"), f"{src}.0.0.weight", K_CONV))
                m += _bn((dst, "BatchNorm_0"), f"{src}.0.1")
                dw, pw, pbn = f"{src}.1.0", f"{src}.2", f"{src}.3"
                dwbn = f"{src}.1.1"
                ci, bi = 1, 1
            else:
                dw, dwbn, pw, pbn = f"{src}.0.0", f"{src}.0.1", f"{src}.1", f"{src}.2"
                ci, bi = 0, 0
            m.append(((dst, f"Conv_{ci}", "kernel"), f"{dw}.weight", K_DEPTHWISE))
            m += _bn((dst, f"BatchNorm_{bi}"), dwbn)
            m.append(((dst, f"Conv_{ci + 1}", "kernel"), f"{pw}.weight", K_CONV))
            m += _bn((dst, f"BatchNorm_{bi + 1}"), pbn)
    m.append((("Conv_1", "kernel"), "features.18.0.weight", K_CONV))
    m += _bn(("BatchNorm_1",), "features.18.1")
    return m


ENCODER_MAPPINGS = {
    "densenet121_bts": lambda: densenet_mapping((6, 12, 24, 16)),
    "densenet161_bts": lambda: densenet_mapping((6, 12, 36, 24)),
    "resnet50_bts": lambda: resnet_mapping((3, 4, 6, 3)),
    "resnet101_bts": lambda: resnet_mapping((3, 4, 23, 3)),
    "resnext50_bts": lambda: resnet_mapping((3, 4, 6, 3)),
    "resnext101_bts": lambda: resnet_mapping((3, 4, 23, 3)),
    "mobilenetv2_bts": mobilenetv2_mapping,
}


def _conv(flax_prefix: Tuple[str, ...], torch_prefix: str) -> List[MapEntry]:
    """A biased conv: flax {kernel,bias} <-> torch {weight,bias}."""
    return [
        (flax_prefix + ("kernel",), torch_prefix + ".weight", K_CONV),
        (flax_prefix + ("bias",), torch_prefix + ".bias", K_DIRECT),
    ]


def _reduc_mapping(flax_mod: str, torch_prefix: str, nf0: int) -> List[MapEntry]:
    """reduction_1x1 conv chain: 1x1 convs halving nf0 down to the head
    (models.layers.Reduction1x1 loop), torch side named <prefix>.conv{j}."""
    m: List[MapEntry] = []
    j, nf = 0, nf0
    while nf >= 4:
        m += _conv((flax_mod, f"Conv_{j}"), f"{torch_prefix}.conv{j}")
        j += 1
        if nf < 8:
            break
        nf //= 2
    return m


def decoder_mapping(num_features: int) -> List[MapEntry]:
    """BTS decoder <-> a torch state_dict in the upstream-pytorch-style
    naming (upconv5.conv / bn5 / conv5 / daspp_<rate>.{first_bn,conv1,bn,
    conv2} / daspp_conv / reduc{8x8,4x4,2x2,1x1}.conv{j} / conv{3,2,1} /
    get_depth).  Paths are RELATIVE to the BtsDecoder subtree (the
    ``BtsDecoder_0`` key inside a full BtsModel tree).

    The upstream lineage's exact state_dict keys are unverifiable offline
    (SURVEY.md §8 — the reference mount is empty); when a real released
    checkpoint becomes available, loading it through this mapping needs at
    most a key-rename shim, never a transpose/topology change.  Until then
    the mapping is pinned by tests/test_torch_oracle.py's hand-built torch
    decoder: an INDEPENDENT torch compute stack must reproduce the flax
    decoder's five outputs bit-for-tolerance through this exact mapping.

    ``num_features`` must be >= 128 so every reduction head (down to
    num_features//32 for reduc1x1) has its full conv chain.
    """
    if num_features < 128:
        raise ValueError(
            f"decoder_mapping requires num_features >= 128 (reduc1x1 head "
            f"needs num_features//32 >= 4); got {num_features}"
        )
    m: List[MapEntry] = []
    m += _conv(("UpConv_0", "ConvBlock_0", "Conv_0"), "upconv5.conv")
    m += _bn(("BatchNorm_0",), "bn5")
    m += _conv(("ConvBlock_0", "Conv_0"), "conv5")
    m += _conv(("UpConv_1", "ConvBlock_0", "Conv_0"), "upconv4.conv")
    m += _bn(("BatchNorm_1",), "bn4")
    m += _conv(("ConvBlock_1", "Conv_0"), "conv4")
    m += _bn(("BatchNorm_2",), "bn4_2")
    for i, rate in enumerate((3, 6, 12, 18, 24)):
        mod, tp = f"AtrousConv_{i}", f"daspp_{rate}"
        bn_i = 0
        if i > 0:  # rate-3 cell has apply_bn_first=False (models.layers)
            m += _bn((mod, "BatchNorm_0"), f"{tp}.first_bn")
            bn_i = 1
        m += _conv((mod, "Conv_0"), f"{tp}.conv1")
        m += _bn((mod, f"BatchNorm_{bn_i}"), f"{tp}.bn")
        m += _conv((mod, "Conv_1"), f"{tp}.conv2")
    m += _conv(("ConvBlock_2", "Conv_0"), "daspp_conv")
    m += _reduc_mapping("Reduction1x1_0", "reduc8x8", num_features // 4)
    m += _conv(("UpConv_2", "ConvBlock_0", "Conv_0"), "upconv3.conv")
    m += _bn(("BatchNorm_3",), "bn3")
    m += _conv(("ConvBlock_3", "Conv_0"), "conv3")
    m += _reduc_mapping("Reduction1x1_1", "reduc4x4", num_features // 8)
    m += _conv(("UpConv_3", "ConvBlock_0", "Conv_0"), "upconv2.conv")
    m += _bn(("BatchNorm_4",), "bn2")
    m += _conv(("ConvBlock_4", "Conv_0"), "conv2")
    m += _reduc_mapping("Reduction1x1_2", "reduc2x2", num_features // 16)
    m += _conv(("UpConv_4", "ConvBlock_0", "Conv_0"), "upconv1.conv")
    m += _reduc_mapping("Reduction1x1_3", "reduc1x1", num_features // 32)
    m += _conv(("ConvBlock_5", "Conv_0"), "conv1")
    m += _conv(("ConvBlock_6", "Conv_0"), "get_depth")
    return m


def flax_to_torch_tensor(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind in (K_CONV, K_DEPTHWISE):
        return np.ascontiguousarray(arr.transpose(3, 2, 0, 1))
    return np.asarray(arr)


def split_full_state_dict(
    sd: Dict[str, np.ndarray],
) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """Split a full BTS torch checkpoint into (encoder_sd, decoder_sd) with
    prefixes normalized to what ENCODER_MAPPINGS/decoder_mapping expect.

    Handles the upstream-pytorch-lineage key shapes (SURVEY.md §2 — exact
    names unverifiable offline, so each is normalized rather than assumed):
      - an optional ``module.`` DataParallel wrapper on every key,
      - encoder keys under ``encoder.base_model.`` / ``encoder.`` /
        ``base_model.`` (torchvision names underneath),
      - decoder keys under ``decoder.`` (decoder_mapping names underneath).
    A checkpoint with NO encoder./decoder. split raises — it is either an
    encoder-only file (use load_pretrained_encoder) or an unknown layout.
    """
    enc, dec = {}, {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module.") :]
        if k.startswith("decoder."):
            dec[k[len("decoder.") :]] = v
        elif k.startswith("encoder."):
            kk = k[len("encoder.") :]
            if kk.startswith("base_model."):
                kk = kk[len("base_model.") :]
            enc[kk] = v
        elif k.startswith("base_model."):
            enc[k[len("base_model.") :]] = v
    if not enc or not dec:
        raise ValueError(
            f"not a full BTS checkpoint: {len(enc)} encoder / {len(dec)} "
            "decoder keys after prefix normalization (encoder-only files go "
            "through load_pretrained_encoder / --pretrained_model)"
        )
    return enc, dec
