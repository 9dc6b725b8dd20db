"""EfficientNet-B5 (Tan & Le 2019, arXiv:1905.11946; timm's
``tf_efficientnet_b5`` layout and names) as BTS's encoder, tapped as
AdaBins (arXiv:2011.14141) taps it: the outputs of stages 0, 1, 2 and 4,
and the head's BatchNorm, before its SiLU (AdaBins takes the head's conv
before that BatchNorm).

B0 scaled by width 1.6 and depth 2.2, channels in multiples of 8: a 3x3/2
stem to 48, then stages of (expansion, kernel, stride, channels) repeated
``REPEATS`` times, then a 1x1 head to 2048.  Stage 0's blocks are
depthwise-separable (depthwise conv, BN+SiLU, squeeze-excite, 1x1 project,
BN), the others MBConv (1x1 expand, BN+SiLU, depthwise conv, BN+SiLU,
squeeze-excite, 1x1 project, BN); a block of stride 1 whose width does not
change adds its input.  The squeeze-excite: the mean over the frame, a 1x1
conv with bias to a quarter of the block's input width, SiLU, a 1x1 conv
with bias, a sigmoid, a channel-wise multiply.  BatchNorm eps 1e-3 (the TF
lineage's), with SiLU taken before the stored result is rounded.  No
stochastic depth."""

import torch
import torch.nn.functional as F

from ..model import BN_MOMENTUM, same_pad2

STAGES = ((1, 3, 1, 24), (6, 3, 2, 40), (6, 5, 2, 64), (6, 3, 2, 128), (6, 5, 1, 176), (6, 5, 2, 304),
          (6, 3, 1, 512))
REPEATS = (3, 5, 5, 7, 7, 9, 3)
STEM, HEAD = 48, 2048
CHANNELS = (24, 40, 64, 176, 2048)
TAPS = (0, 1, 2, 4)
BN_EPS = 1e-3
BRANCH_END_SCALE = 0.2


def bn_scale(name: str) -> float:
    """The scale of a BatchNorm's seeded weights: the last BatchNorm of each
    block's branch (``bn3`` of an MBConv block, ``bn2`` of stage 0's
    depthwise-separable ones) starts at 0.2, as ResNeXt's ``bn3`` does
    (``resnext101_bts.py``; timm trains EfficientNet with these zeroed at
    the start, ``zero_init_last``).  At 1, each of the 39 blocks adds a
    branch as large as its input: the taps grow stage by stage (rms 0.7 at
    H/2 to 1.5 at H/32 on one seed, 352x1216 on the CPU), and the bfloat16
    forward's logit gap comes within 5x of the fp8 control's (0.044 against
    0.234; at 0.2, 0.0087 against 0.089), too little room for a limit
    between them."""
    last = name.endswith(".bn3") or (name.startswith("encoder.blocks.0.") and name.endswith(".bn2"))
    return BRANCH_END_SCALE if last else 1.0


def bn(m, name, x, silu=False):
    """BatchNorm with eps 1e-3 (train mode: the batch's moments, the running
    ones moved as ``reference.model`` moves them), then SiLU where asked;
    the result is what the program stores, rounded by ``m.round``."""
    w, b = m.p[name + ".weight"], m.p[name + ".bias"]
    rm, rv = m.p[name + ".running_mean"], m.p[name + ".running_var"]
    if m.train:
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            rm.copy_(BN_MOMENTUM * rm + (1 - BN_MOMENTUM) * mean)
            rv.copy_(BN_MOMENTUM * rv + (1 - BN_MOMENTUM) * var)
    else:
        mean, var = rm, rv
    shape = (1, -1, 1, 1)
    y = (x - mean.view(shape)) * (torch.rsqrt(var + BN_EPS) * w).view(shape) + b.view(shape)
    return m.round(F.silu(y) if silu else y)


def squeeze_excite(m, name, x):
    s = m.conv(name + ".conv_expand", F.silu(m.conv(name + ".conv_reduce", x.mean((2, 3), keepdim=True))))
    return m.round(x * torch.sigmoid(s))


def depthwise(m, name, x, kernel, stride):
    if stride == 2:
        return m.conv(name, same_pad2(x, kernel), stride=2, groups=x.shape[1])
    return m.same_conv(name, x, groups=x.shape[1])


def features(m, x, repeats=REPEATS):
    e = "encoder."
    x = bn(m, e + "bn1", m.conv(e + "conv_stem", same_pad2(x, 3), stride=2), silu=True)
    feats, cin = [], STEM
    for i, ((expand, kernel, stride, cout), n) in enumerate(zip(STAGES, repeats)):
        for j in range(n):
            q, s = f"{e}blocks.{i}.{j}.", stride if j == 0 else 1
            if expand == 1:
                y = bn(m, q + "bn1", depthwise(m, q + "conv_dw", x, kernel, s), silu=True)
                y = bn(m, q + "bn2", m.conv(q + "conv_pw", squeeze_excite(m, q + "se", y)))
            else:
                y = bn(m, q + "bn1", m.conv(q + "conv_pw", x), silu=True)
                y = bn(m, q + "bn2", depthwise(m, q + "conv_dw", y, kernel, s), silu=True)
                y = bn(m, q + "bn3", m.conv(q + "conv_pwl", squeeze_excite(m, q + "se", y)))
            x = m.round(x + y) if s == 1 and cin == cout else y
            cin = cout
        if i in TAPS:
            feats.append(x)
    feats.append(bn(m, e + "bn2", m.conv(e + "conv_head", x)))
    return feats


def shapes(conv, bn, repeats=REPEATS):
    e = "encoder."
    conv(e + "conv_stem", STEM, 3, 3)
    bn(e + "bn1", STEM)
    cin = STEM
    for i, ((expand, kernel, _, cout), n) in enumerate(zip(STAGES, repeats)):
        for j in range(n):
            q, mid, se = f"{e}blocks.{i}.{j}.", cin * expand, cin // 4
            if expand == 1:
                conv(q + "conv_dw", cin, 1, kernel)
                bn(q + "bn1", cin)
            else:
                conv(q + "conv_pw", mid, cin, 1)
                bn(q + "bn1", mid)
                conv(q + "conv_dw", mid, 1, kernel)
                bn(q + "bn2", mid)
            conv(q + "se.conv_reduce", se, mid, 1, bias=True)
            conv(q + "se.conv_expand", mid, se, 1, bias=True)
            conv(q + ("conv_pw" if expand == 1 else "conv_pwl"), cout, mid, 1)
            bn(q + ("bn2" if expand == 1 else "bn3"), cout)
            cin = cout
    conv(e + "conv_head", HEAD, cin, 1)
    bn(e + "bn2", HEAD)
