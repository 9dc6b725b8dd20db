"""ResNeXt-101 32x8d (Xie et al. 2017, torchvision's layout) as BTS's
encoder: bottleneck stages (3, 4, 23, 3), 32 groups of width 8; the taps
are the stem's ReLU and the four stages' outputs."""

import torch.nn.functional as F

from ..model import same_pad2

STAGES, GROUPS, WIDTH = (3, 4, 23, 3), 32, 8
CHANNELS = (64, 256, 512, 1024, 2048)
BRANCH_END_SCALE = 0.2


def bn_scale(name: str) -> float:
    """The scale of a BatchNorm's seeded weights: the last BatchNorm of each
    residual branch (``bn3``) starts small (Goyal et al. 2017 start it at
    0; 0.2 keeps a gradient in every leaf of the branch).  At 1 each of the
    33 blocks adds a branch as large as its input to the residual sum, and
    the train-mode forward carries a rounding gap at the stem ~300-fold to
    the depth map, which leaves no room between bfloat16 and fp8.  A
    trained ResNeXt's ``bn3`` scales are small too."""
    return BRANCH_END_SCALE if name.endswith(".bn3") else 1.0


def features(m, x, stages=STAGES, groups=GROUPS):
    e = "encoder."
    x = F.relu(m.bn(e + "bn1", m.conv(e + "conv1", same_pad2(x, 7), stride=2)))
    feats = [x]
    x = F.max_pool2d(same_pad2(x, 3, float("-inf")), 3, stride=2)
    for i, n in enumerate(stages):
        for j in range(n):
            q = f"{e}layer{i + 1}.{j}."
            stride = 2 if (j == 0 and i > 0) else 1
            y = F.relu(m.bn(q + "bn1", m.conv(q + "conv1", x)))
            if stride == 2:
                y = m.conv(q + "conv2", same_pad2(y, 3), stride=2, groups=groups)
            else:
                y = m.conv(q + "conv2", y, padding=1, groups=groups)
            y = m.bn(q + "bn3", m.conv(q + "conv3", F.relu(m.bn(q + "bn2", y))))
            if q + "downsample.0.weight" in m.p:
                x = m.bn(q + "downsample.1", m.conv(q + "downsample.0", x, stride=stride))
            x = m.round(F.relu(y + x))
        feats.append(x)
    return feats


def shapes(conv, bn, stages=STAGES, groups=GROUPS, width=WIDTH):
    conv("encoder.conv1", 64, 3, 7)
    bn("encoder.bn1", 64)
    c = 64
    for i, n in enumerate(stages):
        cout = 256 * 2 ** i
        inner = groups * width * 2 ** i
        for j in range(n):
            q, stride = f"encoder.layer{i + 1}.{j}.", 2 if (j == 0 and i > 0) else 1
            conv(q + "conv1", inner, c, 1)
            bn(q + "bn1", inner)
            conv(q + "conv2", inner, inner // groups, 3)
            bn(q + "bn2", inner)
            conv(q + "conv3", cout, inner, 1)
            bn(q + "bn3", cout)
            if c != cout or stride != 1:
                conv(q + "downsample.0", cout, c, 1)
                bn(q + "downsample.1", cout)
            c = cout
