"""DenseNet-161 (Huang et al. 2017, torchvision's layout) as BTS's encoder:
growth 48, blocks (6, 12, 36, 24), 96 initial features; the taps are the
stem's ReLU, the max pool, transitions 1 and 2, and the last BatchNorm."""

import torch
import torch.nn.functional as F

from ..model import same_pad2

GROWTH, BLOCKS, INIT = 48, (6, 12, 36, 24), 96
CHANNELS = (96, 96, 192, 384, 2208)
PREFIX = "encoder.features."


def features(m, x, growth=GROWTH, blocks=BLOCKS):
    f = PREFIX
    x = m.conv(f + "conv0", same_pad2(x, 7), stride=2)
    x = F.relu(m.bn(f + "norm0", x))
    feats = [x]
    x = F.max_pool2d(same_pad2(x, 3, float("-inf")), 3, stride=2)
    feats.append(x)
    for i, n in enumerate(blocks):
        for j in range(1, n + 1):
            q = f"{f}denseblock{i + 1}.denselayer{j}."
            y = m.conv(q + "conv1", F.relu(m.bn(q + "norm1", x)))
            y = m.same_conv(q + "conv2", F.relu(m.bn(q + "norm2", y)))
            x = torch.cat([x, y], 1)
        if i != len(blocks) - 1:
            q = f"{f}transition{i + 1}."
            x = F.avg_pool2d(m.conv(q + "conv", F.relu(m.bn(q + "norm", x))), 2)
            if i < 2:
                feats.append(x)
    feats.append(m.bn(f + "norm5", x))
    return feats


def shapes(conv, bn, growth=GROWTH, blocks=BLOCKS, init=INIT):
    f, c, g = PREFIX, init, growth
    conv(f + "conv0", c, 3, 7)
    bn(f + "norm0", c)
    for i, n in enumerate(blocks):
        for j in range(1, n + 1):
            q = f"{f}denseblock{i + 1}.denselayer{j}."
            bn(q + "norm1", c)
            conv(q + "conv1", 4 * g, c, 1)
            bn(q + "norm2", 4 * g)
            conv(q + "conv2", g, 4 * g, 3)
            c += g
        if i != len(blocks) - 1:
            bn(f"{f}transition{i + 1}.norm", c)
            conv(f"{f}transition{i + 1}.conv", c // 2, c, 1)
            c //= 2
    bn(f + "norm5", c)
