"""The BTS model in plain PyTorch, as a function of a ``state_dict``.

This is the benchmark's own frozen statement of the model that
``bts_tpu_torch`` serves and trains (BTS, arXiv:1907.10326): an encoder
(``encoders/<name>.py``, found by the configuration's name), the
dense-ASPP decoder, and three local planar guidance (LPG) heads.  It imports nothing of the program.  Parameters and
buffers are read by the program's ``state_dict`` names, so one seeded
``state_dict`` loads into both.

It is written for clarity, not speed:

- every conv is ``F.conv2d`` in the dtype of its operands (float32 for the
  reference; for the control, ``quant`` rounds both operands and the
  result, and every BatchNorm output and residual sum, where the program
  holds them in its compute dtype);
- the UpConv is literal: nearest 2x upsample, then a 3x3 SAME conv, then ELU;
- the LPG is the paper's: the plane (n1, n2, n3, n4) from the head's three
  raw outputs, ``n4 / (n1*u + n2*v + n3)`` at every pixel of a k x k patch,
  divided by ``max_depth``; the guidance maps fed back into the decoder are
  that full-resolution map read at every ``stride``-th pixel;
- BatchNorm (eps 1.1e-5) in train mode normalises by the batch mean and the
  biased batch variance and moves the running statistics by
  ``0.99 * running + 0.01 * batch``; in eval mode it uses the running ones;
- stride-2 windows (the stems, the max pools and ResNet's stride-2 3x3
  convs) pad as TensorFlow's SAME does, the geometry of a model trained
  from scratch.

Call :func:`forward` with ``train=True`` to update ``buffers`` in place.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from . import encoders

BN_EPS = 1.1e-5
BN_MOMENTUM = 0.99
KITTI_FOCAL = 715.0873

Params = Dict[str, torch.Tensor]


class Model:
    """One forward of the model: ``p`` holds parameters and buffers by
    ``state_dict`` name; ``quant`` (or None) rounds each conv operand."""

    def __init__(self, p: Params, encoder: str, bts_size: int, max_depth: float, train: bool,
                 quant: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.p = p
        self.encoder = encoders.load(encoder)
        self.nf = bts_size
        self.max_depth = max_depth
        self.train = train
        self.quant = quant

    # -- primitives
    def conv(self, name: str, x, stride=1, padding=0, dilation=1, groups=1):
        w, b = self.p[name + ".weight"], self.p.get(name + ".bias")
        if self.quant is None:
            return F.conv2d(x, w, b, stride, padding, dilation, groups)
        # operands and result in the lower precision, as the program keeps
        # its conv operands and activations in the compute dtype
        return self.quant(F.conv2d(self.quant(x), self.quant(w), b, stride, padding, dilation, groups))

    def same_conv(self, name: str, x, dilation=1, groups=1):
        k = self.p[name + ".weight"].shape[-1]
        return self.conv(name, x, padding=dilation * (k // 2), dilation=dilation, groups=groups)

    def bn(self, name: str, x):
        w, b = self.p[name + ".weight"], self.p[name + ".bias"]
        rm, rv = self.p[name + ".running_mean"], self.p[name + ".running_var"]
        if self.train:
            mean = x.mean((0, 2, 3))
            var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
            with torch.no_grad():
                rm.copy_(BN_MOMENTUM * rm + (1 - BN_MOMENTUM) * mean)
                rv.copy_(BN_MOMENTUM * rv + (1 - BN_MOMENTUM) * var)
        else:
            mean, var = rm, rv
        shape = (1, -1, 1, 1)
        return self.round((x - mean.view(shape)) * (torch.rsqrt(var + BN_EPS) * w).view(shape) + b.view(shape))

    def round(self, x):
        """A stored activation: the program keeps BatchNorm's and the
        residual sums' results in its compute dtype, the control in fp8."""
        return x if self.quant is None else self.quant(x)

    # -- decoder pieces
    def block(self, name: str, x, act=F.elu):
        y = self.same_conv(name, x)
        return act(y) if act is not None else y

    def upconv(self, name: str, x):
        up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return F.elu(self.same_conv(name + ".conv", up))

    def atrous(self, name: str, x, dilation: int, bn_first: bool = True):
        if bn_first:
            x = self.bn(name + ".first_bn", x)
        x = self.conv(name + ".conv1", F.relu(x))
        return self.same_conv(name + ".conv2", F.relu(self.bn(name + ".bn", x)), dilation=dilation)

    def reduction(self, name: str, x):
        j = 0
        while f"{name}.conv{j + 1}.weight" in self.p:
            x = F.elu(self.conv(f"{name}.conv{j}", x))
            j += 1
        return self.conv(f"{name}.conv{j}", x) if f"{name}.conv{j}.weight" in self.p else x

    def lpg(self, raw, k: int):
        """The LPG map / max_depth at full resolution, (B, 1, h*k, w*k)."""
        return local_planar_guidance(plane_from_raw(raw, self.max_depth), k)[:, None] / self.max_depth

    def decoder(self, feats, focal):
        skip2, skip4, skip8, skip16, bottleneck = feats
        d = "decoder."
        upconv5 = self.bn(d + "bn5", self.upconv(d + "upconv5", F.relu(bottleneck)))
        iconv5 = self.block(d + "conv5", torch.cat([upconv5, skip16], 1))
        upconv4 = self.bn(d + "bn4", self.upconv(d + "upconv4", iconv5))
        concat4 = torch.cat([upconv4, skip8], 1)
        iconv4 = self.bn(d + "bn4_2", self.block(d + "conv4", concat4))
        daspp, cat = [self.atrous(d + "daspp_3", iconv4, 3, bn_first=False)], concat4
        for rate in (6, 12, 18, 24):
            cat = torch.cat([cat, daspp[-1]], 1)
            daspp.append(self.atrous(f"{d}daspp_{rate}", cat, rate))
        daspp_feat = self.block(d + "daspp_conv", torch.cat([iconv4] + daspp, 1))

        d8 = self.lpg(self.reduction(d + "reduc8x8", daspp_feat), 8)
        upconv3 = self.bn(d + "bn3", self.upconv(d + "upconv3", daspp_feat))
        iconv3 = self.block(d + "conv3", torch.cat([upconv3, skip4, d8[:, :, ::4, ::4]], 1))
        d4 = self.lpg(self.reduction(d + "reduc4x4", iconv3), 4)
        upconv2 = self.bn(d + "bn2", self.upconv(d + "upconv2", iconv3))
        iconv2 = self.block(d + "conv2", torch.cat([upconv2, skip2, d4[:, :, ::2, ::2]], 1))
        d2 = self.lpg(self.reduction(d + "reduc2x2", iconv2), 2)
        upconv1 = self.upconv(d + "upconv1", iconv2)
        d1 = torch.sigmoid(self.reduction(d + "reduc1x1", upconv1))
        iconv1 = self.block(d + "conv1", torch.cat([upconv1, d1, d2, d4, d8], 1))
        final = self.max_depth * torch.sigmoid(self.block(d + "get_depth", iconv1, act=None))
        if focal is not None:
            f = focal.reshape(-1, 1, 1, 1).float()
            final = final * torch.where(f > 0, f / KITTI_FOCAL, 1.0)
        return d8, d4, d2, d1, final

    def __call__(self, image, focal=None):
        return self.decoder(self.encoder.features(self, image), focal)


def forward(p: Params, image: torch.Tensor, focal: Optional[torch.Tensor], *, encoder: str,
            bts_size: int, max_depth: float, train: bool = False, quant=None):
    """The five outputs (d8, d4, d2, d1, final depth), each (B, 1, H, W), for
    ImageNet-normalised images (B, 3, H, W); ``focal`` scales the final
    depth by focal / 715.0873 (KITTI) where it is > 0."""
    return Model(p, encoder, bts_size, max_depth, train, quant)(image, focal)


def same_pad2(x: torch.Tensor, kernel: int, value: float = 0.0) -> torch.Tensor:
    """TensorFlow SAME padding of both spatial axes for a stride-2 window."""
    pads = []
    for size in (x.shape[-1], x.shape[-2]):
        total = max(((size + 1) // 2 - 1) * 2 + kernel - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def plane_from_raw(raw: torch.Tensor, max_depth: float) -> torch.Tensor:
    """A head's raw output (B, 3, h, w) -> plane (n1, n2, n3, n4), (B, 4, h, w):
    theta = sigmoid(x0) pi/3, phi = sigmoid(x1) 2pi, n4 = sigmoid(x2) max_depth,
    n = (sin theta cos phi, sin theta sin phi, cos theta)."""
    theta = torch.sigmoid(raw[:, 0]) * (math.pi / 3)
    phi = torch.sigmoid(raw[:, 1]) * (2 * math.pi)
    n4 = torch.sigmoid(raw[:, 2]) * max_depth
    return torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                        torch.cos(theta), n4], 1)


def local_planar_guidance(plane: torch.Tensor, k: int) -> torch.Tensor:
    """BTS eq. 5: plane (B, 4, h, w) -> depth (B, h*k, w*k); in-patch offsets
    u (column), v (row) = (i - (k-1)/2) / k."""
    b, _, h, w = plane.shape
    full = plane.repeat_interleave(k, dim=2).repeat_interleave(k, dim=3)
    off = (torch.arange(k, dtype=plane.dtype, device=plane.device) - (k - 1) / 2) / k
    u = off.repeat(w).view(1, 1, w * k)
    v = off.repeat(h).view(1, h * k, 1)
    n1, n2, n3, n4 = full.unbind(1)
    return n4 / (n1 * u + n2 * v + n3)


def state_shapes(encoder: str, bts_size: int):
    """Every parameter and BatchNorm buffer the model reads, (name, shape),
    encoder first."""
    enc, out = encoders.load(encoder), []

    def conv(name, cout, cin, k, bias=False):
        out.append((name + ".weight", (cout, cin, k, k)))
        if bias:
            out.append((name + ".bias", (cout,)))

    def bn(name, c):
        out.extend((f"{name}.{t}", (c,)) for t in ("weight", "bias", "running_mean", "running_var"))

    enc.shapes(conv, bn)

    def reduction(name, cin, nf, final=False):
        j = 0
        while nf >= 4:
            cout = (1 if final else 3) if nf < 8 else nf
            conv(f"{name}.conv{j}", cout, cin, 1, bias=True)
            cin, j = cout, j + 1
            if nf < 8:
                break
            nf //= 2
        return cin

    c2, c4, c8, c16, cb = enc.CHANNELS
    nf, d = bts_size, "decoder."
    co, cc4 = nf // 4, nf // 2 + c8
    conv(d + "upconv5.conv", nf, cb, 3, True)
    bn(d + "bn5", nf)
    conv(d + "conv5", nf, nf + c16, 3, True)
    conv(d + "upconv4.conv", nf // 2, nf, 3, True)
    bn(d + "bn4", nf // 2)
    conv(d + "conv4", nf // 2, nf // 2 + c8, 3, True)
    bn(d + "bn4_2", nf // 2)
    for i, rate in enumerate((3, 6, 12, 18, 24)):
        cin = nf // 2 if i == 0 else cc4 + i * co
        q = f"{d}daspp_{rate}."
        if i:
            bn(q + "first_bn", cin)
        conv(q + "conv1", 2 * co, cin, 1, True)
        bn(q + "bn", 2 * co)
        conv(q + "conv2", co, 2 * co, 3, True)
    conv(d + "daspp_conv", co, nf // 2 + 5 * co, 3, True)
    reduction(d + "reduc8x8", co, nf // 4)
    conv(d + "upconv3.conv", nf // 4, co, 3, True)
    bn(d + "bn3", nf // 4)
    conv(d + "conv3", nf // 4, nf // 4 + c4 + 1, 3, True)
    reduction(d + "reduc4x4", nf // 4, nf // 8)
    conv(d + "upconv2.conv", nf // 8, nf // 4, 3, True)
    bn(d + "bn2", nf // 8)
    conv(d + "conv2", nf // 8, nf // 8 + c2 + 1, 3, True)
    reduction(d + "reduc2x2", nf // 8, nf // 16)
    conv(d + "upconv1.conv", nf // 16, nf // 8, 3, True)
    r1 = reduction(d + "reduc1x1", nf // 16, nf // 32, final=True)
    conv(d + "conv1", nf // 16, nf // 16 + r1 + 3, 3, True)
    conv(d + "get_depth", 1, nf // 16, 3, True)
    return [(n, torch.Size(s)) for n, s in out]
