"""The BTS model: encoder + dense-ASPP decoder + multi-scale LPG heads;
counterpart of ``bts_tpu/models/bts.py`` (NCHW).

Forward (as the JAX package):

    image (B, 3, H, W), ImageNet-normalized
    encoder -> skips h2, h4, h8, h16 and bottleneck h32
    upconv5 -> H/16, BN, cat skip16, conv5
    upconv4 -> H/8,  BN, cat skip8,  conv4, BN
    dense ASPP at H/8: rates 3, 6, 12, 18, 24, densely concatenated
    reduc8x8 -> LPG 8x8 -> depth8 / max_depth
    upconv3 -> H/4, BN, cat [skip4, depth8 at 1/4], conv3
    reduc4x4 -> LPG 4x4 -> depth4 / max_depth
    upconv2 -> H/2, BN, cat [skip2, depth4 at 1/2], conv2
    reduc2x2 -> LPG 2x2 -> depth2 / max_depth
    upconv1 -> H, reduc1x1 (sigmoid), cat [upconv1, d1x1, d2, d4, d8], conv1
    final_depth = max_depth * sigmoid(get_depth)

Returns (depth_8x8_scaled, depth_4x4_scaled, depth_2x2_scaled, depth_1x1,
final_depth), each (B, 1, H, W) f32.  BN, both sigmoids and the LPG maths
run in f32; convs in the compute dtype, from f32 weights.  ``model.train()``
is the JAX model's ``train=True``: BatchNorm normalises by batch statistics
and updates its running ones; nothing else changes.

``fused_tail="always"`` (inference only) replaces everything from upconv1 on
with the fused tail of ``ops/tail_cuda.py``: the three LPG maps come as 2x2
phase planes (K5) and upconv1 -> reduc1x1 -> concat -> conv1 -> get_depth
runs as one kernel (K6) in the TPU kernel's bf16 rounding schedule, reading
the same modules' weights.  "auto" keeps the literal tail, as the JAX
package does.

Spatial sharding (``--spatial_shards N --spatial_shards_w M``,
``parallel/spatial.py``): inside ``spatial.use(bands)`` the forward runs on
this rank's band of every activation; K1 runs on each band of the three
LPG heads unchanged (whole cells), the focal scaling is per sample, and
the fused tail is never taken (``create_model`` sets "never", as the JAX
package does: its row halos do not cross bands).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from bts_tpu_torch.config import resolved_encoder_pad
from bts_tpu_torch.models.encoders import build_encoder
from bts_tpu_torch.models.layers import (
    AtrousConv,
    BatchNorm,
    Conv2d,
    ConvBlock,
    Reduction1x1,
    UpConv,
)
from bts_tpu_torch.ops import tail_cuda
from bts_tpu_torch.ops.lpg import lpg_scaled_from_raw, lpg_strided, plane_from_spherical
from bts_tpu_torch.parallel import distributed as parallel
from bts_tpu_torch.parallel import spatial
from bts_tpu_torch.utils.profiling import span

KITTI_FOCAL = 715.0873
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FUSED_TAIL_CHOICES = ("auto", "always", "never")


def _tail_ok(fused_tail: str, train: bool, shape) -> bool:
    """Whether the decoder takes the fused tail (a copy of the JAX package's
    dispatch).  "auto" and "never" keep the literal tail, as does train mode
    (the fused tail has no backward); "always" on a shape the kernel does not
    take raises.  ``shape`` is iconv2's (B, Hh, W2, C)."""
    if fused_tail != "always" or train:
        return False
    if not tail_cuda.tail_supported(shape):
        raise ValueError(f"fused_tail='always' unsupported for decoder tail shape {shape}")
    return True


class BtsDecoder(nn.Module):
    """The BTS decoder; attribute names follow ``decoder_mapping``."""

    def __init__(
        self,
        channels: Sequence[int],
        max_depth: float = 80.0,
        num_features: int = 512,
        dtype: torch.dtype = torch.float32,
        use_pallas: str = "auto",
        lane_pad: int = 0,
        fused_tail: str = "auto",
        fused_upconv: bool = True,
    ):
        """``use_pallas`` keeps the config's name for the kernel switch:
        "auto" and "always" take the Hopper kernels (K1/K2, and K5/K6 on the
        fused tail), "never" their plain PyTorch versions.  ``fused_tail``:
        see the module docstring.  ``fused_upconv``: the five UpConvs in
        their fused form (the default, as in the JAX package) or the literal
        one (``layers.UpConv``)."""
        super().__init__()
        if fused_tail not in FUSED_TAIL_CHOICES:
            raise ValueError(f"fused_tail must be one of {FUSED_TAIL_CHOICES}, got {fused_tail!r}")
        if lane_pad > 1:
            raise NotImplementedError(
                "lane_pad (an experiment that changes the parameter tree) is not ported "
                "(ROADMAP.md, 'Do not port')"
            )
        c2, c4, c8, c16, cb = channels
        nf, dt = num_features, dtype
        self.max_depth = max_depth
        self.dtype = dtype
        self.num_features = num_features
        self.use_pallas = use_pallas
        self.fused_tail = fused_tail
        self.upconv5 = UpConv(cb, nf, dt, fused_upconv)
        self.bn5 = BatchNorm(nf)
        self.conv5 = ConvBlock(nf + c16, nf, dtype=dt)
        self.upconv4 = UpConv(nf, nf // 2, dt, fused_upconv)
        self.bn4 = BatchNorm(nf // 2)
        self.conv4 = ConvBlock(nf // 2 + c8, nf // 2, dtype=dt)
        self.bn4_2 = BatchNorm(nf // 2)
        co, cc4 = nf // 4, nf // 2 + c8
        self.daspp_3 = AtrousConv(nf // 2, co, 3, apply_bn_first=False, dtype=dt)
        self.daspp_6 = AtrousConv(cc4 + co, co, 6, dtype=dt)
        self.daspp_12 = AtrousConv(cc4 + 2 * co, co, 12, dtype=dt)
        self.daspp_18 = AtrousConv(cc4 + 3 * co, co, 18, dtype=dt)
        self.daspp_24 = AtrousConv(cc4 + 4 * co, co, 24, dtype=dt)
        self.daspp_conv = ConvBlock(nf // 2 + 5 * co, co, dtype=dt)
        self.reduc8x8 = Reduction1x1(co, nf // 4, dtype=dt)
        self.upconv3 = UpConv(co, nf // 4, dt, fused_upconv)
        self.bn3 = BatchNorm(nf // 4)
        self.conv3 = ConvBlock(nf // 4 + c4 + 1, nf // 4, dtype=dt)
        self.reduc4x4 = Reduction1x1(nf // 4, nf // 8, dtype=dt)
        self.upconv2 = UpConv(nf // 4, nf // 8, dt, fused_upconv)
        self.bn2 = BatchNorm(nf // 8)
        self.conv2 = ConvBlock(nf // 8 + c2 + 1, nf // 8, dtype=dt)
        self.reduc2x2 = Reduction1x1(nf // 8, nf // 16, dtype=dt)
        self.upconv1 = UpConv(nf // 8, nf // 16, dt, fused_upconv)
        self.reduc1x1 = Reduction1x1(nf // 16, nf // 32, is_final=True, dtype=dt)
        # depth_1x1 has one channel, or nf // 16 where reduc1x1 passes through
        self.conv1 = ConvBlock(nf // 16 + self.reduc1x1.out_channels + 3, nf // 16, dtype=dt)
        self.get_depth = ConvBlock(nf // 16, 1, act=None, dtype=dt)

    def _lpg(self, reduc: torch.Tensor, k: int) -> torch.Tensor:
        """Full-res LPG map (B, 1, H, W) f32 from a raw (B, 3, h, w) head;
        the (B, h, w, 3) view goes to the kernel with no copy."""
        with span("bts.lpg"):
            raw = reduc.permute(0, 2, 3, 1)
            return lpg_scaled_from_raw(raw, k, self.max_depth, self.use_pallas)[:, None]

    def _guidance(self, reduc: torch.Tensor, k: int, stride: int) -> torch.Tensor:
        """The LPG map at every ``stride``-th pixel, in the compute dtype."""
        with span("bts.lpg"):
            plane = plane_from_spherical(reduc.permute(0, 2, 3, 1), self.max_depth)
            return (lpg_strided(plane, k, stride) / self.max_depth)[:, None].to(self.dtype)

    def _tail(self, iconv2, reduc2, reduc4, reduc8):
        """The fused tail: the three LPG maps as phase planes (K5, no K1),
        then upconv1 .. get_depth in one kernel (K6) on bf16 iconv2 whatever
        the compute dtype; returns the four maps and sigmoid(final logits),
        each (B, 1, H, W) f32.  ``use_pallas="never"`` takes the plain
        versions of both."""
        plain = self.use_pallas == "never"
        phase = tail_cuda.lpg_phase_planes_plain if plain else tail_cuda.lpg_phase_planes
        tail = tail_cuda.fused_tail_plain if plain else tail_cuda.fused_tail
        with span("bts.lpg"):
            d8ph, d4ph, d2ph = (phase(r.permute(0, 2, 3, 1), k)
                                for r, k in ((reduc8, 8), (reduc4, 4), (reduc2, 2)))
            # both versions round iconv2 to bf16 (the kernel as it stages it)
            fin_ph, d1ph = tail(iconv2.permute(0, 2, 3, 1), d2ph, d4ph, d8ph, tail_cuda.tail_params(self))
            return tuple(tail_cuda.interleave2x2(p)[:, None] for p in (d8ph, d4ph, d2ph, d1ph, fin_ph))

    def forward(self, feats, focal: Optional[torch.Tensor] = None):
        skip2, skip4, skip8, skip16, bottleneck = feats
        dt, md = self.dtype, self.max_depth
        upconv5 = self.bn5(self.upconv5(F.relu(bottleneck)))  # H/16
        iconv5 = self.conv5(torch.cat([upconv5, skip16], dim=1))

        upconv4 = self.bn4(self.upconv4(iconv5))  # H/8
        concat4 = torch.cat([upconv4, skip8], dim=1)
        iconv4 = self.bn4_2(self.conv4(concat4))

        daspp_3 = self.daspp_3(iconv4)
        concat4_2 = torch.cat([concat4, daspp_3], dim=1)
        daspp_6 = self.daspp_6(concat4_2)
        concat4_3 = torch.cat([concat4_2, daspp_6], dim=1)
        daspp_12 = self.daspp_12(concat4_3)
        concat4_4 = torch.cat([concat4_3, daspp_12], dim=1)
        daspp_18 = self.daspp_18(concat4_4)
        concat4_5 = torch.cat([concat4_4, daspp_18], dim=1)
        daspp_24 = self.daspp_24(concat4_5)
        daspp_feat = self.daspp_conv(
            torch.cat([iconv4, daspp_3, daspp_6, daspp_12, daspp_18, daspp_24], dim=1)
        )

        b, _, hh, w2 = skip2.shape
        use_tail = _tail_ok(self.fused_tail, self.training, (b, hh, w2, self.num_features // 8))
        reduc8 = self.reduc8x8(daspp_feat)  # LPG head at 1/8
        depth_8x8_scaled = None if use_tail else self._lpg(reduc8, 8)
        upconv3 = self.bn3(self.upconv3(daspp_feat))  # H/4
        iconv3 = self.conv3(torch.cat([upconv3, skip4, self._guidance(reduc8, 8, 4)], dim=1))

        reduc4 = self.reduc4x4(iconv3)  # LPG head at 1/4
        depth_4x4_scaled = None if use_tail else self._lpg(reduc4, 4)
        upconv2 = self.bn2(self.upconv2(iconv3))  # H/2
        iconv2 = self.conv2(torch.cat([upconv2, skip2, self._guidance(reduc4, 4, 2)], dim=1))

        reduc2 = self.reduc2x2(iconv2)  # LPG head at 1/2
        if use_tail:
            depth_8x8_scaled, depth_4x4_scaled, depth_2x2_scaled, depth_1x1, final_sig = self._tail(
                iconv2, reduc2, reduc4, reduc8)
            final_depth = md * final_sig
        else:
            depth_2x2_scaled = self._lpg(reduc2, 2)
            upconv1 = self.upconv1(iconv2)  # H
            depth_1x1 = torch.sigmoid(self.reduc1x1(upconv1).float())
            concat1 = torch.cat(
                [upconv1, depth_1x1.to(dt), depth_2x2_scaled.to(dt),
                 depth_4x4_scaled.to(dt), depth_8x8_scaled.to(dt)],
                dim=1,
            )
            iconv1 = self.conv1(concat1)
            final_depth = md * torch.sigmoid(self.get_depth(iconv1).float())
        if focal is not None:
            # KITTI focal normalisation; samples with no focal recorded (<= 0)
            # pass through unchanged
            f = focal.reshape(-1, 1, 1, 1).float()
            final_depth = final_depth * torch.where(f > 0, f / KITTI_FOCAL, 1.0)
        return depth_8x8_scaled, depth_4x4_scaled, depth_2x2_scaled, depth_1x1, final_depth


class BtsModel(nn.Module):
    """Encoder + decoder; ``state_dict`` keys are ``encoder.<torchvision
    name>`` and ``decoder.<upstream name>``."""

    def __init__(self, encoder: nn.Module, decoder: BtsDecoder, dtype=torch.float32):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.dtype = dtype

    def forward(self, image: torch.Tensor, focal: Optional[torch.Tensor] = None):
        with span("bts.encoder"):
            feats = self.encoder(image.to(self.dtype))
        with span("bts.decoder"):
            return self.decoder(feats, focal)


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's initialisers: lecun-normal conv kernels (truncated at two
    standard deviations), zero biases; BatchNorm keeps scale 1, bias 0,
    mean 0, var 1 from construction."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv2d):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
    return model


def create_model(cfg, device="cpu") -> BtsModel:
    """Build a BtsModel from a ``bts_tpu_torch.config.Config``, seeded from
    ``cfg.seed``, in eval mode on ``device`` (``Trainer`` switches it to
    train mode).  The initialisation runs on the CPU, so a seed gives the
    same weights on every device.

    ``--spatial_shards N --spatial_shards_w M``: the model runs on bands
    over N*M processes of the initialised process group (``parallel/
    spatial.py``), which must hold a multiple of N*M, and keeps the literal
    decoder tail (``fused_tail`` "never")."""
    shards = cfg.spatial_shards * cfg.spatial_shards_w
    fused_tail = cfg.fused_tail
    if shards > 1:
        spatial.check_world(cfg.spatial_shards, cfg.spatial_shards_w, parallel.world())
        fused_tail = "never"
    dtype = DTYPES[cfg.compute_dtype]
    encoder = build_encoder(cfg.encoder, dtype=dtype, pad_style=resolved_encoder_pad(cfg),
                            remat=cfg.remat, remat_policy=cfg.remat_policy)
    decoder = BtsDecoder(
        encoder.channels,
        max_depth=cfg.max_depth,
        num_features=cfg.bts_size,
        dtype=dtype,
        use_pallas=cfg.use_pallas,
        fused_tail=fused_tail,
    )
    model = BtsModel(encoder, decoder, dtype)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    return model.to(device).eval()


def set_float32_precision() -> None:
    """Full f32 convs and matmuls: cuDNN would otherwise run f32 convs in
    TF32 (about three decimal digits).  bf16 compute is unaffected."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
