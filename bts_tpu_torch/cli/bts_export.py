"""Serving export entry point: checkpoint -> a saved ``torch.export`` program;
counterpart of ``bts_tpu/cli/bts_export.py`` (StableHLO there).

Restores a checkpoint, closes the weights over the same forward the test
entry point runs (``eval_preprocess`` + the model + KITTI focal scaling), and
exports it with ``torch.export`` under ``torch.no_grad()``: a graph that any
torch process with the port's op registrations loads
(``utils/serving.py::load_exported``) without the model code or the
checkpoint.  The hand-written kernels are ``torch.library`` ops, so the
graph calls them: K1 three times per forward, or K5 three times and K6 once
with ``--fused_tail always``.

    python -m bts_tpu_torch.cli.bts_export @arguments/arguments_test_eigen.txt \\
        --export_path model.pt2 [--export_platforms cuda|cpu]

The exported signature: uint8 images (B, input_height, input_width, 3)
[+ per-sample focal (B,) for KITTI] -> (B, H, W, 1) f32 depth in metres.
The batch size is the static ``--batch_size``.  A program is traced on one
device, which holds its weights and every device argument of its graph:
``--export_platforms`` names at most one, ``cuda`` or ``cpu`` (default:
``--device``).
"""

from __future__ import annotations

import os
import sys

import torch
from torch import nn

from bts_tpu_torch.config import adopt_sidecar_geometry, parse_args, require_device
from bts_tpu_torch.data.augment import eval_preprocess
from bts_tpu_torch.models.bts import set_float32_precision
from bts_tpu_torch.utils.weights import restore_model


class ServingForward(nn.Module):
    """``bts_test.predict``'s math as one module: uint8 (B, H, W, 3)
    [, focal (B,)] -> ``eval_preprocess`` -> NCHW -> the model (focal scaling
    by ``torch.where``, so no data-dependent branch) -> (B, H, W, 1) f32."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images_u8: torch.Tensor, focal: torch.Tensor | None = None) -> torch.Tensor:
        image = eval_preprocess(images_u8).permute(0, 3, 1, 2).contiguous()
        return self.model(image, focal)[-1].permute(0, 2, 3, 1)


def build_serve_fn(cfg, model: nn.Module):
    """The serving closure over ``model``'s weights and whether it takes a
    focal (KITTI): ``(serve, use_focal)``."""
    return ServingForward(model), cfg.dataset == "kitti"


def export_device(cfg) -> torch.device:
    """The device to trace on: ``--export_platforms`` (at most one, cuda or
    cpu), else ``--device``; raises without a card for cuda."""
    platforms = [p for p in cfg.export_platforms.split(",") if p]
    if len(platforms) > 1:
        raise ValueError(
            f"--export_platforms {cfg.export_platforms}: a torch.export program is traced on one "
            "device, which holds its weights and the device arguments of its graph; export once "
            "per platform"
        )
    platform = platforms[0] if platforms else cfg.device
    if platform not in ("cuda", "cpu"):
        raise ValueError(
            f"--export_platforms {platform}: bts_tpu_torch exports for cuda or cpu; a TPU "
            "program comes from the JAX package's bts_export"
        )
    return require_device(cfg.replace(device=platform))


def export_serving_fn(cfg, model: nn.Module) -> torch.export.ExportedProgram:
    """``torch.export`` of the serving forward at (batch_size, input_height,
    input_width), on the device of ``model``'s weights, under no_grad."""
    serve, use_focal = build_serve_fn(cfg, model)
    device = next(model.parameters()).device
    images = torch.zeros((cfg.batch_size, cfg.input_height, cfg.input_width, 3), dtype=torch.uint8,
                         device=device)
    args = (images, torch.ones(cfg.batch_size, device=device)) if use_focal else (images,)
    with torch.no_grad():
        return torch.export.export(serve, args, strict=False)


def main(argv=None):
    cfg = parse_args(argv, mode="test")
    cfg = adopt_sidecar_geometry(cfg)  # trained-run stride-2 geometry, if recorded
    if not cfg.export_path:
        print("[bts_tpu_torch] --export_path is required", file=sys.stderr)
        return 2
    device = export_device(cfg)
    set_float32_precision()
    model = restore_model(cfg, device)
    torch.export.save(export_serving_fn(cfg, model), cfg.export_path)
    sig = "images_u8, focal" if cfg.dataset == "kitti" else "images_u8"
    print(
        f"[bts_tpu_torch] exported serve({sig}) "
        f"b{cfg.batch_size} {cfg.input_height}x{cfg.input_width} "
        f"platforms=['{device.type}'] -> {cfg.export_path} "
        f"({os.path.getsize(cfg.export_path) / 1e6:.1f} MB)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
