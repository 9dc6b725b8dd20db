"""Convert a FULL BTS torch checkpoint (encoder + decoder) into a
bts_tpu_torch checkpoint every entry point restores; counterpart of
``bts_tpu/cli/bts_convert.py``.

The reference lineage distributes trained models as torch ``.pth`` files:

    python -m bts_tpu_torch.cli.bts_convert \\
        --torch_checkpoint bts_eigen_v2.pth \\
        --encoder densenet161_bts --bts_size 512 --max_depth 80 \\
        --dataset kitti --checkpoint_path converted_ckpt/

    python -m bts_tpu_torch.cli.bts_test @arguments/arguments_test_eigen.txt \\
        --checkpoint_path converted_ckpt/

The output is a weights-only ``CheckpointManager`` directory, step 0
``{"model": state_dict, "step": 0}``, which ``utils/weights.py::read_weights``
restores, and a ``config.json`` geometry sidecar recording
``encoder_pad=torch``, so every entry point that restores it adopts torch stride-2
window alignment (the weights were trained under it; see
``config.adopt_sidecar_geometry``).

Key layouts (``utils/torch_converter.py::split_full_state_dict``): an
optional ``module.`` DataParallel prefix, ``encoder[.base_model].`` /
``decoder.`` prefixes, and ``{'model' | 'state_dict' | 'model_state_dict':
state_dict, ...}`` training-checkpoint wrappers are all normalised.  Every
weight of the model is taken by name; a missing one fails with its name,
never a partial import.  The file is read with ``weights_only=True``.
The strict load runs on ``--device`` (default ``cuda``, which raises
without a card; ``--device cpu`` converts on the host); the checkpoint is
written from host memory either way.
"""

from __future__ import annotations

import os
import sys

import torch

from bts_tpu_torch.config import parse_args, require_device, write_config_sidecar
from bts_tpu_torch.models.bts import create_model
from bts_tpu_torch.models.encoders import resolved_pad
from bts_tpu_torch.utils.checkpoint import CheckpointManager
from bts_tpu_torch.utils.torch_converter import split_full_state_dict
from bts_tpu_torch.utils.weights import load_state_dict


def read_full_state_dict(path: str) -> dict:
    """A full BTS torch checkpoint -> ``encoder.<torchvision name>`` /
    ``decoder.<upstream name>`` keys, the port model's ``state_dict`` names."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    # released training checkpoints commonly wrap the weights:
    # {'model': sd, 'optimizer': ..., 'epoch'/'global_step': ...}
    for wrapper in ("model", "state_dict", "model_state_dict"):
        if wrapper in sd and hasattr(sd[wrapper], "items") and len(sd[wrapper]) > 4:
            sd = sd[wrapper]
            break
    enc, dec = split_full_state_dict(sd)
    return {**{f"encoder.{k}": v for k, v in enc.items()}, **{f"decoder.{k}": v for k, v in dec.items()}}


def main(argv=None) -> int:
    cfg = parse_args(argv, mode="test")
    if not cfg.torch_checkpoint:
        print("bts_convert: --torch_checkpoint is required")
        return 2
    if not cfg.checkpoint_path:
        print("bts_convert: --checkpoint_path (output directory) is required")
        return 2
    out = os.path.abspath(cfg.checkpoint_path)
    device = require_device(cfg)

    # released torch weights imply torch stride-2 geometry, recorded for
    # every entry point downstream via the sidecar
    cfg = cfg.replace(encoder_pad="torch")
    model = create_model(cfg, device)
    full = read_full_state_dict(cfg.torch_checkpoint)
    missing = [k for k in model.state_dict() if k not in full]
    if missing:
        raise KeyError(f"{missing[0]} missing from {cfg.torch_checkpoint} ({len(missing)} keys missing)")
    load_state_dict(model, {k: full[k] for k in model.state_dict()})
    print(f"[bts_convert] imported {len(model.state_dict())} tensors from {cfg.torch_checkpoint}")

    weights = {k: v.cpu() for k, v in model.state_dict().items()}
    CheckpointManager(out).save(0, {"model": weights, "step": 0})
    write_config_sidecar(cfg, out, resolved_pad(cfg))
    print(f"[bts_convert] wrote weights-only checkpoint + geometry sidecar to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
