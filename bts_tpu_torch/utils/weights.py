"""Model weights: JAX variables -> the port's ``state_dict``, through the
port's copy of the JAX package's mapping (``utils/torch_converter.py``:
``ENCODER_MAPPINGS``, ``decoder_mapping``, ``flax_to_torch_tensor``); the
strict load; and the checkpoint restore that the serving entry points
share (:func:`read_weights`, :func:`restore_model`)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bts_tpu_torch.utils import torch_converter as tc
from bts_tpu_torch.utils.checkpoint import CheckpointManager

ENCODER_PREFIXES = ("DenseNet", "ResNet", "MobileNetV2")  # flax encoder subtree names


def _leaf(tree: dict, path: Sequence[str]) -> np.ndarray:
    for p in path:
        tree = tree[p]
    return np.asarray(tree, dtype=np.float32)


def state_dict_from_jax(
    variables: dict,
    encoder_name: str,
    num_features: int,
    encoder_mapping: Optional[list] = None,
) -> Dict[str, torch.Tensor]:
    """A ``bts_tpu`` BtsModel ``{"params", "batch_stats"}`` tree (numpy or
    jax leaves) -> the port's ``state_dict``: ``encoder.<torchvision name>``
    and ``decoder.<upstream name>``, the split that
    ``torch_converter.split_full_state_dict`` undoes.

    ``encoder_mapping`` overrides ``ENCODER_MAPPINGS[encoder_name]`` for an
    encoder outside the registry (a test's tiny DenseNet).
    """
    params, stats = variables["params"], variables.get("batch_stats", {})
    enc = [k for k in params if k.split("_")[0] in ENCODER_PREFIXES]
    if len(enc) != 1:
        raise ValueError(f"could not locate the encoder subtree; candidates {enc}")
    if encoder_mapping is None:
        encoder_mapping = tc.ENCODER_MAPPINGS[encoder_name]()
    parts = (
        ("encoder.", enc[0], encoder_mapping),
        ("decoder.", "BtsDecoder_0", tc.decoder_mapping(num_features)),
    )
    sd = {}
    for prefix, subtree, mapping in parts:
        for flax_path, torch_key, kind in mapping:
            tree = stats if flax_path[-1] in ("mean", "var") else params
            arr = tc.flax_to_torch_tensor(_leaf(tree[subtree], flax_path), kind)
            sd[prefix + torch_key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def load_state_dict(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor]) -> None:
    """Strict load; the one key family skipped is ``num_batches_tracked``,
    which torch's own BatchNorm saves and the port's inference BatchNorm
    does not keep."""
    sd = {k: v for k, v in state_dict.items() if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=True)


ORBAX_MARKER = "_CHECKPOINT_METADATA"  # in each step directory of an orbax checkpoint


def orbax_steps(directory: str) -> list:
    """The steps of a ``bts_tpu`` (orbax) checkpoint directory, oldest first."""
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.isfile(os.path.join(directory, n, ORBAX_MARKER)))


def read_weights(path: str) -> Tuple[dict, Optional[int]]:
    """The model weights at ``path`` and their step: the latest step of a
    checkpoint directory, a trainer file ``{"model", "optimizer",
    "scheduler", "step"}`` (or ``bts_convert``'s ``{"model", "step"}``), or
    a bare ``state_dict`` (step None).  A missing path or a directory
    without a checkpoint raises FileNotFoundError.  Read on the CPU: a
    trainer file's optimizer state never reaches the card, and
    ``load_state_dict`` copies the weights into the model's device.  A
    ``bts_tpu`` (orbax) checkpoint raises ValueError naming the tool that
    converts it."""
    if os.path.isdir(path):
        if os.path.isfile(os.path.join(path, ORBAX_MARKER)) or orbax_steps(path):
            raise ValueError(
                f"{path} is a bts_tpu (orbax) checkpoint; convert it first: python -m "
                f"bts_tpu_torch.tools.from_orbax --checkpoint_path {path} --encoder ... "
                "--bts_size ... --out <dir>, then pass --checkpoint_path <dir>"
            )
        state = CheckpointManager(path).restore()
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in state:  # a trainer file
        return state["model"], int(state["step"])
    return state, None


def restore_model(cfg, device):
    """``create_model(cfg, device)`` with the weights of
    ``cfg.checkpoint_path`` (:func:`read_weights`, read before the model is
    built, so a bad path fails first; strict load), or the seeded
    initialisation with a warning when there is no path.  Prints what it
    restored."""
    from bts_tpu_torch.models.bts import create_model

    weights, step = read_weights(cfg.checkpoint_path) if cfg.checkpoint_path else (None, None)
    model = create_model(cfg, device)
    if weights is None:
        print("[bts_tpu_torch] WARNING: no --checkpoint_path, using random init")
    else:
        load_state_dict(model, weights)
        at = "" if step is None else f" @ step {step}"
        print(f"[bts_tpu_torch] restored {cfg.checkpoint_path}{at}")
    return model
