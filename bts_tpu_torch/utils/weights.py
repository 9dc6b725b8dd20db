"""JAX variables -> the port's ``state_dict``, through the port's copy of
the JAX package's mapping (``utils/torch_converter.py``: ``ENCODER_MAPPINGS``,
``decoder_mapping``, ``flax_to_torch_tensor``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bts_tpu_torch.utils import torch_converter as tc

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
