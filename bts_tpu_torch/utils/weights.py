"""JAX variables -> the port's ``state_dict``, through the JAX package's
own mapping (``bts_tpu/utils/torch_converter.py``: ``ENCODER_MAPPINGS``,
``decoder_mapping``, ``flax_to_torch_tensor``).

``torch_converter`` imports only numpy, but the ``bts_tpu.utils`` package
around it imports jax and orbax, so the file is loaded by path and the
package is never imported.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

import bts_tpu

ENCODER_PREFIXES = ("DenseNet", "ResNet", "MobileNetV2")  # flax encoder subtree names


@functools.lru_cache(maxsize=None)
def torch_converter():
    """``bts_tpu/utils/torch_converter.py`` as a module, without importing
    ``bts_tpu.utils``."""
    path = Path(bts_tpu.__file__).parent / "utils" / "torch_converter.py"
    spec = importlib.util.spec_from_file_location("bts_tpu_torch.utils._torch_converter", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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
    tc = torch_converter()
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
