"""Convert a ``bts_tpu`` (JAX) orbax checkpoint into a bts_tpu_torch
checkpoint that every entry point of the port restores.

    python -m bts_tpu_torch.tools.from_orbax \\
        --checkpoint_path runs/bts_v1/ckpt --encoder densenet161_bts \\
        --bts_size 512 --out converted_ckpt/ [--step N]

    python -m bts_tpu_torch.cli.bts_test @arguments/arguments_test_eigen.txt \\
        --checkpoint_path converted_ckpt/

The source is a ``bts_tpu/utils/checkpoint.py::CheckpointManager``
directory: ``<step>/_CHECKPOINT_METADATA`` and ``<step>/default/`` (orbax's
StandardCheckpointHandler, arrays in zarr over an OCDBT key-value store).
Both layouts are read: the full ``TrainState`` (step, params, batch_stats,
opt_state) that ``bts_main`` saves under ``ckpt/``, and the weights-only
tree (step, params, batch_stats) of ``ckpt_best/<metric>/``; only the
weights are taken.  ``--step`` picks a step (default: the latest).

Reading needs ``tensorstore`` alone (no JAX, no orbax): the tree's key
paths come from ``<step>/default/_METADATA`` (JSON), and each array of
``params`` and ``batch_stats`` is opened with tensorstore at the dot-joined
key path.  The numpy tree goes through ``utils/weights.py::
state_dict_from_jax`` (the port's copy of the weight mapping), is loaded
strictly into the port's model on the CPU, and is written as the
weights-only ``{"model", "step"}`` file that ``bts_convert`` writes.  The
run's ``config.json`` sidecar, where there is one beside the checkpoint
(the directory or its parent, where ``adopt_sidecar_geometry`` looks), is
copied into ``--out``, so the entry points keep the run's stride-2
geometry.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Optional

import numpy as np

from bts_tpu_torch.config import Config
from bts_tpu_torch.utils.checkpoint import CheckpointManager
from bts_tpu_torch.utils.weights import ORBAX_MARKER, load_state_dict, orbax_steps, state_dict_from_jax

WEIGHT_COLLECTIONS = ("params", "batch_stats")


def read_orbax_weights(directory: str, step: Optional[int] = None):
    """``({"params", "batch_stats"} numpy tree, step)`` of an orbax
    checkpoint directory at ``step`` (default: the latest)."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError("reading a bts_tpu orbax checkpoint needs the tensorstore package "
                          "(pip install tensorstore); convert where bts_tpu ran") from e
    steps = orbax_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no orbax checkpoint (<step>/{ORBAX_MARKER}) in {directory}")
    step = steps[-1] if step is None else step
    if step not in steps:
        raise FileNotFoundError(f"no step {step} in {directory}; steps {steps}")
    item = os.path.join(os.path.abspath(directory), str(step), "default")
    with open(os.path.join(item, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3"):
        raise NotImplementedError(f"{item}: only orbax's default layout (zarr over OCDBT) is read")

    def read(path):
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{item}/", "path": path}}
        return np.asarray(ts.open(spec, open=True).result().read().result())

    tree = {c: {} for c in WEIGHT_COLLECTIONS}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        if keys[0] not in WEIGHT_COLLECTIONS or entry["value_metadata"].get("skip_deserialize"):
            continue
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = read(".".join(keys))
    if not tree["params"]:
        raise ValueError(f"{item} holds no params")
    return tree, step


def convert(checkpoint_path: str, encoder: str, bts_size: int, out: str, step: Optional[int] = None) -> str:
    """Convert ``checkpoint_path`` (see the module docstring); returns the
    written step file."""
    from bts_tpu_torch.models.bts import create_model

    tree, step = read_orbax_weights(checkpoint_path, step)
    sd = state_dict_from_jax(tree, encoder, bts_size)
    model = create_model(Config(encoder=encoder, bts_size=bts_size), "cpu")
    load_state_dict(model, sd)  # strict: every weight of the model, by name and shape
    path = CheckpointManager(out).save(step, {"model": sd, "step": step})
    src = os.path.abspath(checkpoint_path)
    for d in (src, os.path.dirname(src)):
        sidecar = os.path.join(d, "config.json")
        if os.path.isfile(sidecar):
            shutil.copyfile(sidecar, os.path.join(out, "config.json"))
            break
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="bts_tpu orbax checkpoint -> bts_tpu_torch checkpoint")
    ap.add_argument("--checkpoint_path", required=True, help="a bts_tpu CheckpointManager directory")
    ap.add_argument("--encoder", default="densenet161_bts")
    ap.add_argument("--bts_size", type=int, default=512)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--step", type=int, default=None, help="default: the latest")
    args = ap.parse_args(argv)
    path = convert(args.checkpoint_path, args.encoder, args.bts_size, args.out, args.step)
    print(f"[from_orbax] wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
