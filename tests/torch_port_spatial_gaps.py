"""The readings behind tests/test_torch_port_spatial.py's step rules: the
largest gaps of the banded f32 Trainer step (BatchNorm in train mode, and
frozen) against the one-process step, on the tests' tiny DenseNet, weights
and batch.  Run from the repository's root:

    PYTHONPATH=.:tests python tests/torch_port_spatial_gaps.py h2 hw4 w8

h2: H over 2; hw4: 2 x 2; w8: --spatial_shards 4 over two data groups
with --grad_accum_steps 2 and --shard_opt_state.  Prints, per layout and
step, the largest over the ranks of: the loss's relative gap, BatchNorm
buffers and parameters after the update (max abs), the whole gradient's
relative gap, each tensor's largest gap over its largest entry, and
whether every rank holds the same parameters."""

import sys
import tempfile
from pathlib import Path

import torch

import test_torch_port_spatial as t

LAYOUTS = {"h2": (2, {"spatial_shards": 2}, {}),
           "hw4": (4, {"spatial_shards": 2, "spatial_shards_w": 2}, {}),
           "w8": (8, {"spatial_shards": 4, "grad_accum_steps": 2, "shard_opt_state": True},
                  {"b": 4, "grad_accum_steps": 2})}


def gaps(got: dict, ref: dict) -> dict:
    grads = sum((got["grads"][k] - v).square().sum() for k, v in ref["grads"].items())
    norm = sum(v.square().sum() for v in ref["grads"].values())
    return {"loss": abs(got["loss"] / ref["loss"] - 1),
            "buffers": max((got["buffers"][k] - v).abs().max().item() for k, v in ref["buffers"].items()),
            "params": max((got["params"][k] - v).abs().max().item() for k, v in ref["params"].items()),
            "gradient": (grads / norm).sqrt().item(),
            "tensor": max(((got["grads"][k] - v).abs().max() / max(v.abs().max().item(), 1e-6)).item()
                          for k, v in ref["grads"].items())}


def main(names) -> None:
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t._jax_weights(tmp / "weights.pt")
        for name in names:
            world, kw, ref_kw = LAYOUTS[name]
            started = t._spawn(tmp, world, kw, tmp / "weights.pt", ("step", "frozen"))
            ref = t._one_process(tmp / "weights.pt", **ref_kw)
            got = t._records(started)
            for part in ("step", "frozen"):
                each = [gaps(r[part], ref[part]) for r in got]
                same = all(torch.equal(r[part]["params"][k], got[0][part]["params"][k])
                           for r in got for k in ref[part]["params"])
                print(name, part, {k: max(e[k] for e in each) for k in each[0]}, "same parameters:", same)


if __name__ == "__main__":
    main(sys.argv[1:] or list(LAYOUTS))
