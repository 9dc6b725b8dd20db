"""One process per card under ``torch.distributed``; counterpart of
``bts_tpu/parallel/mesh.py``.

The JAX package builds a 1-D ``data`` mesh over every device it sees and
lets XLA insert the gradient ``psum``.  Here each card runs its own process,
launched by ``torchrun`` (``python -m torch.distributed.run``), which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``:

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m bts_tpu_torch.cli.bts_main @arguments/arguments_train_eigen.txt

Rank r loads the rows :func:`rank_rows` gives it of every global batch, the
model is wrapped in ``DistributedDataParallel`` (``training/trainer.py``),
and BatchNorm's batch moments and the silog sums are all-reduced, so a step
at world size N equals the one-process step on the same global batch.
NCCL carries a CUDA run, gloo a CPU run (``--device cpu``).
"""

from __future__ import annotations

import datetime
import os
from typing import List

import torch
import torch.distributed as dist

ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def world() -> int:
    return dist.get_world_size() if initialized() else 1


def is_primary() -> bool:
    """Rank 0, or the only process: the one that writes checkpoints,
    summaries and logs."""
    return rank() == 0


def barrier() -> None:
    if initialized():
        dist.barrier()


def local_device(device: torch.device) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (made current) for a CUDA
    device without an index, else ``device`` as it is."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def maybe_init_distributed(cfg) -> bool:
    """Join the process group that torchrun's environment describes: NCCL
    for ``--device cuda``, gloo for ``--device cpu``.  Returns True when
    this call initialised the group (the caller destroys it at the end).

    Nothing happens when a group is already initialised (a caller that made
    its own) or when the environment names no group: one process.  A
    configured rendezvous that fails raises, never falling back to one
    process, which would train alone on the whole dataset into the shared
    log directory.  ``BTS_DIST_INIT_TIMEOUT`` (seconds, as in the JAX
    package) bounds the rendezvous.  ``--num_devices`` N > 0 must be the
    world size; -1 takes the world size.
    """
    if not initialized() and all(k in os.environ for k in ENV):
        timeout = datetime.timedelta(seconds=int(os.environ.get("BTS_DIST_INIT_TIMEOUT", 1800)))
        device = local_device(torch.device(cfg.device))
        backend = "nccl" if device.type == "cuda" else "gloo"
        try:
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
        except Exception as e:
            raise RuntimeError(
                f"[bts_tpu_torch] a process group is configured (RANK={os.environ['RANK']}, "
                f"WORLD_SIZE={os.environ['WORLD_SIZE']}, MASTER_ADDR={os.environ['MASTER_ADDR']}, "
                f"MASTER_PORT={os.environ['MASTER_PORT']}) but its rendezvous failed: {e}\n"
                "Refusing to fall back to a one-process run."
            ) from e
        started = True
    else:
        started = False
    if cfg.num_devices > 0 and cfg.num_devices != world():
        raise SystemExit(
            f"--num_devices {cfg.num_devices} but the world size is {world()}: launch one "
            f"process per card, python -m torch.distributed.run --nproc_per_node {cfg.num_devices} ..."
        )
    return started


def rank_rows(batch_size: int, accum: int, rank: int, world: int) -> List[int]:
    """The rows of a global batch that rank ``rank`` of ``world`` trains on.

    Microbatch i of the global batch is rows [i*mb, (i+1)*mb) (mb =
    batch_size / accum), as in the one-process step, and the rank takes its
    contiguous share of each: rank r's microbatch i is rows
    [i*mb + r*lmb, i*mb + (r+1)*lmb), lmb = mb / world.  With ``accum`` 1
    that is the contiguous slice [r*lb, (r+1)*lb)."""
    if batch_size % (accum * world):
        raise ValueError(
            f"batch_size {batch_size} not divisible by --grad_accum_steps {accum} x {world} processes")
    mb = batch_size // accum
    lmb = mb // world
    return [i * mb + rank * lmb + j for i in range(accum) for j in range(lmb)]
