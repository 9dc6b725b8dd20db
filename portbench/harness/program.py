"""What every driver takes from the system under test, ``bts_tpu_torch``
(each driver in ``portbench/drivers/`` takes its own entry point, such as
``predict`` or the ``Trainer``, itself):

- :func:`config`: the port's ``Config`` from a configuration file's keys;
- :func:`build_model`: the port's ``create_model`` (its modules built on the
  meta device, so no time goes into an initialisation that is overwritten),
  then the benchmark's seeded ``state_dict``;
- :func:`build_kernels`: the port's CUDA library, built at first use into
  the checkout's ``build/torch_kernels/``.
"""

from __future__ import annotations

import torch

from bts_tpu_torch.config import Config
from bts_tpu_torch.models.bts import create_model

MODEL_KEYS = ("encoder", "bts_size", "max_depth", "dataset", "compute_dtype", "use_pallas", "fused_tail",
              "encoder_pad")
TRAIN_KEYS = ("input_height", "input_width", "batch_size", "do_kb_crop", "do_random_rotate", "degree",
              "learning_rate", "end_learning_rate", "weight_decay", "adam_eps", "variance_focus", "remat",
              "remat_policy")


def config(model: dict, train: dict, seed: int, device, mode: str) -> Config:
    kw = {k: model[k] for k in MODEL_KEYS if k in model}
    if mode == "train":
        kw.update({k: train[k] for k in TRAIN_KEYS if k in train})
    return Config(mode=mode, seed=seed, device=str(torch.device(device).type), **kw)


def build_model(cfg: Config, state: dict, device) -> torch.nn.Module:
    with torch.device("meta"):
        model = create_model(cfg, "meta")
    model = model.to_empty(device=device)
    model.load_state_dict(state)
    return model.eval()


def build_kernels() -> float:
    """Build (or find built) and load the LPG kernels; the seconds nvcc took."""
    from bts_tpu_torch.ops import _build, lpg_cuda

    seconds = _build.build("lpg_fused").seconds
    lpg_cuda._lib()
    return seconds
