"""bts_tpu_torch — the BTS depth-estimation system in PyTorch, for NVIDIA Hopper.

A port of ``bts_tpu`` (JAX on a TPU) that lives beside it; ``bts_tpu`` stays
the reference each module is tested against.  The layout mirrors it:

  bts_tpu/models/{bts,layers,encoders}  -> bts_tpu_torch/models/...  (nn.Module, NCHW)
  bts_tpu/ops/lpg.py, lpg_pallas.py     -> bts_tpu_torch/ops/lpg.py, lpg_cuda.py
                                           + csrc/lpg_fused.cu (sm_90a kernel)
  bts_tpu/data/augment.py (eval part)   -> bts_tpu_torch/data/augment.py
  bts_tpu/utils/torch_converter.py      -> bts_tpu_torch/utils/weights.py
  bts_tpu/cli/bts_test.py               -> bts_tpu_torch/cli/bts_test.py

The JAX-free host modules are reused, not copied: the config system, the
test-mode data loader and the depth PNG I/O.  Nothing here imports JAX.
"""

__version__ = "0.1.0"

from bts_tpu.config import Config, parse_args  # noqa: F401
