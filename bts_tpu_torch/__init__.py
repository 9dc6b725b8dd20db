"""bts_tpu_torch — the BTS depth-estimation system in PyTorch, for NVIDIA Hopper.

A port of ``bts_tpu`` (JAX on a TPU) that lives beside it; ``bts_tpu`` stays
the reference each module is tested against.  The layout mirrors it:

  bts_tpu/config.py                     -> bts_tpu_torch/config.py (+ --device)
  bts_tpu/models/{bts,layers,encoders}  -> bts_tpu_torch/models/...  (nn.Module, NCHW)
  bts_tpu/ops/lpg.py, lpg_pallas.py     -> bts_tpu_torch/ops/lpg.py, lpg_cuda.py
                                           + csrc/lpg_fused.cu (sm_90a kernels,
                                           forward and backward)
  bts_tpu/ops/tail_pallas.py            -> bts_tpu_torch/ops/tail_cuda.py
                                           + csrc/fused_tail.cu
  bts_tpu/ops/silog.py                  -> bts_tpu_torch/ops/silog.py
  bts_tpu/data/{augment,dataloader,crops,depth_io}.py
                                        -> bts_tpu_torch/data/...
  bts_tpu/training/{optimizer,trainer}  -> bts_tpu_torch/training/...
  bts_tpu/utils/{torch_converter,checkpoint,summary,preemption,serving}
                                        -> bts_tpu_torch/utils/... (+ weights.py)
  bts_tpu/evaluation/{metrics,best}.py  -> bts_tpu_torch/evaluation/...
  bts_tpu/parallel/mesh.py              -> bts_tpu_torch/parallel/distributed.py
                                           (torch.distributed, DDP, ZeRO-1)
  bts_tpu/cli/{bts_test,bts_main,bts_eval,bts_convert,bts_export,bts_serve,bts_sequence}.py
                                        -> bts_tpu_torch/cli/... (export: torch.export)

The port keeps its own copies of the JAX package's jax-free host modules
(config, weight-name mapping, crops, depth PNG I/O) and imports nothing of
``bts_tpu`` and nothing of JAX.
"""

__version__ = "0.2.0"

from bts_tpu_torch.config import Config, parse_args  # noqa: F401
