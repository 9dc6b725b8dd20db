"""kernels.bn_act_launches_per_image.serve (launches, device trace): the launches
per traced image of the port's eval-mode BatchNorm kernel (K7,
``bn_act_kernel`` in ``bts_tpu_torch/csrc/batchnorm.cu``), matched by name
among the traced window's kernels: how many BatchNorms took the fused pass.
None where no such kernel ran (a program without it)."""

from portbench.harness import bn_act


def read(rec):
    got = bn_act.per_image(rec)
    return got[1] if got is not None else None
