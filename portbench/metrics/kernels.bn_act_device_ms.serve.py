"""kernels.bn_act_device_ms.serve (ms, device trace): the device time per traced
image of the port's eval-mode BatchNorm kernel (K7, ``bn_act_kernel`` in
``bts_tpu_torch/csrc/batchnorm.cu``), matched by name among the traced
window's kernels.  None where no such kernel ran (a program without it)."""

from portbench.harness import bn_act


def read(rec):
    got = bn_act.per_image(rec)
    return got[0] if got is not None else None
