"""driver.optimizer_device_ms.train (ms, device trace): the device time per
traced image of the kernels launched inside the program's ``bts.optimizer``
spans (zero_grad, the gradient norm, AdamW, the schedule;
``harness/spans.py``); None where the program opens no such span."""

from portbench.harness import spans


def read(rec):
    return spans.device_ms_per_image(rec, "bts.optimizer")
