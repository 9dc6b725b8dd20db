"""driver.input_device_ms.serve (ms, device trace): the device time per traced
image of the kernels launched inside the program's ``bts.input`` spans (the
upload, preprocessing or augmentation), children excluded
(``harness/spans.py``); None where the program opens no such span."""

from portbench.harness import spans


def read(rec):
    return spans.device_ms_per_image(rec, "bts.input")
