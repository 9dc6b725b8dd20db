"""model.encoder_device_ms.serve (ms, device trace): the device time per traced
image of the kernels launched inside the program's ``bts.encoder`` spans
(the encoder's forward; ``harness/spans.py``); None where the program opens
no such span."""

from portbench.harness import spans


def read(rec):
    return spans.device_ms_per_image(rec, "bts.encoder")
