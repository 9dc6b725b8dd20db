"""model.se_device_ms.serve (ms, device trace): the device time per traced
image of the kernels launched inside the program's ``bts.se`` spans (each
squeeze-excite of EfficientNet's blocks, from the global mean to the
channel-wise multiply; ``harness/spans.py``, self time: inside
``bts.encoder`` these are innermost); None where the program opens no such
span."""

from portbench.harness import spans


def read(rec):
    return spans.device_ms_per_image(rec, "bts.se")
