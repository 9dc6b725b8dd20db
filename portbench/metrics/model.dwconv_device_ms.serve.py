"""model.dwconv_device_ms.serve (ms, device trace): the device time per traced
image of the kernels launched inside the program's ``bts.dwconv`` spans
(each depthwise conv of EfficientNet's blocks with its padding and its
BatchNorm + SiLU; ``harness/spans.py``, self time: inside ``bts.encoder``
these are innermost); None where the program opens no such span."""

from portbench.harness import spans


def read(rec):
    return spans.device_ms_per_image(rec, "bts.dwconv")
