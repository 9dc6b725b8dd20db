"""kernels.lpg_heads_device_ms.serve (ms, device trace): the device time per
traced image of the kernels launched inside the program's ``bts.lpg`` spans
(the LPG heads: plane maths, K1, the strided guidance; ``harness/spans.py``);
None where the program opens no such span."""

from portbench.harness import spans


def read(rec):
    return spans.device_ms_per_image(rec, "bts.lpg")
