"""model.backward_device_ms.train (ms, device trace): the device time per traced
image of the kernels launched inside the program's ``bts.backward`` spans
(the backward with remat's recompute and K2, run on autograd's threads while
the step waits inside the span; ``harness/spans.py``); None where the
program opens no such span."""

from portbench.harness import spans


def read(rec):
    return spans.device_ms_per_image(rec, "bts.backward")
