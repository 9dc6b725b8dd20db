"""model.encoder_launches_per_image.serve (launches, device trace): the kernels
launched per traced image inside the program's ``bts.encoder`` spans
(``harness/spans.py``); None where the program opens no such span."""

from portbench.harness import spans


def read(rec):
    return spans.launches_per_image(rec, "bts.encoder")
