"""model.mfu.serve (%, host clock and counts): the model's published FLOPs per
image (one forward, ``portbench/counts/flops.py``) times the window's images per
second, over the card's peak in the compute dtype (``counts/peaks.py``)."""

from portbench.counts import peaks
from portbench.harness import stats


def read(rec):
    peak = peaks.peak(rec["device_name"], rec["model"]["compute_dtype"])
    if peak is None:
        return None
    return 100.0 * rec["flops_per_image"] * stats.rate(rec["images"], rec["window_s"]) / peak
