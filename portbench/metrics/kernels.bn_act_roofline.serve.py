"""kernels.bn_act_roofline.serve (%, device trace and counts): the eval-mode
BatchNorm kernel (K7, ``bn_act_kernel`` in ``bts_tpu_torch/csrc/
batchnorm.cu``) against its byte bound: the least time each of its launches
could take, its bytes (``portbench/counts/bn.py``: the reference's
BatchNorm calls at the cell's shapes, one launch each) over the card's HBM
peak, summed over the traced forwards, over K7's summed device time in the
traced window.  None where the window holds no K7 launch, or another number
of them than the counted calls (a forward where some BatchNorm did not take
K7)."""

from portbench.counts import bn, peaks
from portbench.harness import bn_act


def read(rec):
    tr = rec.get("trace")
    byte_peak = peaks.peak(rec["device_name"], "hbm")
    if tr is None or byte_peak is None:
        return None
    times = [e - s for name, s, e in tr.kernels() if bn_act.KERNEL in name]
    m = rec["model"]
    calls = bn.calls(m["encoder"], m["bts_size"], m["max_depth"], rec["batch"], rec["height"], rec["width"])
    forwards = rec["trace_images"] // rec["batch"]
    if not times or len(times) != forwards * len(calls):
        return None
    bound = forwards * sum(bn.nbytes(e, c, m["compute_dtype"]) for e, c in calls) / byte_peak
    return 100.0 * bound / sum(times)
