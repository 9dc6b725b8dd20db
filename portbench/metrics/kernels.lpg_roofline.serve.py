"""kernels.lpg_roofline.serve (%, device trace and counts): the LPG head
kernels of the host-and-card traced window (K1 forward; K2 backward in
training), the least time each launch could take by its bytes and FLOPs
(``portbench/counts/lpg.py``, its k read from the kernel's name, the head's
shape from the cell's), summed, over their summed device time."""

import re

from portbench.counts import lpg, peaks

K1 = re.compile(r"lpg_fwd_kernel<true, (\d+),")  # the fused head's forward (K3 has false)
K2 = re.compile(r"lpg_bwd_kernel<(\d+), false,")  # its backward (K4 has true)
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def read(rec):
    tr = rec.get("trace")
    flop_peak = peaks.peak(rec["device_name"], "float32")
    byte_peak = peaks.peak(rec["device_name"], "hbm")
    if tr is None or flop_peak is None:
        return None
    raw = DTYPE_BYTES[rec["model"]["compute_dtype"]]
    bound = busy = 0.0
    for name, s, e in tr.kernels():
        for pattern, count in ((K1, lpg.k1), (K2, lpg.k2)):
            m = pattern.search(name)
            if m:
                f, nbytes = count(rec["batch"], rec["height"], rec["width"], int(m.group(1)), raw)
                bound += lpg.bound_s(f, nbytes, flop_peak, byte_peak)
                busy += e - s
    return 100.0 * bound / busy if busy > 0 else None
