"""device.launches_per_image.serve (launches, device trace): device kernels of
the host-and-card traced window linked by correlation id to its ops (copies
left out), over its images."""


def read(rec):
    tr = rec.get("trace")
    n = len(tr.kernels()) if tr is not None else 0
    return n / rec["trace_images"] if n else None
