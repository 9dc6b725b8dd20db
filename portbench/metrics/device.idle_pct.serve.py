"""device.idle_pct.serve (%, device trace and host clock): the share of the
untraced window's time in which the card runs nothing: 1 - the card's busy
time per image in the traced window (the union of its device intervals, so
overlapping kernels count once) over the wall time per image of the
untraced window.  Tracing slows the host and so stretches the traced
window's idle gaps (~1.5x a frame at b1): a share taken within it would
measure the profiler."""


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr.device or not rec.get("images"):
        return None
    busy_per_image = tr.busy_s() / rec["trace_images"]
    wall_per_image = rec["window_s"] / rec["images"]
    return 100.0 * (1.0 - busy_per_image / wall_per_image)
