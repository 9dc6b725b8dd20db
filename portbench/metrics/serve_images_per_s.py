"""serve_images_per_s (images/s, host clock): frames whose depth map reached
the host in the window, over the window's seconds."""

from portbench.harness import stats


def read(rec):
    return stats.rate(rec["images"], rec["window_s"]) if rec["kind"] == "serve" else None
