"""frame_latency_ms_p95 (ms, host clock): the nearest-rank 95th percentile over
every frame of the window, each timed from the hand-over of its batch to
``predict`` until its final depth map is a host array."""

from portbench.harness import stats


def read(rec):
    return stats.percentile(rec["latencies_s"], 95) * 1e3 if rec.get("latencies_s") else None
