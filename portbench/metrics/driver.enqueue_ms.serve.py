"""driver.enqueue_ms.serve (ms, host clock): the mean host time of a call of
``predict`` until it returns, before anything waits for the card, over the
window's calls."""

import statistics


def read(rec):
    return statistics.fmean(rec["enqueue_s"]) * 1e3 if rec["enqueue_s"] else None
