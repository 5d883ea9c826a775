"""Median latency of the window's ``search_many`` requests, from the
call to its last answer in host memory (host clock).  A per-layer
metric: the card idles most of such a window (PERF.md), so the host
paces it."""

import numpy as np


def read(run):
    if run.send != "requests" or not len(run.latency_ms):
        return None
    return float(np.percentile(run.latency_ms, 50))
