"""The 95th percentile of request latency over every request of the
measured window (host clock, no profiler): the batch's tail in cells
whose requests the host paces, where it spreads too widely from run to
run to hold an end-to-end bound."""

import numpy as np


def read(r):
    lat = r["latency_s"]
    return float(np.percentile(np.asarray(lat), 95) * 1e3) if lat else None
