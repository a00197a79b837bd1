"""p50_ms: the median latency, send to reply, of every request answered in
the window."""

import numpy as np


def read(run):
    lat = run.latencies_s()
    return float(np.percentile(lat, 50) * 1e3) if lat.size else None
