"""The 95th percentile of every frame's latency in the window (nearest
rank), ms: from the caller entering the call to the caller seeing that
frame's output complete."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
