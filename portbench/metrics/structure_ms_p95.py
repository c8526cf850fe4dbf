"""The 95th percentile of every request's latency in the window, ms."""

import numpy as np


def read(r):
    if not r["units"].get("structures"):
        return None
    return 1e3 * float(np.percentile(np.asarray(r["latencies"]), 95))
