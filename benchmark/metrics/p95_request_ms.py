"""The 95th percentile of request latency, from due to done, over every
request of the window (open loop)."""

import numpy as np


def read(run):
    if not run.latency_s:
        return None
    return float(np.percentile(np.asarray(run.latency_s), 95)) * 1e3
