"""The 95th percentile of how late a request's call began after it was
due (the host's lag), over the untraced half of the window."""

import numpy as np


def read(run):
    if not run.late_s:
        return None
    return float(np.percentile(np.asarray(run.late_s), 95)) * 1e3
