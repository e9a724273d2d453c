"""Host microseconds from entering the served call to its return, the
mean over the untraced half of the window."""


def read(run):
    if not run.dispatch_s:
        return None
    return 1e6 * sum(run.dispatch_s) / len(run.dispatch_s)
