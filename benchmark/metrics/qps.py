"""Queries completed in the window over its seconds (closed loop)."""


def read(run):
    return run.qps
