"""Device microseconds per 1,000 queries of the operations launched under
``rpt_candidates`` (kernels 7 and 8)."""


def read(run):
    return run.us_per_kq(("rpt_candidates",))
