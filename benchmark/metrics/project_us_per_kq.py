"""Device microseconds per 1,000 queries of the operations launched
under ``rpt_project`` (kernel 11, the query projections)."""


def read(run):
    return run.us_per_kq(("rpt_project",))
