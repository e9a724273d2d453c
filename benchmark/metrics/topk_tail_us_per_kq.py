"""Device microseconds per 1,000 queries of the selection tail (kernel 3
and the id gather) under ``rpt_topk_tail``."""


def read(run):
    return run.us_per_kq(("rpt_topk_tail",))
