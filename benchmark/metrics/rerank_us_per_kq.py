"""Device microseconds per 1,000 queries of the per-pair rerank (kernel
6 and its distances), without the nested ``rpt_topk_tail``."""


def read(run):
    return run.us_per_kq(("rpt_rerank",))
