"""The per-pair rerank's least time (``roofline.chunk_work`` on the
configured layout) over its device time, in percent."""


def read(run):
    return run.roofline_pct("rerank", ("rpt_rerank",))
