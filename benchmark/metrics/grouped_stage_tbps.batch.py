"""The rate at which kernel 1 stages rows into shared memory:
``grouped.staged_bytes`` (block rows and query rows copied) over the
device seconds under ``rpt_grouped_score``, in TB/s.  A program that does
not count its staged bytes reads None."""

from benchmark import spans


def read(run):
    s = spans.stats(run)
    sec = run.range_seconds(("rpt_grouped_score",))
    if not s or not s.get("grouped.staged_bytes") or not sec:
        return None
    return s["grouped.staged_bytes"] / sec / 1e12
