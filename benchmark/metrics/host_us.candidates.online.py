"""Host microseconds a ``knn_grouped`` call spends in the query
projections and the descent (``rpt_project`` and ``rpt_candidates`` self
time)."""

from benchmark import spans


def read(run):
    return spans.host_us(run, "rpt_knn_grouped",
                         ("rpt_project", "rpt_candidates"))
