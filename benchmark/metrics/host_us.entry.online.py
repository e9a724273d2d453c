"""Host microseconds a ``knn_grouped`` call spends in its own code,
outside the ranges inside it (``rpt_knn_grouped`` self time)."""

from benchmark import spans


def read(run):
    return spans.host_us(run, "rpt_knn_grouped", ("rpt_knn_grouped",))
