"""Host microseconds a ``knn_batched`` call spends in its own code,
outside the ranges inside it (``rpt_knn_batched`` self time)."""

from benchmark import spans


def read(run):
    return spans.host_us(run, "rpt_knn_batched", ("rpt_knn_batched",))
