"""Host microseconds a ``knn_grouped`` call spends in the selection
tail (``rpt_topk_tail`` self time)."""

from benchmark import spans


def read(run):
    return spans.host_us(run, "rpt_knn_grouped", ("rpt_topk_tail",))
