"""Host microseconds a ``knn_batched`` call spends in the selection
tail (``rpt_topk_tail`` self time)."""

from benchmark import spans


def read(run):
    return spans.host_us(run, "rpt_knn_batched", ("rpt_topk_tail",))
