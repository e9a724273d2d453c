"""Host microseconds a ``knn_batched`` call spends in the per-pair
rerank, less its nested selection tail (``rpt_rerank`` self time)."""

from benchmark import spans


def read(run):
    return spans.host_us(run, "rpt_knn_batched", ("rpt_rerank",))
