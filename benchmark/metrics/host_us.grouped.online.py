"""Host microseconds a ``knn_grouped`` call spends in the grouped layer
(``rpt_tile_tables``, ``rpt_grouped_score`` and ``rpt_pair_reorder`` self
time)."""

from benchmark import spans

RANGES = ("rpt_tile_tables", "rpt_grouped_score", "rpt_pair_reorder")


def read(run):
    return spans.host_us(run, "rpt_knn_grouped", RANGES)
