"""The grouped layer's least time (``roofline.chunk_work`` on blocks)
over its device time, in percent."""

RANGES = ("rpt_tile_tables", "rpt_grouped_score", "rpt_pair_reorder")


def read(run):
    return run.roofline_pct("grouped", RANGES)
