"""Device microseconds per 1,000 queries of the grouped layer: kernel 9,
the query-row gather, kernel 1 and the pair reorder."""

RANGES = ("rpt_tile_tables", "rpt_grouped_score", "rpt_pair_reorder")


def read(run):
    return run.us_per_kq(RANGES)
