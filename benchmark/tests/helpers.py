"""Tiny cells for the CPU: the real cells' files with their scale cut so
that a whole run takes seconds (widths and parameters kept)."""

import copy

from benchmark import spec

SEED = 2 ** 33 + 7  # seeds may need more than 32 bits


def tiny(name: str, cell=None):
    c = copy.deepcopy(cell or spec.cell(name))
    c.config.update(n=12000)
    c.config["data"].update(centers=30, pool=2048)
    c.config["index"].update(max_depth=9, min_leaf=32)
    c.traffic.update(batch=512, sample=384)
    if "chunk" in c.traffic.get("kwargs", {}):
        c.traffic["kwargs"]["chunk"] = 256
    if c.traffic["loop"] == "open":
        c.traffic["rate_per_s"] = 12
    return c
