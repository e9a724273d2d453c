"""The (query, block) pairs one block staging of kernel 1 serves:
``grouped.pairs`` over ``grouped.block_reads``.  A program that does not
count its stagings reads None."""

from benchmark import spans


def read(run):
    s = spans.stats(run)
    if not s or not s.get("grouped.block_reads"):
        return None
    return s["grouped.pairs"] / s["grouped.block_reads"]
