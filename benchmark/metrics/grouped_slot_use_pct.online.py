"""The share of kernel 1's scored tile slots that hold a (query, block)
pair: ``grouped.pairs`` over ``grouped.slots_launched``, in percent."""

from benchmark import spans


def read(run):
    return spans.slot_use_pct(run)
