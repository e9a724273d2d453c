"""Recall@10 of the served answers sampled across the window against
the exact float32 scan."""


def read(run):
    return run.recall
