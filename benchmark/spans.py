"""The program's own spans and counters over a traced window
(``rptree_tpu_torch.profiling.stats()``).  The traced half of a run is the
latest stretch in which a profiler ran, so they hold its calls alone.  A
program without them reads None, and so does an untraced run."""

from __future__ import annotations


def stats(run) -> dict | None:
    if run.trace is None:
        return None
    from rptree_tpu_torch.utils import profiling
    read = getattr(profiling, "stats", None)
    return None if read is None else read()


def host_us(run, entry: str, names) -> float | None:
    """Host microseconds a call of ``entry`` (a serving entry's range)
    spent in the ranges ``names``, their self times summed: each range's
    time less the ranges directly inside it."""
    s = stats(run)
    if not s or entry not in s or not s[entry]["calls"]:
        return None
    return sum(s[n]["self_ns"] for n in names if n in s) / (
        s[entry]["calls"] * 1e3)


def slot_use_pct(run) -> float | None:
    """The share of the grouped layer's scored tile slots that held a
    (query, block) pair, in percent."""
    s = stats(run)
    if not s or not s.get("grouped.slots_launched"):
        return None
    return 100.0 * s["grouped.pairs"] / s["grouped.slots_launched"]
