"""Streaming (online) median, a copy of ``rptree_tpu/utils/median.py``
(pure Python; importing it from ``rptree_tpu`` would import JAX).

Parity with the reference's two-heap ``MedianHeap``
(``src/Data/RPTree/Internal/MedianHeap.hs``): a max-heap below / min-heap
above structure whose ``insert`` routes by comparison with the current
median and rebalances (MedianHeap.hs:30-55), with ``median`` averaging the
two heads when balanced (MedianHeap.hs:58-65).  The reference ships it but
never calls it (imported at Conduit.hs:44, unused) -- infrastructure for a
true online median split.  Here it is live: :class:`StreamingMedian` powers
threshold *estimation* over data streams too large to sort, and the exact
builder (which gets exact medians from the segmented sort) uses it only in
tests as an independent oracle.
"""

from __future__ import annotations

import heapq
from typing import Iterable

__all__ = ["StreamingMedian"]


class StreamingMedian:
    """Two-heap streaming median over floats.

    ``insert`` is O(log n); ``median`` is O(1).  Matches the reference's
    balance policy: sizes differ by at most one, median is the average of
    the two heads when balanced, otherwise the head of the larger heap.
    """

    def __init__(self, values: Iterable[float] = ()):  # noqa: D107
        self._lo: list = []  # max-heap (negated) of the lower half
        self._hi: list = []  # min-heap of the upper half
        for v in values:
            self.insert(v)

    def __len__(self) -> int:
        return len(self._lo) + len(self._hi)

    def insert(self, v: float) -> "StreamingMedian":
        """Route by comparison with the current median, then rebalance
        (MedianHeap.hs:30-55)."""
        if not self._lo or v <= -self._lo[0]:
            heapq.heappush(self._lo, -v)
        else:
            heapq.heappush(self._hi, v)
        if len(self._lo) > len(self._hi) + 1:
            heapq.heappush(self._hi, -heapq.heappop(self._lo))
        elif len(self._hi) > len(self._lo) + 1:
            heapq.heappush(self._lo, -heapq.heappop(self._hi))
        return self

    def median(self) -> float:
        """Average of the heads when balanced; the larger heap's head
        otherwise (MedianHeap.hs:58-65).  Raises on empty."""
        if not self._lo and not self._hi:
            raise ValueError("median of empty stream")
        if len(self._lo) == len(self._hi):
            return (-self._lo[0] + self._hi[0]) / 2.0
        return -self._lo[0] if len(self._lo) > len(self._hi) else self._hi[0]
