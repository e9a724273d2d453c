"""The two load loops: closed (a fixed number of calls in flight) and open
(requests dispatched when due).  Every call's completion is read from a
CUDA event recorded after it, on the host's clock; on the CPU a call is
complete when it returns.

A call is ``call(j) -> (dists, ids)`` for pool batch ``j``;
``keep(j, out)`` stores what the check compares, without waiting."""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import torch

from .tracing import span


class Clock:
    """Host seconds of device events: a start event is recorded on an
    idle stream, so its time on the card is the host's time of the
    record."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            torch.cuda.synchronize(device)
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter()

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def host(self, mark) -> float:
        """The host time at which ``mark``'s work was done (after
        :meth:`wait`)."""
        if not self.cuda:
            return mark
        return self.t0 + self.ev0.elapsed_time(mark) * 1e-3


@dataclasses.dataclass
class Window:
    start: float
    end: float
    batches: list          # pool batch of each call, in dispatch order
    dispatch_s: list       # host seconds in each call
    due: list = None       # open loop: each request's due time
    late_s: list = None    # open loop: how late each call began
    done: list = None      # open loop: each request's completion time
    failed: int = 0        # calls that raised


def _call(call, keep, j, win, traced):
    t = time.perf_counter()
    try:
        with span("bench_call", traced):
            out = call(j)
    except Exception:  # a failed call is counted, and the window goes on
        win.failed += 1
        out = None
    win.dispatch_s.append(time.perf_counter() - t)
    win.batches.append(j)
    if out is not None:
        keep(j, out)


def closed(call, keep, n_batches: int, seconds: float, in_flight: int,
           device: torch.device, traced: bool = False) -> Window:
    """Keep ``in_flight`` calls outstanding for ``seconds``, then drain;
    the window ends when the last call is done."""
    clock = Clock(device)
    win = Window(clock.t0, clock.t0, [], [])
    pending = deque()
    i = 0
    while time.perf_counter() - clock.t0 < seconds:
        _call(call, keep, i % n_batches, win, traced)
        pending.append(clock.mark())
        i += 1
        if len(pending) >= in_flight:
            with span("bench_wait", traced):
                clock.wait(pending.popleft())
    last = None
    while pending:
        last = pending.popleft()
        with span("bench_wait", traced):
            clock.wait(last)
    win.end = clock.host(last) if last is not None else time.perf_counter()
    return win


def open_loop(call, keep, n_batches: int, due, device: torch.device,
              traced: bool = False) -> Window:
    """Dispatch request ``j`` (pool batch ``j mod n_batches``) at its due
    time ``due[j]`` (s from the start), or as soon after as the host can;
    each request is timed from its due time to its completion."""
    clock = Clock(device)
    start = clock.t0 + 0.01
    win = Window(start, start, [], [], due=[], late_s=[], done=[])
    marks = []
    for j, d in enumerate(due.tolist()):
        target = start + d
        with span("bench_idle", traced):
            while True:
                ahead = target - time.perf_counter()
                if ahead <= 0:
                    break
                if ahead > 2e-3:
                    time.sleep(ahead - 1e-3)
        win.late_s.append(time.perf_counter() - target)
        win.due.append(target)
        _call(call, keep, j % n_batches, win, traced)
        marks.append(clock.mark())
    with span("bench_wait", traced):
        for m in marks:
            clock.wait(m)
    win.done = [clock.host(m) for m in marks]
    win.end = max(win.done) if win.done else time.perf_counter()
    return win
