"""A traced window: ``torch.profiler`` over the host and the device, and
its reduction to layer times, busy time and idle gaps.

A device operation belongs to the innermost ``rpt_*`` range (the
program's) open on the host when it was launched: its launch is the
runtime or driver call with the same correlation id.  A range's span on
the card runs past its span on the host, so ranges are never matched by
overlap on the card.  Operations launched under no range count as
``unranged``.  Idle gaps of the device within the window are named by
the innermost range of any kind (the program's ``rpt_*`` or the
benchmark's ``bench_*``) open on the host where the gap begins.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
from collections import defaultdict

from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench_window"
UNRANGED = "unranged"
TOP = 10


def span(name: str, on: bool):
    """A host range named ``name`` while tracing, else nothing."""
    return record_function(name) if on else contextlib.nullcontext()


def profiler(cuda: bool = True):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts,
                   record_shapes=False, with_stack=False,
                   profile_memory=False)


def _short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0][:96]


@dataclasses.dataclass
class Reduced:
    window_s: float
    busy_s: float
    range_s: dict          # range name -> device seconds (innermost)
    device_ops: list       # [[range:kernel, seconds]], largest first
    idle_gaps: list        # [[host range, seconds]], largest first
    n_ops: int
    n_unlinked: int        # device operations with no launch found


def _kind(e) -> str:
    """The event's kind, as the profiler's ``activity_type`` names it (from
    the device type and the name where a build has no such method)."""
    kind = getattr(e, "activity_type", None)
    if kind is not None:
        return kind()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if e.is_user_annotation() or name.startswith(("rpt_", "bench_")):
            return "gpu_user_annotation"
        return "kernel"
    if e.is_user_annotation():
        return "user_annotation"
    if name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def reduce(events) -> Reduced:
    """Reduce the profiler's events (``kineto_results.events()``)."""
    ranges, launches, ops = [], {}, []
    for e in events:
        kind = _kind(e)
        if kind == "user_annotation":
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
        elif kind in LAUNCH_KINDS:
            launches[e.correlation_id()] = e.start_ns()
        elif kind in DEVICE_KINDS:
            ops.append((e.start_ns(), e.end_ns(), e.name(),
                        e.correlation_id()))
    ops = [(s, t, n, launches.get(c)) for s, t, n, c in ops]
    win = [r for r in ranges if r[2] == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = win[0][0], win[0][1]
    ranges = [r for r in ranges if r[2] != WINDOW and r[0] < w1 and r[1] > w0]
    ranges.sort()
    starts = [r[0] for r in ranges]

    def innermost(t, program_only):
        """The latest-starting range that holds ``t``."""
        i = bisect.bisect_right(starts, t) - 1
        best = None
        # ranges nest, so walk back while an earlier range may still hold t
        depth = 0
        while i >= 0 and depth < 256:
            s, e, name = ranges[i]
            if s <= t < e and (not program_only or name.startswith("rpt_")):
                best = name
                break
            i -= 1
            depth += 1
        return best

    range_s = defaultdict(float)
    by_op = defaultdict(float)
    unlinked = 0
    intervals = []
    for s, t, name, launch in ops:
        if launch is None:
            unlinked += 1
            owner = UNRANGED
        else:
            owner = innermost(launch, True) or UNRANGED
        sec = (t - s) * 1e-9
        range_s[owner] += sec
        by_op[f"{owner}:{_short(name)}"] += sec
        a, b = max(s, w0), min(t, w1)
        if b > a:
            intervals.append((a, b))
    intervals.sort()
    busy = 0
    gaps = defaultdict(float)
    cur = w0
    for a, b in intervals:
        if a > cur:
            gaps[innermost(cur, False) or "host"] += (a - cur) * 1e-9
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps[innermost(cur, False) or "host"] += (w1 - cur) * 1e-9

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:TOP]

    return Reduced((w1 - w0) * 1e-9, busy * 1e-9, dict(range_s),
                   top(by_op), top(gaps), len(ops), unlinked)
