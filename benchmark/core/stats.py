"""The arithmetic of the end-to-end and device metrics."""

from __future__ import annotations


def window_rate_ms(window_s: float, completed: int) -> float:
    """Milliseconds a request over the whole window: all the window's
    time over all the requests it completed."""
    if completed <= 0:
        raise ValueError("no request completed in the window")
    return window_s * 1e3 / completed


def union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def busy_and_gaps(intervals, t0: float, t1: float):
    """(busy seconds, [(gap start, gap length)]) of the union of device
    intervals clipped to the window [t0, t1); the gaps are the idle
    stretches of the window, its ends included."""
    merged = union((max(s, t0), min(e, t1)) for s, e in intervals
                   if e > t0 and s < t1)
    busy = sum(e - s for s, e in merged)
    gaps, at = [], t0
    for s, e in merged:
        if s > at:
            gaps.append((at, s - at))
        at = max(at, e)
    if t1 > at:
        gaps.append((at, t1 - at))
    return busy, gaps
