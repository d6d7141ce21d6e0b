"""The device trace of a traced run, and what per-layer metrics read.

`Profiled` runs `torch.profiler` (CPU and CUDA activities, no shapes,
no stacks) around a stretch of requests, and keeps the raw events as
(name, start s, end s): device operations (kernels, copies, sets) and
host events (ops, runtime calls, the benchmark's own spans). `Trace`
is what a metric's reader gets.
"""

from __future__ import annotations

import bisect
import collections
import json
import os

from .stats import busy_and_gaps

#: the benchmark's span around one request (call and synchronize). The
#: profiler mirrors a span on the device's timeline; that copy is no
#: device operation.
SPAN_PREFIX = "bench."
REQUEST_SPAN = "bench.request"
#: host events of the profiler itself, which label no idle gap
PROFILER_EVENTS = ("Activity Buffer Request",)


def _events(prof):
    """([(name, start, end)] device, [(name, start, end)] host), in
    seconds on the profiler's clock."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() != DeviceType.CUDA:
            host.append((name, s, s + d))
        elif not name.startswith(SPAN_PREFIX):  # not a span's shadow
            dev.append((name, s, s + d))
    return dev, host


class Profiled:
    """Context manager: profiles the enclosed requests."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False, profile_memory=False,
        )
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.device, self.host = _events(self.prof)
        return False


class Trace:
    """A traced stretch of a run's window.

    requests: requests completed in the traced stretch; window_s: its
    length, from the first request's start to the last one's end on the
    profiler's clock; busy_s: seconds in which some operation ran on the
    device; ops: the device operations inside it; gaps: the idle
    stretches, each (start, length, what the host was doing); cell: the
    workload's entry, config and scene, for work counts."""

    def __init__(self, device, host, *, requests, cell):
        spans = [(s, e) for n, s, e in host if n == REQUEST_SPAN]
        if not spans or requests <= 0:
            raise ValueError("the traced stretch holds no request")
        t0 = min(s for s, _ in spans)
        t1 = max(e for _, e in spans)
        self.requests, self.window_s = requests, t1 - t0
        self.ops = [(n, s, e) for n, s, e in device if e > t0 and s < t1]
        self.busy_s, gaps = busy_and_gaps([(s, e) for _, s, e in self.ops],
                                          t0, t1)
        self.gaps = _label(gaps, host)
        self.cell = cell

    def device_s(self, *names) -> float:
        """Device seconds of the operations whose name holds any of
        `names` (all operations when none is given)."""
        return sum(e - s for n, s, e in self.ops
                   if not names or any(k in n for k in names))

    def launches(self, *names) -> int:
        return sum(1 for n, _, _ in self.ops if any(k in n for k in names))

    def breakdown(self, top: int = 10) -> dict:
        by_op = collections.Counter()
        for n, s, e in self.ops:
            by_op[n[:120]] += e - s
        by_gap = collections.Counter()
        for _, length, what in self.gaps:
            by_gap[what[:120]] += length
        return {"device_ops": [[n, t] for n, t in by_op.most_common(top)],
                "idle_gaps": [[n, t] for n, t in by_gap.most_common(top)]}

    def save(self, path: str):
        """Writes the device operations and gaps (a few MB) as JSON."""
        with open(path, "w") as f:
            json.dump({"window_s": self.window_s, "requests": self.requests,
                       "busy_s": self.busy_s, "ops": self.ops,
                       "gaps": self.gaps}, f)


def _label(gaps, host):
    """Each gap with the innermost host event that held its midpoint
    ("python" where none did: the interpreter between calls)."""
    events = sorted((s, e, n) for n, s, e in host
                    if n not in PROFILER_EVENTS)
    starts = [s for s, _, _ in events]
    out = []
    for at, length in gaps:
        mid = at + length / 2
        i = bisect.bisect_right(starts, mid) - 1
        what = "python"
        for j in range(i, max(-1, i - 4000), -1):
            s, e, n = events[j]
            if e >= mid:
                what = n
                break
        out.append((at, length, what))
    return out


def trace_path(workload: str, seed: int) -> str:
    """Where a traced run writes its reduced trace: under TMPDIR, or
    the checkout's `benchmark/.cache/` where TMPDIR is not set."""
    base = os.environ.get("TMPDIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".cache")
    os.makedirs(base, exist_ok=True)
    return os.path.join(base, f"bench-trace-{workload}-{seed}.json")
