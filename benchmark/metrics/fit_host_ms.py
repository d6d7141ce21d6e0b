"""Fitting step: the host's own milliseconds in a `fit_step`, the
request span `fidget.fit_step` less its descendants that wait for the
card (`fidget.fit.wait`, the host reads) or set up
(`fidget.renderer.init`, `fidget.kernels.*`), each counted once; the
median over the window's steps that ran with the profiler off."""

import collections
import statistics

from benchmark.core import record

#: descendants that are not the step's own host work
EXCLUDED = ("fidget.fit.wait", "fidget.renderer.init")


def _excluded(name: str) -> bool:
    return name in EXCLUDED or name.startswith(record.KERNEL_SPANS)


def read(run):
    snap = record.snapshot(run)
    if snap is None:
        return None
    children = collections.defaultdict(list)
    for s in snap["spans"]:
        children[s.parent].append(s)

    def excluded_ns(s):
        return sum(k.end_ns - k.start_ns if _excluded(k.name)
                   else excluded_ns(k) for k in children[s.id])

    host = [(s.end_ns - s.start_ns - excluded_ns(s)) * 1e-6
            for s in record.window(snap, run, "fidget.fit_step")
            if not s.profiled]
    return statistics.median(host) if host else None
