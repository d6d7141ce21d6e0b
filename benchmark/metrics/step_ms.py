"""End to end: milliseconds a fitting step, the whole window over the
steps it completed."""

from benchmark.core.stats import window_rate_ms


def read(run):
    return window_rate_ms(run.window_s, run.completed)
