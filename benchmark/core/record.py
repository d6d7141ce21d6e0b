"""The program's own record, for the per-layer metrics that read it: the
spans and counters of `fidget_tpu_torch.utils` (`snapshot()`: spans with
`time.time_ns()` stamps, counters by name). A program that keeps no such
record gives None, and so do the metrics."""

from __future__ import annotations

from .cell import process_start

#: the program's set-up spans (with every `fidget.kernels.*` span)
SETUP_SPANS = ("fidget.import", "fidget.lower", "fidget.renderer.init")
KERNEL_SPANS = "fidget.kernels."


def snapshot(run):
    """The program's record at the end of the window, or None."""
    read = getattr(getattr(run.cell.port, "utils", None), "snapshot", None)
    return None if read is None else read()


def setup_end_ns(run) -> int:
    """The end of set-up on the spans' clock, to the 10 ms tick of the
    process's start: the process's start plus the run's `setup_s`."""
    return int((process_start() + run.setup_s) * 1e9)


def window(snap, run, name: str) -> list:
    """The spans named `name` of the window's requests: the run's last
    `completed` (the window ends the program's requests)."""
    spans = [s for s in snap["spans"] if s.name == name]
    return spans[max(0, len(spans) - run.completed):]


def is_setup(name: str) -> bool:
    return name in SETUP_SPANS or name.startswith(KERNEL_SPANS)
