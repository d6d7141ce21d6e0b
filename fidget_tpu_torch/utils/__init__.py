"""Utilities: profiling, tracing, and pipeline statistics.

The reference's only observability is GPU timestamp queries and the
tape interpreter's executed-op counter (fidget-wgpu/src/voxel/mod.rs:
2599-2617, shaders/tape_interpreter.wgsl:27-31). The equivalents here:

- `span` and `count` record the program's own spans and counters, always
  on: a span's name, start and end on the `time.time_ns()` clock, the
  span that opened it and the request it serves, in a ring of the most
  recent `RING` spans, with each name's count and total time kept
  besides; `snapshot` reads them (and `cuda.LAUNCHES`), `reset` clears
  them. While `torch.profiler` runs, each span is also a host event of
  the same name in its trace, on the same clock;
- `trace` wraps `torch.profiler` and writes a Chrome trace (the card's
  kernels included when there is one);
- `timed` times host work as a span;
- `pipeline_stats` reports per-frame culling and tape-length
  statistics, the op-counter analog for sizing interpreter work.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import pathlib
import sys
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

#: the spans the recorder keeps: the most recent ones
RING = 65536
#: tensor counts a counter holds before they are summed on their device
PENDING = 1024


class Span(NamedTuple):
    """A recorded span. `start_ns` and `end_ns` are `time.time_ns()`
    stamps, the scale of the profiler's events; `parent` is the id of
    the span that opened it (0: none, in its thread), `request` the id
    of the request span it serves (0: none); `profiled` says whether
    `torch.profiler` was on when it opened."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    request: int
    profiled: bool


def _profiling() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _Open:
    """One use of a span: a context manager, or a decorator that opens a
    span of the same name around each call."""

    __slots__ = ("rec", "name", "request", "start_ns", "end_ns", "_ids",
                 "_prof")

    def __init__(self, rec, name, request):
        self.rec, self.name, self.request = rec, name, request

    def __enter__(self):
        stack = self.rec._stack()
        sid = next(self.rec._ids)
        parent, req = stack[-1] if stack else (0, 0)
        if self.request and not req:
            req = sid
        stack.append((sid, req))
        self._ids = (sid, parent, req)
        self._prof = None
        self.start_ns = time.time_ns()
        if _profiling():
            # a FUNCTION-scope record (a user range would be mirrored on
            # the device's timeline as if it were an operation there)
            from torch._C._profiler import _RecordFunctionFast

            self._prof = _RecordFunctionFast(self.name)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        self.end_ns = time.time_ns()
        rec = self.rec
        rec._stack().pop()
        rec._record((self.name, self.start_ns, self.end_ns, *self._ids,
                     self._prof is not None))
        return False

    def __call__(self, fn):
        rec, name, request = self.rec, self.name, self.request

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with _Open(rec, name, request):
                return fn(*args, **kwargs)

        return spanned


class Recorder:
    """The spans and counters of a process (`RECORDER`; the module's
    `span`, `count`, `snapshot` and `reset` are its methods)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.reset()

    def reset(self) -> None:
        """Clears the spans, the totals, the counters and the launch
        counts."""
        with self._lock:
            self._spans = collections.deque(maxlen=RING)
            self._totals = {}
            self._counters = {}
            self._pending = {}
        if "fidget_tpu_torch.eval.cuda" in sys.modules:
            sys.modules["fidget_tpu_torch.eval.cuda"].reset_launches()

    def _stack(self) -> list:
        """This thread's open spans, (id, request) each."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _record(self, s: tuple) -> None:
        """Keeps a closed span, the fields of a `Span`."""
        name, ns = s[0], s[2] - s[1]
        with self._lock:
            self._spans.append(s)
            total = self._totals.get(name)
            if total is None:
                self._totals[name] = [1, ns]
            else:
                total[0] += 1
                total[1] += ns

    def span(self, name: str, *, request: bool = False) -> _Open:
        """A span named `name`: `with span(name):` or `@span(name)`.
        `request` marks a top-level entry call: it and every span inside
        it carry its id (a request inside another keeps the outer id)."""
        return _Open(self, name, request)

    def count(self, name: str, n=1, *, per: int = 1) -> None:
        """Adds `n` times `per` to counter `name`. `n` may be a tensor:
        the sum of its elements is then read when the counters are
        (`snapshot`), so counting waits for no device work, and the
        tensor must not change afterwards. A tensor inside a `torch.func`
        transform is not counted."""
        if isinstance(n, int):
            with self._lock:
                self._counters[name] = self._counters.get(name, 0) + n * per
            return
        import torch

        if torch._C._functorch.is_functorch_wrapped_tensor(n):
            return
        with self._lock:
            pending = self._pending.setdefault(name, [])
            pending.append((n.detach(), per))
            if len(pending) > PENDING:
                self._pending[name] = _fold(pending)

    def snapshot(self) -> dict:
        """{"spans": [Span] oldest first, "totals": {name: (count,
        total ns)} of every span since `reset`, "counters": {name: int},
        "launches": `cuda.LAUNCHES` itself}. Reading tensor counts waits
        for the work that produces them."""
        with self._lock:
            pending, self._pending = self._pending, {}
        read = {k: sum(int(t.sum()) * per for t, per in v)
                for k, v in pending.items()}
        with self._lock:
            for k, v in read.items():
                self._counters[k] = self._counters.get(k, 0) + v
            out = {"spans": list(map(Span._make, self._spans)),
                   "totals": {k: tuple(v) for k, v in self._totals.items()},
                   "counters": dict(self._counters)}
        from ..eval import cuda

        out["launches"] = cuda.LAUNCHES
        return out


def _fold(pending: list) -> list:
    """Tensor counts summed on their devices: one (tensor, 1) a device."""
    import torch

    by_device = {}
    for t, per in pending:
        by_device.setdefault(t.device, []).append(t.sum() * per)
    return [(torch.stack(v).sum(), 1) for v in by_device.values()]


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
snapshot = RECORDER.snapshot
reset = RECORDER.reset


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the enclosed block with `torch.profiler` (host ops, and
    the card's kernels when there is a card) and writes the timeline to
    `log_dir/trace.json` (chrome://tracing, Perfetto). Yields the
    profiler, whose `key_averages()` sums time by op."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def timed(label: str = "", sink=None):
    """Times the enclosed host work as a span named `label`; yields a
    dict that receives "seconds" and "label" when the block ends (and
    is passed to `sink`). Device work is timed only where the block
    waits for it: a launch returns before its kernel ends."""
    result = {}
    s = span(label)
    try:
        with s:
            yield result
    finally:
        result["seconds"] = (s.end_ns - s.start_ns) * 1e-9
        result["label"] = label
        if sink is not None:
            sink(result)


@dataclass
class PipelineStats:
    """Per-frame work statistics for a 2D MPR frame."""

    n_root: int
    root_active: int
    root_inside: int
    root_outside: int
    simplified_mean: float
    simplified_max: int
    interp_steps: int  # sum of executed leaf tape lengths x lane blocks

    def __str__(self) -> str:
        return (
            f"roots {self.root_active}/{self.n_root} active "
            f"({self.root_inside} in / {self.root_outside} out), "
            f"tape len mean {self.simplified_mean:.0f} "
            f"max {self.simplified_max}, "
            f"~{self.interp_steps/1e3:.0f}k leaf steps"
        )


def pipeline_stats(
    renderer, world_to_model=None, *, z: float = 0.0, vars=None
) -> PipelineStats:
    """Runs the root interval pass (K1) and the per-tile simplification
    (K2 and the rebuild of child tapes) of a PixelRenderer's frame and
    reports culling/tape statistics (the executed-op counter analog,
    tape_interpreter.wgsl:27-31).

    A tile's simplified tape keeps at least its OUTPUT row, and the
    frame zeroes the length of every tile the root pass proved, so the
    active tiles are those of non-zero length."""
    r = renderer
    mat = r._mat4(world_to_model)
    vec = r._var_vec(vars)
    rlo, _ = r._frame(mat, z, vec, stop_after="root")
    lens, _ = r._frame(mat, z, vec, stop_after="simplify")
    if lens is None:
        raise ValueError("pipeline_stats needs a binding that builds "
                         "child tapes (not the coded leaf)")
    lens = lens.cpu().numpy()
    outside = rlo.cpu().numpy() > 0
    active = lens > 0
    inside = ~(active | outside)
    act_lens = lens[active] if active.any() else np.zeros(1)
    return PipelineStats(
        n_root=int(r.n0),
        root_active=int(active.sum()),
        root_inside=int(inside.sum()),
        root_outside=int(outside.sum()),
        simplified_mean=float(act_lens.mean()),
        simplified_max=int(act_lens.max()),
        interp_steps=int(act_lens.sum()) * r.s0l,
    )
