"""Utilities: profiling, tracing, and pipeline statistics.

The reference's only observability is GPU timestamp queries and the
tape interpreter's executed-op counter (fidget-wgpu/src/voxel/mod.rs:
2599-2617, shaders/tape_interpreter.wgsl:27-31). The equivalents here:
`trace` wraps `torch.profiler` and writes a Chrome trace (the card's
kernels included when there is one), `timed` measures wall-clock around
blocking device work, and `pipeline_stats` reports per-frame culling
and tape-length statistics — the op-counter analog for sizing
interpreter work.
"""

from __future__ import annotations

import contextlib
import pathlib
import time
from dataclasses import dataclass

import numpy as np


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
    """Wall-clock timer; blocks on nothing itself — wrap blocking code."""
    t0 = time.perf_counter()
    result = {}
    try:
        yield result
    finally:
        result["seconds"] = time.perf_counter() - t0
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
