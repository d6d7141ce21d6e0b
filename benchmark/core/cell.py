"""One cell of the benchmark: load it by name, set the program up, run
the closed loop, check the sampled outputs against the reference, and
form the result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is found by name:

- `BENCHMARK.json` (the repository's root): the cell's configuration,
  traffic mix and chips, and the metrics with their units;
- `benchmark/configs/<config>.json`: the scene, its size, the entry
  and its options for each kind of mix, the limits of the check;
- `benchmark/scenes/<scene kind>.py`: the scene's frozen draws, and its
  graph in the program's API;
- `benchmark/reference/<config>.py`: the plain reference;
- `benchmark/entries/<entry kind>.py`: how a request calls the program,
  what of its output the check keeps, the check, the control, faults;
- `benchmark/traffic/<traffic>.json`: the mix, read by `traffic.py`;
- `benchmark/metrics/<metric>.py`: a reader of one metric.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

from . import traffic as traffic_mod
from .trace import REQUEST_SPAN, Profiled, Trace, trace_path

BENCH = pathlib.Path(__file__).resolve().parent.parent
#: seconds at the end of a traced run's window that run under the
#: profiler
TRACE_SECONDS = 4.0
#: modules that may not be loaded in the process that prints a result
#: (top-level names, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "fidget_tpu")


class NoChip(RuntimeError):
    pass


def process_start() -> float:
    """The process's start on the `time.time()` clock (10 ms ticks)."""
    import os

    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def load_spec(root: pathlib.Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_metric(name: str):
    """The reader module of a metric, `benchmark/metrics/<name>.py`."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(msg: str):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class Cell:
    """A workload of BENCHMARK.json with what it names loaded."""

    def __init__(self, root: pathlib.Path, workload: str, spec=None):
        self.spec = spec if spec is not None else load_spec(root)
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = by_name[workload]
        self.name = workload
        cfg_entry = {c["name"]: c for c in self.spec["configs"]}[
            self.workload["config"]]
        self.cfg = json.loads((root / cfg_entry["file"]).read_text())
        self.mix = json.loads(
            (BENCH / "traffic" / f"{self.workload['traffic']}.json")
            .read_text())
        self.scene = importlib.import_module(
            f"benchmark.scenes.{self.cfg['scene']['kind']}")
        #: the configuration's entry for this mix's kind
        self.entry_cfg = self.cfg["entries"][self.mix["kind"]]
        self.entry = importlib.import_module(
            f"benchmark.entries.{self.entry_cfg['kind']}")
        self.reference = importlib.import_module(
            f"benchmark.reference.{self.workload['config']}")

    def metrics(self, kind: str) -> list:
        """The `end_to_end` or `per_layer` metrics this cell reports."""
        out = []
        e2e = {m["name"]: m for m in self.spec["end_to_end"]}
        for m in self.spec[kind]:
            cells = m.get("workloads")
            if cells is None and kind == "per_layer":
                mv = e2e[m["moves"]]
                cells = mv.get("workloads")
            if cells is None or self.name in cells:
                out.append(m)
        return out


class Run:
    """What one run measured, for the metrics' readers."""

    def __init__(self, cell, latencies, window_s, setup_s, trace):
        self.cell, self.latencies, self.window_s = cell, latencies, window_s
        self.completed, self.setup_s, self.trace = (len(latencies), setup_s,
                                                    trace)


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(c, call, *, seconds=None, requests=None, trace=False,
                prev=None, seed=0):
    """One client's closed loop: a request, the program's call, a
    synchronize, the next request. Runs for `seconds` (the last request
    started before they ran out finishes) or `requests` requests.
    Returns (latencies, window seconds, samples, failed, traced or
    None), `samples` a seeded uniform sample (reservoir) of
    `c.entry.SAMPLES` (request, kept output) pairs, `traced` (device
    events, host events, requests traced, latencies before the trace).
    `prev` is the output the first request follows (a descent's)."""
    from torch.profiler import record_function

    rng = np.random.default_rng([seed, 1])
    k = c.entry.SAMPLES
    lat, samples = [], []
    failed = 0
    prof = None
    t0 = time.perf_counter()
    t_end = None if seconds is None else t0 + seconds
    t_trace = None
    if trace:
        t_trace = t0 + max(0.0, seconds - min(TRACE_SECONDS, seconds / 2))
    t_last = t0
    while True:
        now = time.perf_counter()
        if trace and prof is None and now >= t_trace:
            n_untraced = len(lat)
            prof = Profiled().__enter__()
            # the profiler takes seconds to start: the traced stretch
            # runs its full length after it has
            t_end = time.perf_counter() + (t_end - t_trace)
            now = time.perf_counter()
        if (t_end is not None and now >= t_end) or (
                requests is not None and len(lat) + failed >= requests):
            break
        req = c.gen.next(prev)
        span = (record_function(REQUEST_SPAN) if prof is not None
                else contextlib.nullcontext())
        with span:
            ta = time.perf_counter()
            try:
                out = call(c.prog, req)
                _sync(c.device)
            except RuntimeError as e:
                failed += 1
                log(f"request {req.get('n')} failed: {e}")
                continue
            tc = time.perf_counter()
        lat.append(tc - ta)
        t_last = tc
        prev = out
        i = len(lat) - 1
        j = i if i < k else int(rng.integers(i + 1))
        if j < k:
            samples[j:j + 1] = [(req, c.entry.keep(out))]
            _sync(c.device)
    traced = None
    if prof is not None:
        prof.__exit__(None, None, None)
        traced = (prof.device, prof.host, len(lat) - n_untraced,
                  lat[:n_untraced])
    return lat, t_last - t0, samples, failed, traced


def forbidden_modules() -> list:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def setup(c, seed: int, *, device=None, chip_check=True):
    """Imports, the CUDA context, the scene's lowering and the program's
    set-up for `seed`; logs each part's seconds."""
    t = time.perf_counter()
    import torch

    if chip_check:
        need = int(c.workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise NoChip(f"the cell needs {need} CUDA card(s); found "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    c.device = torch.device(device or ("cuda:0" if chip_check else "cpu"))
    if c.device.type == "cuda":
        torch.cuda.set_device(c.device)
        torch.empty(1, device=c.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import fidget_tpu_torch as port

    c.port = port
    log(f"set-up: imports and CUDA context {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    c.tape, c.vars = c.scene.build(port, c.cfg["scene"])
    log(f"set-up: scene lowered to {len(c.tape)} ops, {c.tape.reg_count} "
        f"registers {time.perf_counter() - t:.3f} s")
    start_program(c, seed)


def start_program(c, seed: int):
    """The traffic of `seed` and the program set up for it."""
    c.seed = seed
    c.gen = traffic_mod.make(c.mix, seed)
    t = time.perf_counter()
    c.prog = c.entry.setup(c)
    _sync(c.device)
    log(f"set-up: program {time.perf_counter() - t:.3f} s")


def warm(c, call):
    """The mix's warm-up requests through the same call; returns the
    last output and the (request, kept output) pairs of those the entry
    checks. The first call loads or builds the kernels."""
    n = int(c.mix.get("warm", 3))
    prev, checked = None, []
    for i in range(n):
        t = time.perf_counter()
        req = c.gen.next(prev)
        prev = call(c.prog, req)
        _sync(c.device)
        if i < getattr(c.entry, "WARM_CHECKED", 0):
            checked.append((req, c.entry.keep(prev)))
        what = "first call (kernels built or loaded)" if i == 0 else \
            f"warm request {i}"
        log(f"set-up: {what} {time.perf_counter() - t:.3f} s")
    return prev, checked


def free_program(c):
    import torch

    teardown = getattr(c.entry, "teardown", None)
    if teardown is not None:
        teardown(c.prog)
    c.prog = None
    gc.collect()
    if c.device.type == "cuda":
        torch.cuda.empty_cache()


def judge(c, checks: dict, failed: int) -> bool:
    limits = c.cfg["limits"]
    ok = failed == 0
    for name, value in checks.items():
        ok = ok and np.isfinite(value) and value <= limits[name]
    return bool(ok)


def run(root: pathlib.Path, workload: str, seed: int, seconds: float,
        trace: bool, *, chip_check=True, device=None, fault=None) -> dict:
    """One run of a cell: the result line's object."""
    t_proc = process_start()
    c = Cell(root, workload)
    setup(c, seed, device=device, chip_check=chip_check)
    call = c.entry.call
    if fault is not None:
        call = c.entry.FAULTS[fault](call)
    prev, checked = warm(c, call)
    setup_s = time.time() - t_proc
    log(f"set-up: {setup_s:.3f} s from the process's start")
    lat, window_s, samples, failed, traced = closed_loop(
        c, call, seconds=seconds, trace=trace, prev=prev, seed=seed)
    import torch

    peak = (torch.cuda.max_memory_allocated(c.device)
            if c.device.type == "cuda" else 0)
    log(f"window: {len(lat)} requests in {window_s:.3f} s, {failed} failed")
    if lat:
        med = float(np.median(lat))
        slow = [x for x in lat if x > 3 * med]
        log(f"window: latency ms median {med * 1e3:.3f}, p95 "
            f"{np.percentile(lat, 95) * 1e3:.3f}, max {max(lat) * 1e3:.3f}; "
            f"{len(slow)} over 3x the median, {sum(slow):.3f} s in all")
    tr = None
    if traced is not None:
        dev_ev, host_ev, n_traced, untraced = traced
        tr = Trace(dev_ev, host_ev, requests=n_traced, cell=c)
        tr.save(trace_path(c.name, seed))
        # the profiler's cost: a request's time in the traced stretch
        # against the window's part before it
        log(f"trace: {n_traced} requests, {tr.window_s / n_traced * 1e3:.3f}"
            f" ms each under the profiler against "
            f"{float(np.mean(untraced)) * 1e3 if untraced else float('nan'):.3f}"
            f" before it; device busy {tr.busy_s / tr.window_s * 100:.2f}%")
    r = Run(c, lat, window_s, setup_s, tr)
    metrics = {}
    for m in c.metrics("per_layer" if trace else "end_to_end"):
        value = load_metric(m["name"]).read(r)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    free_program(c)
    t = time.perf_counter()
    checks = c.entry.check(c, checked + samples)
    log(f"check: {len(checked) + len(samples)} outputs against the "
        f"reference {time.perf_counter() - t:.3f} s")
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"forbidden modules loaded: {bad}")
    device_info = {
        "platform": "gpu" if c.device.type == "cuda" else "cpu",
        "kind": (torch.cuda.get_device_name(c.device)
                 if c.device.type == "cuda" else "cpu"),
        "count": int(c.workload["chips"]),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": judge(c, checks, failed),
              "attempted": len(lat) + failed, "failed": failed,
              "metrics": metrics, "device": device_info}
    if r.trace is not None:
        device_info["busy_s"] = r.trace.busy_s
        device_info["window_s"] = r.trace.window_s
        result["breakdown"] = r.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": c.cfg["limits"][k]}
                        for k, v in checks.items()}
    return result
