"""The readings that a cell's limits are set from, in one process on the
card(s) of this machine:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 3 --mode sound --mode control --mode fault:stale

Each mode runs the cell's traffic for every seed, through the same
set-up, warm-up, closed loop and check as a run of `run.py`, with a
short window, and prints one JSON line of the compared numbers a seed:

- sound: the program as the benchmark runs it (the lower readings);
- control: the reference in bfloat16 in the program's place, the same
  requests, as many outputs checked (the upper readings);
- fault:<name>: the program with one of its entry's `FAULTS` planted
  (stale: a step returns its parameters unchanged; half: half of the
  loss's rows left out, the mean taken over the rest; altered: one
  pixel's distance altered where it is produced).

The benchmark's own runs never run a control or a fault.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(root, workload, seeds, seconds, modes, *, chip_check=True,
             device=None, control_requests=24):
    """Yields {"mode", "seed", "attempted", "checks"} for each mode and
    seed."""
    from benchmark.core import cell

    c = cell.Cell(root, workload)
    cell.setup(c, seeds[0], device=device, chip_check=chip_check)
    for mode in modes:
        for seed in seeds:
            cell.start_program(c, seed)
            if mode == "control":
                def call(prog, req, c=c):
                    return c.entry.control(c, req)
                kw = {"requests": control_requests}
            elif mode == "sound":
                call, kw = c.entry.call, {"seconds": seconds}
            elif mode.startswith("fault:"):
                call = c.entry.FAULTS[mode.split(":", 1)[1]](c.entry.call)
                kw = {"seconds": seconds}
            else:
                raise ValueError(f"unknown mode {mode!r}")
            t = time.perf_counter()
            prev, checked = cell.warm(c, call)
            lat, _, samples, failed, _ = cell.closed_loop(
                c, call, prev=prev, seed=seed, **kw)
            checks = c.entry.check(c, checked + samples)
            yield {"mode": mode, "seed": seed, "attempted": len(lat) + failed,
                   "failed": failed, "checks": checks,
                   "seconds": time.perf_counter() - t}
    cell.free_program(c)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--mode", action="append", required=True)
    args = ap.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "benchmark" / ".cache" / "nv")
    sys.path.insert(0, str(ROOT))
    seeds = [int(s) for s in args.seeds.split(",")]
    worst = {}
    for r in readings(ROOT, args.workload, seeds, args.seconds, args.mode):
        print(json.dumps(r), flush=True)
        for k, v in r["checks"].items():
            lo, hi = worst.get((r["mode"], k), (v, v))
            worst[(r["mode"], k)] = (min(lo, v), max(hi, v))
    for (mode, k), (lo, hi) in sorted(worst.items()):
        print(f"{args.workload} {mode} {k}: least {lo!r} largest {hi!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
