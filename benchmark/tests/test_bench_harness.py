"""The harness on the CPU: discovery by name, the traffic generator, the
metric arithmetic and the import rules."""

import ast
import json
import math
import pathlib
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, small_spec

from benchmark.core import stats, traffic
from benchmark.core.trace import Trace

BENCH = ROOT / "benchmark"


# ----------------------------------------------------------------------
# discovery: a new configuration, mix and metric are files, not edits

DUMMY_RUN = """
import json, pathlib, sys
root = pathlib.Path(sys.argv[1])
sys.path.insert(0, str(root))
from benchmark.core import cell
for trace in (False, True):
    r = cell.run(root, "dummy2d.nudge", 5, 1.0, trace, chip_check=False,
                 device="cpu")
    print(json.dumps(r))
"""


def test_harness_runs_added_files_without_an_edit(tmp_path):
    """A dummy configuration (its file and its reference), traffic mix
    and metric of each kind, added as files to a copy of the benchmark,
    run without any edit of a file already there."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copytree(ROOT / "fidget_tpu_torch", copy / "fidget_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    small_spec(copy)
    spec = json.loads((copy / "BENCHMARK.json").read_text())
    cfg = {"scene": {"kind": "circles2d", "n": 30, "seed": 3,
                     "vars": {"shift": 0.0, "grow": 0.0}},
           "size": [32, 32],
           "entries": {"descent": {"kind": "fit", "options": {"lr": 0.5}}},
           "limits": {"loss_gap": 1e-5, "step_gap": 5e-5}}
    (copy / "benchmark/configs/dummy2d.json").write_text(json.dumps(cfg))
    (copy / "benchmark/reference/dummy2d.py").write_text(
        "from .standin2d import Reference  # noqa: F401\n")
    mix = {"kind": "descent", "restart_every": 4, "warm": 1,
           "true": {"shift": [-0.05, 0.05], "grow": [-0.02, 0.02]},
           "start": {"shift": [-0.05, 0.05], "grow": [-0.02, 0.02]}}
    (copy / "benchmark/traffic/nudge.json").write_text(json.dumps(mix))
    (copy / "benchmark/metrics/dummy_requests.py").write_text(
        "def read(run):\n    return run.completed\n")
    (copy / "benchmark/metrics/dummy_window_s.py").write_text(
        "def read(run):\n    return run.trace.window_s\n")
    spec["configs"].append({"name": "dummy2d", "source": "a test",
                            "file": "benchmark/configs/dummy2d.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy2d.nudge", "config": "dummy2d",
                              "traffic": "nudge", "chips": 1, "why": "t"})
    spec["end_to_end"].append({"name": "dummy_requests", "unit": "req",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": ["dummy2d.nudge"]})
    spec["per_layer"].append({"name": "dummy_window_s", "unit": "s",
                              "better": "lower", "source": "device_trace",
                              "layer": "test", "moves": "dummy_requests",
                              "workloads": ["dummy2d.nudge"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))
    p = subprocess.run([sys.executable, "-c", DUMMY_RUN, str(copy)],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    plain, traced = (json.loads(x) for x in p.stdout.strip().splitlines())
    assert plain["correct"] is True, plain["checks"]
    assert set(plain["metrics"]) == {"dummy_requests", "setup_s"}
    assert plain["metrics"]["dummy_requests"]["value"] == plain["attempted"]
    assert set(traced["metrics"]) == {"dummy_window_s"}


# ----------------------------------------------------------------------
# traffic

def test_descent_is_the_same_for_a_seed():
    mix = json.loads((BENCH / "traffic" / "fit.json").read_text())

    def requests(seed):
        d = traffic.make(mix, seed)
        out = [d.next()]
        for _ in range(2 * mix["restart_every"]):
            out.append(d.next({"params": out[-1]["params"]}))
        return d.truth, out

    big = 2**31 + 5  # wider than 32 signed bits
    assert requests(big) == requests(big)
    assert requests(big) != requests(big + 1)


def test_descent_restarts_and_follows_the_program():
    mix = json.loads((BENCH / "traffic" / "fit.json").read_text())
    d = traffic.make(mix, 2**31 + 9)
    for p, (lo, hi) in mix["true"].items():
        assert lo <= d.truth[p] <= hi
    req = d.next()
    for k in range(1, 2 * mix["restart_every"]):
        out = {"params": {p: v + 1.0 for p, v in req["params"].items()}}
        nxt = d.next(out)
        if k % mix["restart_every"]:
            assert nxt["params"] == out["params"]
        else:
            assert nxt["params"] != out["params"]
        req = nxt


# ----------------------------------------------------------------------
# metric arithmetic

def test_window_rate_takes_all_the_window():
    assert stats.window_rate_ms(20.0, 1000) == pytest.approx(20.0)
    with pytest.raises(ValueError):
        stats.window_rate_ms(20.0, 0)


def test_idle_share_from_intervals_with_a_planted_stall():
    # ten 1 ms kernels, back to back but for a 5 ms stall after the 4th
    ops, t = [], 0.0
    for k in range(10):
        ops.append((f"k{k}", t, t + 1e-3))
        t += 1e-3 + (5e-3 if k == 3 else 0.0)
    host = [("bench.request", 0.0, t), ("aten::nonzero", 4.2e-3, 8.8e-3)]
    tr = Trace(ops, host, requests=1, cell=None)
    assert tr.window_s == pytest.approx(15e-3)
    assert tr.busy_s == pytest.approx(10e-3)
    assert 100 * (1 - tr.busy_s / tr.window_s) == pytest.approx(100 / 3)
    (what, length), = tr.breakdown()["idle_gaps"]
    assert what == "aten::nonzero" and length == pytest.approx(5e-3)
    # overlapping intervals count once
    busy, gaps = stats.busy_and_gaps([(0, 2), (1, 3), (5, 6)], 0, 10)
    assert busy == 4 and gaps == [(3, 2), (6, 4)]


def test_rooflines_stay_below_the_peak():
    from benchmark.core import work
    from benchmark.scenes import circles2d

    counts = circles2d.op_counts({"n": 800, "seed": 0})
    assert work.flops_per_point(counts) == 7202  # the tape's ops, bar I/O
    # value and four partials cost more than the value, less than 5x it
    assert 7202 < work.flops_per_point(counts, 4) < 5 * 7202
    t = work.least_seconds(2048 * 2048 * 7202, 2048 * 2048 * 4)
    assert t == pytest.approx(2048 * 2048 * 7202 / 67e12)
    assert not math.isnan(t)


# ----------------------------------------------------------------------
# imports

FORBIDDEN = {"jax", "jaxlib", "flax", "fidget_tpu"}


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package_import(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN
    if path.parent.name == "reference":
        assert "fidget_tpu_torch" not in tops


def test_a_run_loads_no_jax(small_root):
    code = ("import sys, pathlib; sys.path.insert(0, sys.argv[1]);"
            "from benchmark.core import cell;"
            "cell.run(pathlib.Path(sys.argv[2]), 'standin2d.fit', 3, 0.5,"
            " False, chip_check=False, device='cpu');"
            "print(cell.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code, str(ROOT),
                        str(small_root)], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
