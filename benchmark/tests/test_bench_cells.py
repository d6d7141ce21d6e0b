"""The benchmark's cells on the CPU at small sizes: the result line, the
check of the sound program, the control, and each planted fault.

Each run goes through `cell.run` with the look for a card skipped and
the program's plain versions (device "cpu"): the same set-up, warm-up,
closed loop, sampling and check as a run on the card.
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

from benchmark.calibrate import readings
from benchmark.core import cell

#: the benchmark's cells
CELLS = ["standin2d.fit"]
SEED = 2**31 + 977  # wider than 32 signed bits
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct_and_line_has_the_keys(small_root, workload):
    r = cell.run(small_root, workload, SEED, 1.0, False, chip_check=False,
                 device="cpu")
    assert list(r) == KEYS  # the checks come last
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    spec = cell.Cell(small_root, workload)
    want = {m["name"] for m in spec.metrics("end_to_end")}
    assert set(r["metrics"]) == want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["device"]["platform"] == "cpu"
    for chk in r["checks"].values():
        assert chk["value"] <= chk["limit"]


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_planted_fault_is_not_correct(small_root, workload, fault):
    r = cell.run(small_root, workload, SEED + 1, 1.0, False,
                 chip_check=False, device="cpu", fault=fault)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(small_root, workload):
    c = cell.Cell(small_root, workload)
    limits = c.cfg["limits"]
    for r in readings(small_root, workload, [SEED, 3, 4], 1.0, ["control"],
                      chip_check=False, device="cpu", control_requests=8):
        assert any(v > limits[k] for k, v in r["checks"].items()), r


def test_traced_run_reports_per_layer_and_breakdown(small_root):
    r = cell.run(small_root, "standin2d.fit", SEED, 2.0, True,
                 chip_check=False, device="cpu")
    assert "breakdown" in r and list(r)[-1] == "checks"
    assert r["correct"] is True, r["checks"]
    assert r["device"]["window_s"] > 0
    # no operation runs on a card here: the idle share reads the whole
    # stretch, and the rooflines find no kernel and say nothing
    assert r["metrics"]["device_idle_pct.fit"]["value"] == 100.0
    assert not {"k4_roofline_pct", "u1_dense_roofline_pct"} & set(r["metrics"])


def test_no_card_exits_without_a_result():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "standin2d.fit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_card_run_is_correct(card, workload):
    """A short run of the cell at its full size on the card."""
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert r["device"]["kind"] == card
