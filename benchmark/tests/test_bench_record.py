"""The metrics that read the program's own record (`fidget_tpu_torch.
utils`: spans and counters): each reads a value from a traced run of the
fit cell at 64^2 on the CPU, and nothing from a program that keeps no
record or an empty one."""

import types

import pytest

from benchmark.core import cell

from test_bench_cells import SEED

METRICS = ["fit_host_ms", "jacobian_kept_pct", "setup_program_s"]


@pytest.fixture(scope="module")
def traced(small_root):
    return cell.run(small_root, "standin2d.fit", SEED, 2.0, True,
                    chip_check=False, device="cpu")


@pytest.mark.parametrize("name", METRICS)
def test_reads_a_traced_cpu_run(traced, name):
    m = traced["metrics"][name]
    assert m["value"] > 0 and traced["correct"] is True
    if name == "jacobian_kept_pct":
        # two of a step's two passes of three planes reach the gradient
        assert m["value"] == pytest.approx(100 / 3)


def _run(utils):
    port = types.SimpleNamespace() if utils is None else \
        types.SimpleNamespace(utils=utils)
    return cell.Run(types.SimpleNamespace(port=port), [0.1, 0.1], 0.2, 1.0,
                    None)


EMPTY = types.SimpleNamespace(snapshot=lambda: {
    "spans": [], "totals": {}, "counters": {}, "launches": {}})


@pytest.mark.parametrize("name", METRICS)
@pytest.mark.parametrize("utils", [None, types.SimpleNamespace(), EMPTY],
                         ids=["no-utils", "no-record", "empty"])
def test_reads_nothing_without_a_record(name, utils):
    assert cell.load_metric(name).read(_run(utils)) is None
