"""Fixtures of the benchmark's own tests: a copy of the benchmark's
specification whose configurations are cut to a size the CPU runs in
seconds (64^2), and the `cuda` marker for the tests that need a card
(they decide inside the test, and skip without one)."""

import json
import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

#: the small size of a 2D configuration
SMALL = [64, 64]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")


def small_spec(dest: pathlib.Path) -> pathlib.Path:
    """Writes BENCHMARK.json and small copies of its configurations
    under `dest`; returns `dest`, a root for `cell.run`."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["size"] = SMALL
        path = dest / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture(scope="session")
def small_root(tmp_path_factory):
    return small_spec(tmp_path_factory.mktemp("small"))


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.cuda.get_device_name(0)
