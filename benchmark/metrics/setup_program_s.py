"""The program's set-up: the seconds of set-up that the program's own
spans cover (its import, the lowering, the renderers' set-up, and the
kernels' emission, builds and loads: `fidget.import`, `fidget.lower`,
`fidget.renderer.init`, `fidget.kernels.*`), the union of those that
start before the first timed request, nested spans counted once."""

from benchmark.core import record
from benchmark.core.stats import union


def read(run):
    snap = record.snapshot(run)
    if snap is None:
        return None
    cut = record.setup_end_ns(run)
    spans = [(s.start_ns, s.end_ns) for s in snap["spans"]
             if s.start_ns < cut and record.is_setup(s.name)]
    if not spans:
        return None
    return sum(e - s for s, e in union(spans)) * 1e-9
