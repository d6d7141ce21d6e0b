"""Interpreter kernels: the share of the Jacobian's tangent planes that
K4 evaluates (`jacobian.tangents_computed`: 3 a pass over every lane,
padding included) whose values reach the gradient
(`jacobian.tangents_kept`: the non-axis inputs at the real lanes), in %,
over the run."""

from benchmark.core import record


def read(run):
    snap = record.snapshot(run)
    if snap is None:
        return None
    c = snap["counters"]
    computed = c.get("jacobian.tangents_computed", 0)
    if not computed:
        return None
    return 100.0 * c.get("jacobian.tangents_kept", 0) / computed
