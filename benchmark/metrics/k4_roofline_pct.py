"""Interpreter kernels: K4's share of its roofline over a fitting step
(`interp_grad`), in %: the least time of the value and its partials in
all of the tape's inputs at H W points (counted once a step, however
many passes compute them; each output written once) over K4's device
time a step."""

from benchmark.core.work import flops_per_point, least_seconds

KERNEL = "interp_grad_kernel"
#: the tape's inputs: x, y, shift, grow
PARTIALS = 4


def read(run):
    t = run.trace
    if not t.launches(KERNEL):
        return None
    c = t.cell
    W, H = c.cfg["size"]
    counts = c.scene.op_counts(c.cfg["scene"])
    flops = W * H * flops_per_point(counts, PARTIALS)
    least = least_seconds(flops, W * H * 4 * (1 + PARTIALS))
    return 100.0 * t.requests * least / t.device_s(KERNEL)
