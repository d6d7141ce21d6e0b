"""Generated kernels: U1's share of its roofline over the dense rows of
a fitting step (`fidget_unrolled_float`), in %: a launch's least time
(H W points of the field's value, H W f32 written) over its device
time, averaged over the traced stretch's launches."""

from benchmark.core.work import flops_per_point, least_seconds

KERNEL = "fidget_unrolled_float"


def read(run):
    t = run.trace
    n = t.launches(KERNEL)
    if not n:
        return None
    c = t.cell
    W, H = c.cfg["size"]
    flops = W * H * flops_per_point(c.scene.op_counts(c.cfg["scene"]))
    return 100.0 * n * least_seconds(flops, W * H * 4) / t.device_s(KERNEL)
