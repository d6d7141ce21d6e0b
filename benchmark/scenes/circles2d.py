"""A seeded 2D field of circles: the stand-in for fidget's `prospero.vm`.

`draws` makes the circles (centres in [-1, 1]^2, radii 0.01-0.06, every
third clipped to a horizontal band) with the same generator calls as the
port's `scenes.standin_shape`, frozen here so that the benchmark's scene
never changes under it. The field, with the shape parameters `shift`
(every circle moves along x) and `grow` (the field is offset by -grow):

    d(x, y) = min_i f_i(x - shift, y) - grow
    f_i(u, y) = sqrt((u - cx_i)^2 + (y - cy_i)^2) - r_i
                (max'd with |y - cy_i| - r_i / 2 for i % 3 == 0)

`build` writes that field into a graph of the program under test
(its `Context`), reduced by a balanced tree of `min`s; `op_counts` gives
the operations the field needs a point, for the rooflines.
"""

from __future__ import annotations

import numpy as np

#: the shape parameters, in the order the benchmark passes them
PARAMS = ("shift", "grow")


def draws(scene: dict) -> dict:
    """{"centres": f64 [n, 2], "radii": f64 [n], "clipped": bool [n]}."""
    n, seed = int(scene["n"]), int(scene["seed"])
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, size=(n, 2))
    r = rng.uniform(0.01, 0.06, size=n)
    return {"centres": c, "radii": r, "clipped": np.arange(n) % 3 == 0}


def _min_tree(ctx, parts):
    while len(parts) > 1:
        nxt = [ctx.min(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def build(port, scene: dict):
    """(tape, {name: Var}) of the field in `port`'s graph API."""
    d = draws(scene)
    ctx = port.Context()
    vars_ = {name: port.Var.new() for name in PARAMS}
    shift, grow = (ctx.input(vars_[name]) for name in PARAMS)
    x = ctx.sub(ctx.x(), shift)
    y = ctx.y()
    parts = []
    for (cx, cy), r, clip in zip(d["centres"], d["radii"], d["clipped"]):
        dx = ctx.sub(x, float(cx))
        dy = ctx.sub(y, float(cy))
        f = ctx.sub(ctx.sqrt(ctx.add(ctx.square(dx), ctx.square(dy))),
                    float(r))
        if clip:
            f = ctx.max(f, ctx.sub(ctx.abs(dy), float(r) * 0.5))
        parts.append(f)
    root = ctx.sub(_min_tree(ctx, parts), grow)
    return port.lower(ctx, [root]), vars_


def op_counts(scene: dict) -> dict:
    """Operations of the field a point, by kind: "sub_imm" (a variable
    minus a constant), "sub" (of two variables), "add", "square",
    "sqrt", "abs", "max", "min"."""
    n = int(scene["n"])
    clipped = int(draws(scene)["clipped"].sum())
    return {
        "sub": 2,  # x - shift, and the final - grow
        "sub_imm": 3 * n + clipped,  # dx, dy, - r; the band's - r / 2
        "square": 2 * n,
        "add": n,
        "sqrt": n,
        "abs": clipped,
        "max": clipped,
        "min": n - 1,
    }
