"""The port's union plans (compiler/unions.py) against fidget_tpu's.

`pack_choices` and `build_union_plan` are host numpy on both sides; the
plans must match field for field: every program's tape fields, the
packed union words, the block -> program map, the capacities and the
plan-time active counts, over seeded procedural shapes, views, tile
sizes, block edges, headrooms and a shape variable.
"""

import numpy as np
import pytest

import fidget_tpu as ref
from fidget_tpu.compiler.unions import build_union_plan as ref_build
from fidget_tpu.compiler.unions import pack_choices as ref_pack

import fidget_tpu_torch as port
from fidget_tpu_torch.compiler.unions import (
    UnionPlan,
    build_union_plan,
    pack_choices,
)
from test_torch_compiler import SHAPES, _assert_same_tape, port_tape_from_ref
from test_torch_unrolled import FAST_SHAPES, PAN

VIEWS = {
    "identity": np.eye(4, dtype=np.float32),
    "pan": np.array([[1.3, 0, 0, 0.21], [0, 1.3, 0, -0.17], [0, 0, 1, 0],
                     [0, 0, 0, 1]], np.float32),
    "zoom-in": np.diag([0.2, 0.2, 1.0, 1.0]).astype(np.float32),
}


def _mat(rr, view):
    """The renderer's screen -> model matrix of a view (the 2D renderer
    composes it with the image size)."""
    v = VIEWS[view]
    return rr._mat4(v[[0, 1, 3]][:, [0, 1, 3]])


def _assert_same_plan(got: UnionPlan, want):
    for f in ("T0", "block_tiles", "n0x", "n0y"):
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.programs) == len(want.programs)
    for pg, pw in zip(got.programs, want.programs):
        _assert_same_tape(pg, pw)
    for f in ("u_packed", "block_prog", "caps", "act_counts"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.total_ops == want.total_ops
    assert got.stats() == want.stats()


def test_pack_choices_matches_reference():
    rng = np.random.default_rng(3)
    for n_choice in (0, 1, 15, 16, 17, 40):
        codes = rng.integers(0, 4, size=(n_choice, 37)).astype(np.uint8)
        got, want = pack_choices(codes), ref_pack(codes)
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)


PLAN_CASES = [
    ("union", 128, 8, 32, "identity", {}),
    ("union", 128, 8, 32, "pan", {}),
    ("union", 256, 8, 64, "zoom-in", {}),
    ("union", 192, 16, 64, "pan", dict(headroom=1.4)),
    ("spiky", 128, 8, 256, "identity", {}),
    ("nan_div", 96, 8, 32, "pan", {}),
    ("logic", 64, 8, 16, "identity", dict(headroom_slots=0)),
]


@pytest.mark.parametrize(
    "name,n,T0,bpx,view,kw", PLAN_CASES,
    ids=[f"{c[0]}-{c[1]}-t{c[2]}-b{c[3]}-{c[4]}" for c in PLAN_CASES],
)
def test_union_plan_matches_reference(name, n, T0, bpx, view, kw):
    from fidget_tpu.render.render2d import PixelRenderer as RefPixelRenderer
    from fidget_tpu.render.region import ImageSize as RefImageSize

    ctx = ref.Context()
    t_ref = ref.lower(ctx, [FAST_SHAPES[name](ctx)])
    t_port = port_tape_from_ref(t_ref)
    rr = RefPixelRenderer(t_ref, RefImageSize(n, n), interpret=True)
    pr = port.PixelRenderer(t_port, port.ImageSize(n, n), device="cpu")
    mat = _mat(rr, view)
    np.testing.assert_array_equal(mat, _mat(pr, view))
    n0x = n0y = -(-n // T0)
    want = ref_build(t_ref, T0, n0x, n0y, mat, 0.0, rr._var_vec(None),
                     rr.axis_of, block_px=bpx, **kw)
    got = build_union_plan(t_port, T0, n0x, n0y, mat, 0.0,
                           pr._var_vec(None), pr.axis_of, block_px=bpx, **kw)
    _assert_same_plan(got, want)
    assert len(got.programs) >= 1


def test_union_plan_with_a_shape_variable():
    """A var input: the plan's interval pass binds it as a point."""
    from test_torch_grad import _circle, port_tape_with_vars

    t_ref, cx, rv = _circle(ref)
    t_port = port_tape_with_vars(t_ref)
    axis_of = {v.kind: i for v, i in t_ref.var_map.items() if v.kind in "xyz"}
    vec = np.zeros(len(t_ref.var_map), np.float32)
    vec[t_ref.var_map[cx]] = 0.1
    vec[t_ref.var_map[rv]] = 0.5
    mat = np.diag([1 / 32, -1 / 32, 1.0, 1.0]).astype(np.float32)
    mat[0, 3], mat[1, 3] = -1.0, 1.0
    want = ref_build(t_ref, 8, 8, 8, mat, 0.0, vec, axis_of, block_px=16)
    got = build_union_plan(t_port, 8, 8, 8, mat, 0.0, vec, axis_of,
                           block_px=16)
    _assert_same_plan(got, want)


def test_plan_programs_are_exact_for_their_tiles():
    """Every active tile's own trace is a subset of its block's union,
    and its program equals the full tape on the tile's pixels."""
    import torch

    from fidget_tpu_torch.eval.unrolled_fast import eval_tape_float_fast
    from fidget_tpu_torch.render import unrolled2d as u2
    from fidget_tpu_torch.render.transform import transform_points

    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["union"](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(128, 128), device="cpu")
    mat = r._mat4(PAN[:, :])
    plan = build_union_plan(tape, 8, 16, 16, mat, 0.0, r._var_vec(None),
                            r.axis_of, block_px=32)
    x0, y0 = u2.state(r).tiles(8)
    rin, rout, words = u2.cull_capture(r, 8, mat, 0.0, r._var_vec(None))
    act = (~(rin | rout)).numpy()
    w = words.numpy().T.view(np.uint32)
    bp = plan.block_prog
    assert (bp[act] >= 0).all()
    u = plan.u_packed[bp[act]]
    assert ((w[act] | u) == u).all()
    ii = torch.arange(64, dtype=torch.float32)
    for t in np.nonzero(act)[0][::7]:
        px = x0[t] + ii % 8
        py = y0[t] + torch.div(ii, 8, rounding_mode="floor")
        mx, my, _ = transform_points(torch.from_numpy(mat), px, py,
                                     torch.tensor(0.0))
        ins = [None] * r.n_inputs
        ins[r.axis_of["x"]], ins[r.axis_of["y"]] = mx, my
        full = eval_tape_float_fast(tape, ins)[0]
        prog = eval_tape_float_fast(plan.programs[bp[t]], ins)[0]
        assert torch.equal(full, prog)
