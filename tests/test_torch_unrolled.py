"""The port's per-shape compiled 2D path against fidget_tpu's, on the CPU.

`eval/unrolled_fast.py` (the plain versions of the generated kernels U1
`unrolled_float` and U2 `unrolled_interval`) against the reference's
`eval_tape_float_fast` / `eval_tape_interval_fast`: distances and bounds
at tests/test_kernel_ops.py's tolerances (rtol = atol = 2e-5), proof
flags, captured choice words and violation flags exactly, on seeded
procedural shapes and on shapes with NaN, an immediate denominator of 0
and a denominator that spans zero. Then `PixelRenderer.render_unrolled`
(leaf full and union, cull unrolled and interp, 8- and 16-px tiles,
pixel_perfect, a capacity that must retry, vars with a transform, a
stale camera routed to the fallback, an overflow that rebuilds the
plan) and `render_dense` against the reference's frames (XLA on the
CPU) and `render_brute`: fills and occupancy exact, distances allclose
(rtol 1e-5, atol 1e-6) where the fill is FILL_NONE. Gradients through
the dense and the unrolled frame against central differences and the
reference's `jax.jvp`. The emitter's sources and cache keys, and a
build that cannot run raising, on the CPU.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.eval import unrolled_fast as ref_fast
from fidget_tpu.render import render2d as ref_r2d
from fidget_tpu.render.region import ImageSize as RefImageSize

import fidget_tpu_torch as port
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval import unrolled_cuda as uc
from fidget_tpu_torch.eval.unrolled_fast import (
    eval_tape_float_fast,
    eval_tape_interval_fast,
)
from fidget_tpu_torch.render import unrolled2d as u2
from fidget_tpu_torch.render.render2d import FILL_NONE
from test_fuzz import random_tape
from test_torch_compiler import SHAPES, port_tape_from_ref
from test_torch_grad import _circle, _vec, port_tape_with_vars

#: a pan and zoom of the view, so tiles straddle the shapes differently
PAN = np.array([[1.3, 0.0, 0.21], [0.0, 1.3, -0.17], [0.0, 0.0, 1.0]])
#: a stale camera for a plan built at the identity view
STALE = np.array([[0.7, 0.1, 0.2], [-0.1, 0.7, -0.1], [0, 0, 1]], np.float32)


def _nan_div_shape(ctx):
    """NaN (sqrt of a negative), an immediate denominator of 0 and a
    denominator that spans zero, under min/max."""
    x, y = ctx.x(), ctx.y()
    r = ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y)))
    nan = ctx.sqrt(ctx.sub(x, 0.25))  # NaN left of x = 0.25
    by_zero = ctx.div(ctx.sub(y, 0.1), 0.0)
    spans = ctx.div(ctx.sub(x, 0.3), ctx.add(y, 0.05))
    d = ctx.min(ctx.sub(r, 0.6), ctx.max(nan, ctx.sub(ctx.abs(x), 0.9)))
    d = ctx.max(d, ctx.min(by_zero, ctx.sub(r, 0.95)))
    return ctx.min(d, ctx.max(spans, ctx.sub(r, 0.4)))


def _logic_shape(ctx):
    """AND/OR choices and a division by a non-zero immediate."""
    x, y = ctx.x(), ctx.y()
    r = ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y)))
    a = ctx.and_(ctx.sub(r, 0.5), ctx.div(ctx.sub(ctx.abs(y), 0.2), 2.0))
    return ctx.or_(ctx.max(a, ctx.sub(r, 0.7)), ctx.sub(ctx.abs(x), 0.8))


FAST_SHAPES = {**SHAPES, "nan_div": _nan_div_shape, "logic": _logic_shape}


def _tapes(name):
    """(reference tape, port tape) of a named shape or a fuzz tape."""
    if name.startswith("fuzz"):
        t = random_tape(int(name[4:]), dims=2)
    else:
        ctx = ref.Context()
        t = ref.lower(ctx, [FAST_SHAPES[name](ctx)])
    return t, port_tape_from_ref(t)


def _boxes(seed, V, n=512):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-1.2, 1.0, size=(V, n)).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 0.5, size=(V, n))).astype(np.float32)
    return lo, hi


def _close(got, want, rtol=2e-5, atol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    nan = np.isnan(got) & np.isnan(want)
    same = got == want
    close = np.abs(got - want) <= atol + rtol * np.abs(want)
    assert (nan | same | close).all(), np.abs(got - want)[~(nan | same | close)]


FAST_CASES = ["circle", "spiky", "union", "nan_div", "logic", "fuzz3",
              "fuzz8"]


@pytest.mark.parametrize("name", FAST_CASES)
def test_float_fast_matches_reference(name):
    t_ref, t_port = _tapes(name)
    V = max(1, len(t_ref.var_map))
    pts = np.random.default_rng(5).uniform(-1.3, 1.3, (V, 4096)).astype(
        np.float32)
    want = ref_fast.eval_tape_float_fast(t_ref, [jnp.asarray(p) for p in pts])
    got = eval_tape_float_fast(t_port, [torch.from_numpy(p) for p in pts])
    _close(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("name", FAST_CASES)
def test_interval_fast_matches_reference(name):
    """Bounds allclose, proofs, captured words and violation flags
    exact (the violation test against the reference's words of a
    shifted set of boxes, so that some tiles escape)."""
    t_ref, t_port = _tapes(name)
    V = max(1, len(t_ref.var_map))
    lo, hi = _boxes(11, V)
    j_in = [(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(lo, hi)]
    t_in = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in zip(lo, hi)]
    wl, wh, ww = ref_fast.eval_tape_interval_fast(t_ref, j_in, capture=True)
    gl, gh, gw = eval_tape_interval_fast(t_port, t_in, capture=True)
    _close(gl[0].numpy(), np.asarray(wl[0]))
    _close(gh[0].numpy(), np.asarray(wh[0]))
    np.testing.assert_array_equal(gh[0].numpy() < 0, np.asarray(wh[0]) < 0)
    np.testing.assert_array_equal(gl[0].numpy() > 0, np.asarray(wl[0]) > 0)
    assert len(gw) == len(ww) == -(-t_ref.choice_count // 16)
    for g, w in zip(gw, ww):
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w).astype(np.uint32))
    if not ww:
        return
    lo2, hi2 = _boxes(12, V)
    _, _, u = ref_fast.eval_tape_interval_fast(
        t_ref, [(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(lo2, hi2)],
        capture=True,
    )
    u = np.stack([np.asarray(w).astype(np.uint32) for w in u])
    u[:, ::3] = np.stack([np.asarray(w) for w in ww])[:, ::3]
    _, _, want = ref_fast.eval_tape_interval_fast(t_ref, j_in,
                                                  u_words=jnp.asarray(u))
    _, _, got = eval_tape_interval_fast(
        t_port, t_in, u_words=torch.from_numpy(u.view(np.int32)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()


def test_interval_fast_nan_and_division_rules():
    """The fast rules themselves: a NaN box proves nothing; a
    denominator that spans zero poisons, one that does not and a
    non-zero immediate do not; an immediate 0 poisons."""
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    t = port.lower(ctx, [ctx.div(x, y), ctx.div(x, 2.0), ctx.div(x, 0.0)])
    ix, iy = (t.var_map[v] for v in (port.Var.X, port.Var.Y))
    ins = [None, None]
    ins[ix] = (torch.tensor([1.0, 1.0, float("nan")]),
               torch.tensor([2.0, 2.0, float("nan")]))
    ins[iy] = (torch.tensor([-1.0, 0.5, 1.0]), torch.tensor([1.0, 1.0, 2.0]))
    los, his = eval_tape_interval_fast(t, ins)
    assert torch.isnan(los[0][0]) and not torch.isnan(los[0][1])
    assert torch.isnan(los[0][2])
    assert los[1][0] == 0.5 and his[1][0] == 1.0
    assert torch.isnan(los[2]).all() and torch.isnan(his[2]).all()


# ----------------------------------------------------------------------
# frames


def _pair(name, n, tile_size=None, shape=None):
    if shape is None:
        ctx = ref.Context()
        shape_r = ref.lower(ctx, [FAST_SHAPES[name](ctx)])
        shape_p = port_tape_from_ref(shape_r)
    else:
        shape_r, shape_p = shape
    kw = {} if tile_size is None else dict(tile_size=tile_size)
    rr = ref_r2d.PixelRenderer(shape_r, RefImageSize(n, n), interpret=True,
                               **kw)
    pr = port.PixelRenderer(shape_p, port.ImageSize(n, n), device="cpu", **kw)
    return rr, pr


def _check(img, want=None, brute=None, rtol=1e-5, atol=1e-6):
    """Fills and occupancy exact, distances allclose where evaluated,
    against a reference Image2D and/or `render_brute`."""
    dist, fill = img.distance.numpy(), img.fill.numpy()
    ev = fill == FILL_NONE
    if want is not None:
        np.testing.assert_array_equal(fill, np.asarray(want.fill))
        np.testing.assert_array_equal(img.inside().numpy(),
                                      np.asarray(want.inside()))
        np.testing.assert_allclose(dist[ev], np.asarray(want.distance)[ev],
                                   rtol=rtol, atol=atol)
    if brute is not None:
        np.testing.assert_array_equal(img.inside().numpy(), brute < 0)
        np.testing.assert_allclose(dist[ev], brute[ev], rtol=rtol, atol=atol)


UNROLLED_CASES = [
    ("union", 128, None, dict(leaf="full")),
    ("union", 128, PAN, dict(leaf="full", cull="interp")),
    ("spiky", 128, PAN, dict(leaf="full", tile_size=16)),
    ("union", 128, PAN, dict(leaf="full", pixel_perfect=True)),
    ("nan_div", 96, None, dict(leaf="full")),
    ("union", 128, None, dict(leaf="union", block_px=32)),
    ("union", 192, PAN, dict(leaf="union", block_px=64, tile_size=16)),
    ("logic", 64, PAN, dict(leaf="union", block_px=32)),
    ("nan_div", 96, PAN, dict(leaf="union", block_px=32, cull="interp")),
]


@pytest.mark.parametrize(
    "name,n,view,kw", UNROLLED_CASES,
    ids=[f"{c[0]}-{c[1]}-{'-'.join(f'{k}{v}' for k, v in c[3].items())}"
         for c in UNROLLED_CASES],
)
def test_render_unrolled_matches_reference_and_brute(name, n, view, kw):
    rr, pr = _pair(name, n)
    want = rr.render_unrolled(view, **kw)
    got = pr.render_unrolled(view, **kw)
    _check(got, want, pr.render_brute(view))
    if kw.get("leaf") == "union":
        for k in ("n_active", "n_fallback", "programs", "total_ops", "slots"):
            assert pr.union_stats[k] == rr.union_stats[k], k


def test_unrolled_stages_match_reference():
    """The full-leaf frame stage by stage: U2's proofs and the K1 sizing
    pass against the reference's cull stages, and the frame's n_active."""
    rr, pr = _pair("union", 128)
    T0, n0x = 8, 16
    key = id(rr.tape)
    ref_r2d._register_tape(key, lambda: (rr.tape, rr.packed_b, rr.axis_of,
                                         rr.nf_b, rr.cw_b))
    x0, y0 = u2.state(pr).tiles(T0)
    mat = rr._mat4(PAN)
    args = (jnp.asarray(x0.numpy()), jnp.asarray(y0.numpy()),
            jnp.asarray(mat), jnp.float32(0.0),
            jnp.asarray(rr._var_vec(None)))
    mt, zt, vt = u2._device_args(pr, mat, 0.0, pr._var_vec(None))
    for stage, mine in (
        (ref_r2d._unrolled_cull_stage,
         lambda: u2.cull_unrolled(pr, T0, x0, y0, mt, zt, vt)[:2]),
        (ref_r2d._cull_sizing_stage,
         lambda: u2.cull_sizing(pr, T0, x0, y0, mt, zt, vt)),
    ):
        want = stage(key, T0, n0x * n0x, rr.n_inputs, *args, True)
        for g, w in zip(mine(), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    fn = ref_r2d._frame_unrolled_fn(key, T0, n0x, n0x, 96, rr.n_inputs, False,
                                    True)
    w_img, w_fill, w_n = fn(*args)
    g_img, g_fill, g_n = pr._frame_unrolled(mat, 0.0, pr._var_vec(None),
                                            cap=96)
    assert int(g_n) == int(w_n) > 96  # the worklist overflowed
    np.testing.assert_array_equal(g_fill.numpy(), np.asarray(w_fill))


def test_cull_capture_matches_host_pack():
    """The capture epilogue's words equal `pack_choices` over the host
    oracle's choice codes (NaN-free tiles), and the reference's words."""
    from fidget_tpu_torch.compiler.unions import pack_choices
    from fidget_tpu_torch.eval.arith import IntervalMode
    from fidget_tpu_torch.eval.unrolled import eval_tape
    from fidget_tpu_torch.render.transform import transform_intervals

    rr, pr = _pair("union", 128)
    T0 = 8
    mat = pr._mat4(PAN)
    rin, rout, words = u2.cull_capture(pr, T0, mat, 0.0, pr._var_vec(None))
    x0, y0 = (t.numpy() for t in u2.state(pr).tiles(T0))
    im = IntervalMode(np)
    with np.errstate(all="ignore"):
        mxi, myi, _ = transform_intervals(im, mat, (x0, x0 + T0),
                                          (y0, y0 + T0), (0.0, 0.0))
        ins = [None] * pr.n_inputs
        ins[pr.axis_of["x"]], ins[pr.axis_of["y"]] = mxi, myi
        (out,), choices = eval_tape(pr.tape, im, ins, trace=True)
    want = pack_choices(np.stack(choices))
    np.testing.assert_array_equal(words.numpy().T.view(np.uint32), want)
    np.testing.assert_array_equal(rin.numpy(), out[1] < 0)
    np.testing.assert_array_equal(rout.numpy(), out[0] > 0)


def test_render_dense_matches_reference_and_brute():
    """tests/test_render2d.py:284 on the port, 96 x 128, with a pan."""
    ctx = ref.Context()
    t = ref.lower(ctx, [SHAPES["spiky"](ctx)])
    rr = ref_r2d.PixelRenderer(t, RefImageSize(96, 128), interpret=True)
    pr = port.PixelRenderer(port_tape_from_ref(t), port.ImageSize(96, 128),
                            device="cpu")
    got = pr.render_dense(PAN)
    want = rr.render_dense(PAN)
    assert got.distance.shape == (128, 96)
    assert (got.fill.numpy() == FILL_NONE).all()
    brute = pr.render_brute(PAN)
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(want.distance),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.distance.numpy(), brute, rtol=1e-5,
                               atol=1e-6)


def test_unrolled_capacity_retry():
    """tests/test_render2d.py:498 on the port: a capacity far too small
    retries into a fitting bucket, recorded per tile size."""
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    tape = port.lower(ctx, [ctx.sub(ctx.sqrt(ctx.add(ctx.square(x),
                                                    ctx.square(y))), 0.7)])
    r = port.PixelRenderer(tape, port.ImageSize(128, 128), device="cpu")
    img = r.render_unrolled(cap=128 // 8)
    _check(img, brute=r.render_brute())
    assert len(r._ucap) == 1
    (cap,) = r._ucap.values()
    assert cap >= 16


def test_unrolled_with_vars_and_transform():
    """tests/test_render2d.py:514 on the port, against the reference."""
    rv = ref.Var.new()
    x, y, _ = ref.Tree.axes()
    shape = ref.Shape.from_tree(
        (x.square() + y.square()).sqrt() - ref.Tree.var(rv)
    ).apply_transform(np.diag([0.5, 0.5, 1.0, 1.0]))
    rr = ref_r2d.PixelRenderer(shape, RefImageSize(128, 128), interpret=True)
    pv = port.Var.new()
    px, py, _ = port.Tree.axes()
    pshape = port.Shape.from_tree(
        (px.square() + py.square()).sqrt() - port.Tree.var(pv)
    ).apply_transform(np.diag([0.5, 0.5, 1.0, 1.0]))
    pr = port.PixelRenderer(pshape, port.ImageSize(128, 128), device="cpu")
    for leaf in ("full", "union"):
        want = rr.render_unrolled(vars={rv: 0.4}, leaf=leaf, block_px=32)
        got = pr.render_unrolled(vars={pv: 0.4}, leaf=leaf, block_px=32)
        _check(got, want, pr.render_brute(vars={pv: 0.4}))


def test_union_stale_camera_exact_via_fallback():
    """tests/test_union_leaf.py:39 on a procedural shape: a camera the
    plan was not built for renders exactly through the fallback, as the
    reference's frame does, tile counts equal."""
    rr, pr = _pair("union", 128)
    kw = dict(tile_size=8, leaf="union", block_px=32)
    rr.render_unrolled(**kw)
    pr.render_unrolled(**kw)
    want = rr.render_unrolled(STALE, **kw)
    got = pr.render_unrolled(STALE, **kw)
    assert pr.union_stats["n_fallback"] > 0
    assert pr.union_stats == rr.union_stats
    _check(got, want, pr.render_brute(STALE))


def test_union_overflow_rebuilds_plan():
    """tests/test_union_leaf.py:100 on a procedural shape: a plan built
    zoomed in has caps far too small for the full view; the frame
    overflows, the plan is rebuilt at the current camera, and the
    result is exact and equal to the reference's."""
    rr, pr = _pair("union", 256)
    kw = dict(tile_size=8, leaf="union", block_px=32)
    m_in = np.diag([0.2, 0.2, 1.0]).astype(np.float32)
    rr.render_unrolled(m_in, **kw)
    pr.render_unrolled(m_in, **kw)
    plan0 = u2.state(pr).plans[(8, 32)]
    want = rr.render_unrolled(**kw)
    got = pr.render_unrolled(**kw)
    assert u2.state(pr).plans[(8, 32)] is not plan0
    assert pr.union_stats == rr.union_stats
    _check(got, want, pr.render_brute())


def test_union_plan_refreshes_in_the_background():
    """Above 5% fallback the plan is rebuilt for the current camera in
    a thread; once swapped, the same view has no fallback."""
    import time

    _, pr = _pair("union", 128)
    kw = dict(tile_size=8, leaf="union", block_px=32)
    pr.render_unrolled(**kw)
    m = np.array([[0.6, 0.15, 0.2], [-0.15, 0.6, -0.1], [0, 0, 1]],
                 np.float32)
    img = pr.render_unrolled(m, **kw)
    assert pr.union_stats["n_fallback"] > 16
    _check(img, brute=pr.render_brute(m))
    st = u2.state(pr)
    for _ in range(600):
        if not st.refreshing.get((8, 32)):
            break
        time.sleep(0.05)
    img2 = pr.render_unrolled(m, **kw)
    assert pr.union_stats["n_fallback"] == 0
    _check(img2, brute=pr.render_brute(m))


def test_failed_plan_refresh_raises_on_the_next_call(monkeypatch):
    """A background plan refresh that fails is not swallowed: the next
    `render_unrolled` call raises it."""
    import time

    _, pr = _pair("union", 128)
    kw = dict(tile_size=8, leaf="union", block_px=32)
    pr.render_unrolled(**kw)

    def boom(*a, **k):
        raise RuntimeError("plan build failed")

    monkeypatch.setattr(u2, "build_union_plan", boom)
    m = np.array([[0.6, 0.15, 0.2], [-0.15, 0.6, -0.1], [0, 0, 1]],
                 np.float32)
    pr.render_unrolled(m, **kw)  # stale plan: starts the refresh
    st = u2.state(pr)
    for _ in range(600):
        if not st.refreshing.get((8, 32)):
            break
        time.sleep(0.05)
    with pytest.raises(RuntimeError, match="plan build failed"):
        pr.render_unrolled(m, **kw)


def test_no_launch_on_the_cpu():
    """On the CPU the plain versions run and no kernel is counted."""
    _, pr = _pair("circle", 64)
    cuda.reset_launches()
    pr.render_unrolled(leaf="union", block_px=32)
    pr.render_dense()
    assert cuda.LAUNCHES == {k: 0 for k in cuda.KERNELS}
    assert {"unrolled_float", "unrolled_interval"} <= set(cuda.KERNELS)


# ----------------------------------------------------------------------
# emitting and building


def _small_tape():
    ctx = port.Context()
    return port.lower(ctx, [_nan_div_shape(ctx)])


def test_emitter_one_statement_per_row():
    """One statement per tape row: in U1's program, and in U2's warp
    streams, where every computing row appears exactly once across the
    k units, which the kernel unit calls by warp; U2's units, and only
    they, carry INTERVAL_FLAGS."""
    t = _small_tape()
    axis = {v.kind: i for v, i in t.var_map.items()}
    src = uc.FloatKernel([t], axis, 2).unit().objects[0].source
    body = src.split("  float o = 0.f;\n")[1].split("  return o;")[0]
    stmts = [ln.strip() for ln in body.strip().splitlines()]
    assert len(stmts) == len(t)
    assert all(ln.count(";") == 1 for ln in stmts)
    k = uc.IntervalKernel(t, axis, 2, "violation")
    unit = k.unit()
    sched = k.schedule()
    assert len(unit.objects) == sched.k == uc.INTERVAL_WARPS
    assert unit.flags == uc.INTERVAL_FLAGS
    assert all(o.flags == uc.INTERVAL_FLAGS for o in unit.objects)
    assert uc.FloatKernel([t], axis, 2).unit().flags == ()
    computing = [i for i, row in enumerate(t.rows()) if row[0] not in (
        port.TapeOp.INPUT, port.TapeOp.OUTPUT, port.TapeOp.COPY,
        port.TapeOp.LOAD, port.TapeOp.STORE)]
    defined = []
    for w, o in enumerate(unit.objects):
        assert f"U_WARP_BEGIN(fidget_uiw_{o.key})" in o.source
        assert f"case {w}: fidget_uiw_{o.key}(" in unit.source or (
            w == sched.k - 1 and f"default: fidget_uiw_{o.key}("
            in unit.source)
        for ln in o.source.splitlines():
            ln = ln.strip()
            if ln.startswith("const Ival v") and "U_SH(" not in ln.split(
                    "=")[1][:8]:
                defined.append(int(ln.split()[2][1:]))
        # every warp passes the same barriers
        assert o.source.count("U_BAR();") == sched.n_stages - 1
    assert sorted(defined) == computing
    text = "\n".join(o.source for o in unit.objects)
    assert text.count("U_CHOICE(") == t.choice_count


def test_emitter_sources_and_keys(monkeypatch):
    """The same tape gives the same source and key; a changed tape,
    epilogue or warp count changes the key."""
    t = _small_tape()
    axis = {v.kind: i for v, i in t.var_map.items()}

    def keys(tape, epilogue="proofs"):
        fk = uc.FloatKernel([tape], axis, 2)
        ik = uc.IntervalKernel(tape, axis, 2, epilogue)
        u = uc.FloatKernel([tape, tape], axis, 2).unit()
        return (fk.unit().key, u.objects[0].key, fk.unit().source,
                ik.unit().key, ik.unit().source)

    a, b = keys(t), keys(_small_tape())
    assert a == b
    t2 = _small_tape()
    t2.imm[np.nonzero(t2.imm)[0][0]] += 0.5
    c = keys(t2)
    assert c[0] != a[0] and c[1] != a[1] and c[3] != a[3]
    assert keys(t, "capture")[3] != a[3]
    assert keys(t, "violation")[3] != keys(t, "capture")[3]
    monkeypatch.setattr(uc, "INTERVAL_WARPS", uc.INTERVAL_WARPS * 2)
    assert keys(t)[3] != a[3] and keys(t)[0] == a[0]


def test_template_change_changes_keys(monkeypatch, tmp_path):
    """The key hashes the template's and the emitter's bytes: an edited
    copy of either gives every unit a new key."""
    t = _small_tape()
    axis = {v.kind: i for v, i in t.var_map.items()}

    def keys():
        return (uc.IntervalKernel(t, axis, 2, "proofs").unit().key,
                uc.FloatKernel([t], axis, 2).unit().key,
                uc.FloatKernel([t, t], axis, 2).unit().objects[0].key)

    before = keys()
    for src in (uc.TEMPLATE, pathlib.Path(uc.__file__).resolve()):
        assert src in uc.SOURCES
        edited = tmp_path / src.name
        edited.write_bytes(src.read_bytes() + b"\n// edited\n")
        with monkeypatch.context() as m:
            m.setattr(uc, "SOURCES", tuple(
                edited if p == src else p for p in uc.SOURCES))
            after = keys()
        assert all(x != y for x, y in zip(before, after)), src.name


def test_union_programs_share_objects():
    """A union kernel's programs are objects of their own, keyed by
    tape: the full-tape fallback is the same object in two plans'
    kernels, and the full leaf's; every program is named by its key."""
    _, pr = _pair("union", 128)
    pr.render_unrolled(leaf="union", block_px=32)
    st = u2.state(pr)
    plan = st.plans[(8, 32)]
    kern = u2.union_tables(pr, plan, 128).kernel
    unit = kern.unit()
    assert len(unit.objects) == len(plan.programs) + 1
    again = uc.FloatKernel([plan.programs[-1], pr.tape], pr.axis_of,
                           pr.n_inputs).unit()
    assert unit.objects[-1].key == again.objects[-1].key
    assert unit.objects[-1].key == st.float_full.unit().objects[0].key
    for o in unit.objects:
        assert f"fidget_uprog_{o.key}" in o.source
        assert f"fidget_uprog_{o.key}" in unit.source


def test_float_kernel_forms():
    """U1's emitted form: every program, a lone one too, a
    `__noinline__` function of its own unit taking one pixel's V
    inputs, dispatched by segment (U_NSEG programs); MIN/MAX as u_fmin /
    u_fmax (min.NaN / max.NaN)."""
    t = _small_tape()
    axis = {v.kind: i for v, i in t.var_map.items()}
    one = uc.FloatKernel([t], axis, 2).unit()
    assert len(one.objects) == 1 and "#define U_NSEG 1\n" in one.source
    prog = one.objects[0].source
    assert "__noinline__ float fidget_uprog_" in prog
    assert "(float i0, float i1)" in prog
    assert "u_fmin(" in prog and "u_fmax(" in prog
    assert "nmin(" not in prog and "nmax(" not in prog
    two = uc.FloatKernel([t, t], axis, 2).unit()
    assert "#define U_NSEG 2\n" in two.source
    assert "case 0: return fidget_uprog_" in two.source
    assert len({o.key for o in two.objects}) == 1


def test_float_kernel_small_programs_share_a_unit():
    """Programs of at most SMALL_PROGRAM_ROWS rows share one object (one
    nvcc step), each still a `__noinline__` function named by its own
    key and called by segment as before; a longer program keeps an
    object of its own, and a lone small program its own key. The object
    is keyed by its distinct programs."""
    ctx = port.Context()
    t1 = port.lower(ctx, [ctx.min(ctx.x(), ctx.y())])
    ctx = port.Context()
    t2 = port.lower(ctx, [ctx.max(ctx.x(), ctx.y())])
    t = _small_tape()
    assert max(len(t1), len(t2)) <= uc.SMALL_PROGRAM_ROWS < len(t)
    axis = {v.kind: i for v, i in t.var_map.items()}
    lone = [uc.FloatKernel([x], axis, 2).unit().objects for x in (t1, t2, t)]
    unit = uc.FloatKernel([t1, t, t2, t1], axis, 2).unit()
    assert len(unit.objects) == 2
    assert unit.objects[0].key == lone[2][0].key
    shared = unit.objects[1].source
    assert shared.count('#include "unrolled.cuh"') == 1
    for objs in lone[:2]:
        fn = objs[0].source.split("using namespace fidget;\n")[1]
        assert shared.count(fn) == 1
        assert f"fidget_uprog_{objs[0].key}(" in unit.source
    assert shared.count("__noinline__ float fidget_uprog_") == 2
    same = uc.FloatKernel([t1, t2], axis, 2).unit()
    assert same.objects[0].key == unit.objects[1].key


# ----------------------------------------------------------------------
# U2's warp schedule


def _chain_tape(n=24):
    """A left-deep union of n circles: every MIN reads the one before."""
    rng = np.random.default_rng(3)
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    acc = None
    for _ in range(n):
        cx, cy = rng.uniform(-1, 1, 2)
        c = ctx.sub(ctx.sqrt(ctx.add(ctx.square(ctx.sub(x, float(cx))),
                                     ctx.square(ctx.sub(y, float(cy))))),
                    0.2)
        acc = c if acc is None else ctx.min(acc, c)
    return ctx, acc


def _schedule_tape(name):
    if name == "standin40":
        from fidget_tpu_torch.scenes import standin_shape

        ctx = port.Context()
        return port.lower(ctx, [standin_shape(ctx, n=40)])
    if name == "nan_div":
        return _small_tape()
    if name == "chain":
        ctx, root = _chain_tape()
        return port.lower(ctx, [root])
    if name == "spill":  # few registers: LOAD / STORE slots
        ctx, root = _chain_tape(12)
        t = port.lower(ctx, [root], reg_limit=3)
        assert t.mem_count > 0
        return t
    return _tapes(name)[1]


SCHEDULE_TAPES = ["standin40", "nan_div", "chain", "spill", "logic",
                  "fuzz3", "fuzz8", "fuzz13"]


@pytest.mark.parametrize("warps", [1, 4, 8])
@pytest.mark.parametrize("name", SCHEDULE_TAPES)
def test_interval_schedule_is_valid(name, warps):
    """Every computing row is assigned to one warp exactly once; an
    operand is produced earlier in its warp (a lower or equal stage and
    earlier in the run) or crosses warps through a slot, stored in an
    earlier stage than every read and not reused until after the last;
    choice j shifts by 2 (j % 16) and its warp's part of word j / 16 is
    done at or after it; every warp passes every barrier."""
    t = _schedule_tape(name)
    sched = uc.schedule_interval(t, warps)
    assert sched.k == warps
    runs = [i for w in range(sched.k) for run in sched.runs[w] for i in run]
    assert sorted(runs) == sorted(sched.order) and len(set(runs)) == len(runs)
    pos = {i: n for w in range(sched.k) for n, i in enumerate(
        i for run in sched.runs[w] for i in run)}
    for i in sched.order:
        w, s = sched.warp_of[i], sched.stage_of[i]
        assert i in sched.runs[w][s]
        for p in sched.producers[i]:
            if sched.warp_of[p] == w:
                assert sched.stage_of[p] <= s and pos[p] < pos[i]
            else:
                assert sched.stage_of[p] < s <= sched.n_stages
                assert sched.stage_of[p] < sched.last_read[p]
    by_slot = {}
    for p, slot in sched.slot_of.items():
        by_slot.setdefault(slot, []).append(
            (sched.stage_of[p], sched.last_read[p]))
    for spans in by_slot.values():
        spans.sort()
        for (_, end), (start, _) in zip(spans, spans[1:]):
            assert start > end
    assert sched.shared_bytes() == sched.n_slots * 256
    if warps == 1:
        assert sched.n_slots == 0 and sched.n_stages == 1
    for w in range(sched.k):
        lines = uc.interval_warp_rows(sched, w)
        assert sum(ln == "U_BAR();" for ln in lines) == sched.n_stages - 1
        touched = set()
        for ln in lines:
            if "U_CHOICE(" not in ln:
                continue
            i = int(ln.split()[2][1:])
            j = sched.choice_of[i]
            assert f"U_CHOICE({2 * (j % 16)}, c_);" in ln
            touched.add(j // 16)
        flushed = {int(ln.split("U_WORD(")[1].split(")")[0])
                   for ln in lines if "U_WORD(" in ln}
        assert flushed == touched


def _run_schedule(sched, inputs, u=None):
    """Executes a schedule as the card would: warp by warp within a
    stage, crossing values visible only after the stage that stores them
    (a read and a store of one slot in one stage fail), rows by
    `interval_row`; choice words as each warp's parts ORed into the
    block's words, tested against u once all are done (violation).
    Returns (lo, hi, words, viol)."""
    from fidget_tpu_torch.eval.arith import IntervalMode
    from fidget_tpu_torch.eval.unrolled_fast import (
        _to_i32,
        _word_bits,
        interval_row,
    )

    im = IntervalMode(torch)
    like = inputs[0][0]

    def const(x):
        c = torch.full_like(like, x)
        return (c, c)

    shared, local = {}, [dict() for _ in range(sched.k)]
    zero = torch.zeros(like.shape, dtype=torch.int64)
    part = [zero] * sched.k
    words = {}
    viol = torch.zeros(like.shape, dtype=torch.bool)
    out = const(0.0) if sched.out is None else (
        None if sched.out[0] == "row" else
        inputs[sched.out[1]] if sched.out[0] == "in" else const(sched.out[1]))
    for s in range(sched.n_stages):
        pending, reads = {}, set()
        for w in range(sched.k):
            for i in sched.runs[w][s]:
                vals = []
                for ref in sched.operands[i]:
                    if ref is None:
                        vals.append(None)
                    elif ref[0] == "row":
                        p = ref[1]
                        if sched.warp_of[p] != w and p not in local[w]:
                            slot = sched.slot_of[p]
                            assert shared[slot][0] == p
                            reads.add(slot)
                            local[w][p] = shared[slot][1]
                        vals.append(local[w][p])
                    elif ref[0] == "in":
                        vals.append(inputs[ref[1]])
                    else:
                        vals.append(const(ref[1]))
                b = sched.operands[i][1]
                val, ch = interval_row(im, sched.op[i], vals[0], vals[1],
                                       b[1] if b is not None else 0.0,
                                       sched.b_imm[i])
                local[w][i] = val
                if ch is not None:
                    j = sched.choice_of[i]
                    part[w] = part[w] | _word_bits(*ch, 2 * (j % 16))
                    if i in sched.flush[w]:
                        word = sched.flush[w][i]
                        words[word] = words.get(word, zero) | part[w]
                        part[w] = zero
                if i in sched.slot_of:
                    assert sched.slot_of[i] not in pending
                    pending[sched.slot_of[i]] = (i, val)
                if sched.out == ("row", i):
                    out = val
        assert not reads & set(pending)
        shared.update(pending)
    assert all((p == 0).all() for p in part)
    if u is not None:
        for j, wj in words.items():
            uj = u[j].to(torch.int64) & 0xFFFFFFFF
            viol = viol | ((wj | uj) != uj)
    return out[0], out[1], [_to_i32(words[j]) for j in sorted(words)], viol


def _special_boxes(seed, V, n=512):
    """`_boxes` with NaN, infinite, signed-zero and denormal bounds in
    some lanes."""
    lo, hi = _boxes(seed, V, n)
    special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40],
                       np.float32)
    rng = np.random.default_rng(seed + 100)
    for arr in (lo, hi):
        idx = rng.integers(0, n, (V, n // 16))
        for v in range(V):
            arr[v, idx[v]] = rng.choice(special, n // 16)
    return lo, hi


@pytest.mark.parametrize("warps", [1, 4, 8])
@pytest.mark.parametrize("name", SCHEDULE_TAPES)
def test_interval_schedule_executor_matches_plain(name, warps):
    """The schedule, executed warp by warp and stage by stage, equals
    `eval_tape_interval_fast` bit for bit: the output's bounds, the
    captured words and the violation flags (against another box set's
    words, every third lane's taken from these boxes)."""
    t = _schedule_tape(name)
    sched = uc.schedule_interval(t, warps)
    V = max(1, len(t.var_map))
    lo, hi = _special_boxes(21, V)
    ins = [(torch.from_numpy(a), torch.from_numpy(b)) for a, b in zip(lo, hi)]
    wl, wh, ww = eval_tape_interval_fast(t, ins, capture=True)
    lo2, hi2 = _boxes(22, V)
    _, _, u = eval_tape_interval_fast(
        t, [(torch.from_numpy(a), torch.from_numpy(b))
            for a, b in zip(lo2, hi2)], capture=True)
    u = torch.stack(u) if u else torch.zeros((0, lo.shape[1]),
                                             dtype=torch.int32)
    if ww:
        u[:, ::3] = torch.stack(ww)[:, ::3]
    _, _, want_viol = eval_tape_interval_fast(t, ins, u_words=u)
    glo, ghi, gw, gviol = _run_schedule(sched, ins, u)

    def bits(a):
        return torch.where(torch.isnan(a), torch.full_like(a, np.nan),
                           a).view(torch.int32)

    assert torch.equal(bits(glo), bits(wl[0]))
    assert torch.equal(bits(ghi), bits(wh[0]))
    assert len(gw) == len(ww)
    for g, w in zip(gw, ww):
        assert torch.equal(g, w)
    assert torch.equal(gviol, want_viol)


def test_interval_schedule_spreads_the_standin():
    """On the stand-in at 1,024^2's tape, 8 warps a group hold equal
    numbers of rows (to one), a few stages and few slots (the design's
    premise: whole subtrees a warp, only their results cross)."""
    from fidget_tpu_torch.scenes import standin_shape

    ctx = port.Context()
    t = port.lower(ctx, [standin_shape(ctx)])
    sched = uc.schedule_interval(t, 8)
    counts = [sum(len(run) for run in sched.runs[w]) for w in range(8)]
    assert max(counts) - min(counts) <= 1
    assert sched.n_stages <= 8
    assert sched.shared_bytes() <= uc.SLOT_BUDGET
    stage0 = sum(len(sched.runs[w][0]) for w in range(8))
    assert stage0 > 0.95 * len(sched.order)


def test_slot_budget_halves_the_warps(monkeypatch):
    """A tape whose hand-offs pass SLOT_BUDGET gets half the warps (down
    to one, which needs none)."""
    t = _schedule_tape("standin40")
    need = uc.schedule_interval(t, 8).shared_bytes()
    assert need > 0
    monkeypatch.setattr(uc, "SLOT_BUDGET", need - 1)
    assert uc.schedule_interval(t, 8).k < 8
    monkeypatch.setattr(uc, "SLOT_BUDGET", 0)
    assert uc.schedule_interval(t, 8).k == 1


def test_interval_kernel_takes_any_choice_count():
    """A tape whose choice words would pass SHARED_LIMIT in a block's
    shared memory keeps them in global memory: 25,700 MIN rows (1,607
    words, 206 KB a block) emit under each epilogue with U_GW 1 and a
    block's shared memory the hand-off slots' (and the violation flags'),
    one U_CHOICE a choice; the small tape's words stay in shared
    memory."""
    ctx = port.Context()
    x = ctx.x()
    acc = None
    for i in range(25_700):
        c = ctx.sub(x, i * 1e-3)
        acc = c if acc is None else ctx.min(acc, c)
    t = port.lower(ctx, [acc])
    assert t.choice_count == 25_699
    sched = uc.schedule_interval(t, uc.INTERVAL_WARPS)
    for epi in ("capture", "violation"):
        k = uc.IntervalKernel(t, {"x": 0}, 1, epi)
        assert k.words_global and k.cw * 128 > uc.SHARED_LIMIT
        unit = k.unit()
        assert "#define U_GW 1\n" in unit.source
        text = "\n".join(o.source for o in unit.objects)
        assert text.count("U_CHOICE(") == t.choice_count
        flags = sched.k * 32 if epi == "violation" else 0
        assert k.shared_bytes() == sched.shared_bytes() + flags
    small = _small_tape()
    k = uc.IntervalKernel(small, {v.kind: i for v, i in small.var_map.items()},
                          2, "violation")
    assert not k.words_global and "#define U_GW 0\n" in k.unit().source
    assert k.shared_bytes() == (k.schedule().shared_bytes() + k.cw * 128
                                + k.schedule().k * 32)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A build that cannot run raises; nothing falls back."""
    monkeypatch.setattr(cuda, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda.os.path, "exists", lambda p: False)
    t = _small_tape()
    k = uc.FloatKernel([t], {v.kind: i for v, i in t.var_map.items()}, 2)
    with pytest.raises(RuntimeError, match="nvcc"):
        uc.build_kernels([k])


def test_warmup_interp_serves_then_raises_a_failed_build(monkeypatch,
                                                         tmp_path):
    """warmup="interp": while the background build runs the frame is not
    ready (the caller serves `render()`); a build that failed raises on
    the next call instead of falling back."""
    import time

    monkeypatch.setattr(cuda, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(cuda.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda.os.path, "exists", lambda p: False)
    _, pr = _pair("circle", 64)
    pr.device = torch.device("cuda")  # as a renderer on a card sees it
    kernels = [u2.state(pr).float_full]
    assert u2.ready(pr, kernels, "interp") is False
    with pytest.raises(RuntimeError, match="nvcc"):
        for _ in range(400):
            u2.ready(pr, kernels, "interp")
            time.sleep(0.01)
    with pytest.raises(RuntimeError, match="nvcc"):
        u2.ready(pr, kernels, "block")


# ----------------------------------------------------------------------
# gradients

N = 64
H_FD = 1e-2


@pytest.fixture(scope="module")
def circle():
    tape, cx, rv = _circle(ref)
    return tape, port_tape_with_vars(tape), cx, rv


def _jvp_port(fn, vec, dvec):
    img, tang = torch.func.jvp(fn, (torch.from_numpy(vec),),
                               (torch.from_numpy(dvec),))
    return img.detach().numpy(), tang.detach().numpy()


def _fd_check(f, vec, dvec, tang):
    fd = (f(vec + H_FD * dvec) - f(vec - H_FD * dvec)) / (2 * H_FD)
    yy, xx = np.mgrid[0:N, 0:N]
    m = np.isfinite(fd) & ((xx - N / 2) ** 2 + (yy - N / 2) ** 2 > 49)
    assert m.mean() > 0.9
    np.testing.assert_allclose(tang[m], fd[m], rtol=2e-2, atol=2e-3)


def test_dense_gradients_vs_fd_and_reference(circle):
    """tests/test_grad_parity.py:88 on the port: pixel tangents of the
    dense frame against central differences (d/dr = -1) and the
    reference's jax.jvp of its dense frame (rtol 1e-5, atol 1e-6);
    reverse mode equal to forward mode."""
    rtape, ptape, cx, rv = circle
    r = port.PixelRenderer(ptape, port.ImageSize(N, N), device="cpu")
    mat = r._mat4(None)
    vec = _vec(rtape, cx, rv, 0.1, 0.5)
    f = lambda v: r._dense(mat, 0.0, v)
    fn = lambda v: f(torch.from_numpy(v)).numpy()
    rr = ref_r2d.PixelRenderer(rtape, RefImageSize(N, N), interpret=True)
    rr.render_dense(vars={cx: 0.1, rv: 0.5})
    for dv in ((0.0, 1.0), (1.0, 0.0), (0.7, -0.3)):
        dvec = _vec(rtape, cx, rv, *dv)
        img, tang = _jvp_port(f, vec, dvec)
        _fd_check(fn, vec, dvec, tang)
        if dv == (0.0, 1.0):
            assert abs(np.median(tang) + 1.0) < 1e-4
        w_img, w_tang = jax.jvp(
            lambda v: rr._dense_jit(jnp.asarray(mat), jnp.float32(0.0), v),
            (jnp.asarray(vec),), (jnp.asarray(dvec),))
        np.testing.assert_allclose(img, np.asarray(w_img), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(tang, np.asarray(w_tang), rtol=1e-5,
                                   atol=1e-6)
    v = torch.from_numpy(vec).requires_grad_()
    (f(v) ** 2).sum().backward()
    g_fwd = torch.func.jacfwd(lambda v: (f(v) ** 2).sum())(
        torch.from_numpy(vec))
    np.testing.assert_allclose(v.grad.numpy(), g_fwd.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_unrolled_frame_gradients_vs_fd_and_reference(circle):
    """tests/test_grad_parity.py:169 on the port: the pixel_perfect
    tiled-unrolled frame at 16-px tiles, tangents against central
    differences and the reference's `_frame_unrolled_fn` under jax.jvp;
    without pixel_perfect, proven fills carry no tangent."""
    rtape, ptape, cx, rv = circle
    r = port.PixelRenderer(ptape, port.ImageSize(N, N), device="cpu")
    mat = r._mat4(None)
    vec = _vec(rtape, cx, rv, 0.1, 0.5)
    dvec = _vec(rtape, cx, rv, 0.7, -0.3)
    T0 = 16
    f = lambda v: r._frame_unrolled(mat, 0.0, v, tile_size=T0,
                                    pixel_perfect=True)[0][:N, :N]
    img, tang = _jvp_port(f, vec, dvec)
    _fd_check(lambda v: f(torch.from_numpy(v)).numpy(), vec, dvec, tang)

    rr = ref_r2d.PixelRenderer(rtape, RefImageSize(N, N), interpret=True)
    key = id(rr.tape)
    ref_r2d._register_tape(key, lambda: (rr.tape, rr.packed_b, rr.axis_of,
                                         rr.nf_b, rr.cw_b))
    n0x = N // T0
    fn = ref_r2d._frame_unrolled_fn(key, T0, n0x, n0x, n0x * n0x,
                                    rr.n_inputs, True, True)
    gx, gy = np.meshgrid(np.arange(n0x, dtype=np.float32) * T0,
                         np.arange(n0x, dtype=np.float32) * T0)
    w_img, w_tang = jax.jvp(
        lambda v: fn(jnp.asarray(gx.reshape(-1)), jnp.asarray(gy.reshape(-1)),
                     jnp.asarray(mat), jnp.float32(0.0), v)[0][:N, :N],
        (jnp.asarray(vec),), (jnp.asarray(dvec),))
    np.testing.assert_allclose(img, np.asarray(w_img), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tang, np.asarray(w_tang), rtol=1e-5,
                               atol=1e-6)

    vec2 = _vec(rtape, cx, rv, 0.1, 0.8)
    dvec2 = _vec(rtape, cx, rv, 0.0, 1.0)
    _, tang2 = _jvp_port(
        lambda v: r._frame_unrolled(mat, 0.0, v, tile_size=T0)[0][:N, :N],
        vec2, dvec2)
    fill = r._frame_unrolled(mat, 0.0, vec2, tile_size=T0)[1][:N, :N].numpy()
    ev = fill == FILL_NONE
    assert ev.any() and (~ev).any()
    np.testing.assert_allclose(tang2[ev], -1.0, rtol=1e-4, atol=1e-4)
    assert (tang2[~ev] == 0).all()


def test_union_frame_reverse_equals_forward(circle):
    """The union frame's leaf (its programs and the fallback in one U1
    call) is differentiable too: backward() equals torch.func.jacfwd."""
    rtape, ptape, cx, rv = circle
    r = port.PixelRenderer(ptape, port.ImageSize(N, N), device="cpu")
    vec = _vec(rtape, cx, rv, 0.1, 0.5)
    from fidget_tpu_torch.compiler.unions import build_union_plan

    plan = build_union_plan(ptape, 8, 8, 8, r._mat4(None), 0.0, vec,
                            r.axis_of, block_px=16)
    mat, z, _ = u2._device_args(r, r._mat4(None), 0.0, vec)

    def loss(v):
        img = u2.frame_union(r, plan, 128, False, mat, z, v)[0]
        return (img ** 2).sum()

    v = torch.from_numpy(vec).requires_grad_()
    loss(v).backward()
    g_fwd = torch.func.jacfwd(loss)(torch.from_numpy(vec))
    np.testing.assert_allclose(v.grad.numpy(), g_fwd.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert v.grad.abs().sum() > 0


@pytest.mark.parametrize("frame", ["dense", "unrolled", "union"])
def test_frame_reverse_over_the_whole_var_vector(circle, frame):
    """backward() of sum(img^2) over every entry of the var vector, the
    axis entries included, against the reference's jax.grad (rtol 1e-5,
    atol 1e-6): the transform overwrites the axis entries, so their
    gradient is exactly 0. The pixel_perfect union frame evaluates every
    pixel, so it is held to the dense frame's reference."""
    rtape, ptape, cx, rv = circle
    r = port.PixelRenderer(ptape, port.ImageSize(N, N), device="cpu")
    mat = r._mat4(None)
    vec = _vec(rtape, cx, rv, 0.1, 0.5)
    T0 = 16 if frame == "unrolled" else 8
    rr = ref_r2d.PixelRenderer(rtape, RefImageSize(N, N), interpret=True)
    if frame == "unrolled":
        f = lambda v: r._frame_unrolled(mat, 0.0, v, tile_size=T0,
                                        pixel_perfect=True)[0][:N, :N]
        key = id(rr.tape)
        ref_r2d._register_tape(key, lambda: (rr.tape, rr.packed_b,
                                             rr.axis_of, rr.nf_b, rr.cw_b))
        n0x = N // T0
        fn = ref_r2d._frame_unrolled_fn(key, T0, n0x, n0x, n0x * n0x,
                                        rr.n_inputs, True, True)
        gx, gy = np.meshgrid(np.arange(n0x, dtype=np.float32) * T0,
                             np.arange(n0x, dtype=np.float32) * T0)
        w = lambda v: fn(jnp.asarray(gx.reshape(-1)),
                         jnp.asarray(gy.reshape(-1)), jnp.asarray(mat),
                         jnp.float32(0.0), v)[0][:N, :N]
    else:
        if frame == "dense":
            f = lambda v: r._dense(mat, 0.0, v)
        else:
            from fidget_tpu_torch.compiler.unions import build_union_plan

            plan = build_union_plan(ptape, T0, N // T0, N // T0, mat, 0.0,
                                    vec, r.axis_of, block_px=16)
            m_t, z_t, _ = u2._device_args(r, mat, 0.0, vec)
            f = lambda v: u2.frame_union(r, plan, 128, True, m_t, z_t,
                                         v)[0][:N, :N]
        rr.render_dense(vars={cx: 0.1, rv: 0.5})
        w = lambda v: rr._dense_jit(jnp.asarray(mat), jnp.float32(0.0), v)
    v = torch.from_numpy(vec).requires_grad_()
    (f(v) ** 2).sum().backward()
    want = np.asarray(jax.grad(lambda v: (w(v) ** 2).sum())(jnp.asarray(vec)))
    axes = [rtape.var_map[ref.Var.X], rtape.var_map[ref.Var.Y]]
    assert (v.grad.numpy()[axes] == 0).all()
    assert (want[axes] == 0).all()
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.abs(want).sum() > 0


def test_unrolled_modules_import_no_jax():
    """The path's modules import neither JAX nor fidget_tpu."""
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, fidget_tpu_torch.render.unrolled2d, "
        "fidget_tpu_torch.eval.unrolled_cuda, "
        "fidget_tpu_torch.eval.unrolled_fast, "
        "fidget_tpu_torch.compiler.unions\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fidget_tpu' or m.startswith('fidget_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
