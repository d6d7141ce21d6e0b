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


def test_emitter_one_statement_per_row(monkeypatch):
    """One statement per tape row in U1's program and in U2's body, the
    latter cut into chunks of INTERVAL_CHUNK_ROWS rows, each a unit of
    its own, which the kernel unit calls in order."""
    t = _small_tape()
    axis = {v.kind: i for v, i in t.var_map.items()}
    prog = uc.emit_float_program(t, 2, "f")
    body = prog.split("float o = 0.f;\n")[1].split("  return o;")[0]
    assert len(body.strip().splitlines()) == len(t)
    monkeypatch.setattr(uc, "INTERVAL_CHUNK_ROWS", 5)
    chunks = uc.interval_chunks(t)
    assert [len(c) for c in chunks[:-1]] == [5] * (len(chunks) - 1)
    rows = [r for c in chunks for r in c]
    assert len(rows) == len(t) and len(chunks) == -(-len(t) // 5)
    # every choice lands in its word; the last one closes the last word
    text = "\n".join(rows)
    assert text.count("U_CHOICE(") == t.choice_count
    assert text.count("U_WORD(") == -(-t.choice_count // 16)
    unit = uc.IntervalKernel(t, axis, 2, "violation").unit()
    assert len(unit.objects) == len(chunks)
    calls = [line.split("(")[0].strip() for line in unit.source.splitlines()
             if line.startswith("  fidget_uiv_")]
    assert calls == [f"fidget_uiv_{o.key}" for o in unit.objects]
    for o, c in zip(unit.objects, chunks):
        assert f"U_CHUNK_BEGIN(fidget_uiv_{o.key})" in o.source
        assert all(r in o.source for r in c)


def test_emitter_sources_and_keys():
    """The same tape gives the same source and key; a changed tape,
    epilogue or template changes the key."""
    t = _small_tape()
    axis = {v.kind: i for v, i in t.var_map.items()}

    def keys(tape, epilogue="proofs"):
        fk = uc.FloatKernel([tape], axis, 2).unit()
        ik = uc.IntervalKernel(tape, axis, 2, epilogue).unit()
        return fk.key, fk.objects[0].key, fk.source, ik.key, ik.source

    a, b = keys(t), keys(_small_tape())
    assert a == b
    t2 = _small_tape()
    t2.imm[np.nonzero(t2.imm)[0][0]] += 0.5
    c = keys(t2)
    assert c[0] != a[0] and c[1] != a[1] and c[3] != a[3]
    assert keys(t, "capture")[3] != a[3]
    assert keys(t, "violation")[3] != keys(t, "capture")[3]


def test_template_change_changes_keys(monkeypatch, tmp_path):
    """The key hashes the template's bytes: an edited copy of it gives
    every unit a new key."""
    t = _small_tape()
    axis = {v.kind: i for v, i in t.var_map.items()}
    before = uc.IntervalKernel(t, axis, 2, "proofs").unit().key
    prog = uc.FloatKernel([t], axis, 2).unit().objects[0].key
    assert uc.TEMPLATE in uc.SOURCES
    edited = tmp_path / uc.TEMPLATE.name
    edited.write_bytes(uc.TEMPLATE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(uc, "SOURCES", tuple(
        edited if p == uc.TEMPLATE else p for p in uc.SOURCES))
    assert uc.IntervalKernel(t, axis, 2, "proofs").unit().key != before
    assert uc.FloatKernel([t], axis, 2).unit().objects[0].key != prog


def test_union_programs_share_objects():
    """A union kernel's programs are objects of their own, keyed by
    tape: the full-tape fallback is the same object as the full leaf's
    program, and every program is named by its key."""
    _, pr = _pair("union", 128)
    pr.render_unrolled(leaf="union", block_px=32)
    st = u2.state(pr)
    plan = st.plans[(8, 32)]
    kern = u2.union_tables(pr, plan, 128).kernel
    unit = kern.unit()
    assert len(unit.objects) == len(plan.programs) + 1
    assert unit.objects[-1].key == st.float_full.unit().objects[0].key
    for o in unit.objects:
        assert f"fidget_uprog_{o.key}" in o.source
        assert f"fidget_uprog_{o.key}" in unit.source


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
