"""The port's 2D frame against fidget_tpu's, stage by stage, on the CPU.

`PixelRenderer(device="cpu")` runs the plain PyTorch versions of the
kernels. The reference runs the same frame (`_frame_core` under
`_TracedBind`, with and without the coded leaf, and under `_ConstBind`
for `specialize=True` and two-level tiles) with its Pallas kernels in
interpret mode. Every stage that `stop_after` exposes is compared:
root intervals allclose and choice words exact; action codes exact;
simplified tape lengths and words exact; leaf distances allclose; then
the whole frame with fills exact and distances allclose where they
were evaluated, and occupancy equal to the port's `render_brute`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.render import render2d as ref_r2d

import fidget_tpu_torch as port
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.render.render2d import FILL_INSIDE, FILL_NONE, FILL_OUTSIDE
from test_torch_compiler import SHAPES, port_tape_from_ref

#: a pan and zoom of the view, so tiles straddle the shapes differently
PAN = np.array([[1.3, 0.0, 0.21], [0.0, 1.3, -0.17], [0.0, 0.0, 1.0]])


def _reference_stages(r, world_to_model):
    """Every stage of the reference's bucketed single-level frame, run
    eagerly (the Pallas kernels compile once per shape and are reused
    across stages)."""
    p = r.packed_b
    b = ref_r2d._TracedBind(
        jnp.asarray(p.w1), jnp.asarray(p.w2), jnp.asarray(p.imm),
        jnp.asarray(p.lengths), jnp.asarray(r.axis_idx), r.Lcap_b, r.nf_b,
        r.n_inputs, r.cw_b, True, False,
    )
    args = (
        b, r.T0, r.T0, r.n0x, jnp.asarray(r.tile_x0), jnp.asarray(r.tile_y0),
        jnp.asarray(r._mat4(world_to_model)), jnp.float32(0.0),
        jnp.asarray(r._var_vec(None)),
    )
    return {
        stage: tuple(
            np.asarray(a)
            for a in ref_r2d._frame_core(
                *args, pixel_perfect=False, stop_after=stage
            )
        )
        for stage in ("root", "codes", "simplify", "leaf", None)
    }


def _port_stages(r, world_to_model):
    mat, vec = r._mat4(world_to_model), r._var_vec(None)
    return {
        stage: tuple(
            a.numpy() for a in r._frame(mat, 0.0, vec, stop_after=stage)
        )
        for stage in ("root", "codes", "simplify", "leaf", None)
    }


CASES = [
    ("circle", 128, None),
    ("spiky", 128, PAN),
    ("union", 128, None),
    ("union", 256, PAN),
]


@pytest.mark.parametrize(
    "name,n,view", CASES,
    ids=[f"{c[0]}-{c[1]}-{'pan' if c[2] is not None else 'id'}" for c in CASES],
)
def test_frame_matches_reference_stage_by_stage(name, n, view):
    ctx = ref.Context()
    t_ref = ref.lower(ctx, [SHAPES[name](ctx)])
    size = ref.ImageSize(n, n)
    rr = ref_r2d.PixelRenderer(t_ref, size, tile_size=64, interpret=True)
    pr = port.PixelRenderer(
        port_tape_from_ref(t_ref), port.ImageSize(n, n), tile_size=64,
        device="cpu",
    )
    for attr in ("Lcap_b", "nf_b", "cw_b", "n0", "s0r", "s0l", "n_inputs"):
        assert getattr(pr, attr) == getattr(rr, attr), attr
    want = _reference_stages(rr, view)
    got = _port_stages(pr, view)

    rlo_g, ch_g = got["root"]
    rlo_w, ch_w = want["root"]
    np.testing.assert_allclose(rlo_g, rlo_w, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ch_g, ch_w)

    for g, w in zip(got["codes"], want["codes"]):
        np.testing.assert_array_equal(g, w)
    active = got["codes"][1]
    assert active.any()

    for g, w in zip(got["simplify"], want["simplify"]):
        np.testing.assert_array_equal(g, w)

    (dist_g,), (dist_w,) = got["leaf"], want["leaf"]
    np.testing.assert_allclose(
        dist_g[active], dist_w[active], rtol=1e-5, atol=1e-6
    )

    img_g, fill_g = got[None]
    img_w, fill_w = want[None]
    np.testing.assert_array_equal(fill_g, fill_w)
    ev = fill_g == FILL_NONE
    np.testing.assert_allclose(img_g[ev], img_w[ev], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["spiky", "union"])
def test_render_matches_brute(name):
    """The public entry point on the CPU: occupancy equal to the port's
    numpy oracle, distances allclose where evaluated, fills
    conservative, and no kernel launched (32-px tiles, so some tiles
    are proven inside or outside)."""
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES[name](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(192, 128), tile_size=32,
                           device="cpu")
    cuda.reset_launches()
    img = r.render(PAN)
    assert cuda.LAUNCHES == {k: 0 for k in cuda.KERNELS}
    brute = r.render_brute(PAN)
    dist, fill = img.distance.numpy(), img.fill.numpy()
    assert dist.shape == fill.shape == brute.shape == (128, 192)
    assert fill.dtype == np.int8
    ev = fill == FILL_NONE
    np.testing.assert_allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6)
    assert (brute[fill == FILL_INSIDE] < 0).all()
    assert (brute[fill == FILL_OUTSIDE] > 0).all()
    np.testing.assert_array_equal(img.inside().numpy(), brute < 0)
    assert (fill != FILL_NONE).any() and ev.any()


def test_pixel_perfect_evaluates_every_pixel():
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["circle"](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(128, 128), tile_size=64,
                           device="cpu")
    img = r.render(pixel_perfect=True)
    assert (img.fill == FILL_NONE).all()
    np.testing.assert_allclose(
        img.distance.numpy(), r.render_brute(), rtol=1e-5, atol=1e-6
    )


def test_module_render_and_vm_route():
    """Reference .vm text through the port's parser and `lower`, into
    the module-level entry point, against the reference's oracle."""
    ctx = ref.Context()
    text = ctx.export(SHAPES["spiky"](ctx))
    pc, proot = port.Context.from_text(text)
    img = port.render2d(
        port.lower(pc, [proot]), port.ImageSize(128, 128), tile_size=64,
        device="cpu",
    )
    rc, rroot = ref.Context.from_text(text)
    rr = ref_r2d.PixelRenderer(
        ref.lower(rc, [rroot]), ref.ImageSize(128, 128), tile_size=64,
        interpret=True,
    )
    np.testing.assert_array_equal(img.inside().numpy(), rr.render_brute() < 0)


def test_image_stays_on_the_render_device():
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["circle"](ctx)])
    img = port.PixelRenderer(
        tape, port.ImageSize(64, 64), device="cpu"
    ).render()
    assert isinstance(img.distance, torch.Tensor)
    assert img.distance.device.type == "cpu"
    assert img.distance.dtype == torch.float32


def test_fired_cancel_token_stops_the_frame():
    from fidget_tpu_torch.render.config import CancelToken, RenderCancelled

    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["circle"](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(64, 64), device="cpu")
    token = CancelToken()
    assert r.render(cancel=token).inside().any()
    token.cancel()
    with pytest.raises(RenderCancelled):
        r.render(cancel=token)


# ----------------------------------------------------------------------
# the other three tape bindings: coded leaf, per-shape arena, two levels


def _leaf_active(fill, T0, T1, n0x, n0y):
    """Which leaf instances were evaluated, in leaf order, read off the
    assembled fill image."""
    r = T0 // T1
    corner = fill[::T1, ::T1].reshape(n0y, r, n0x, r)
    return corner.transpose(0, 2, 1, 3).reshape(-1) == FILL_NONE


def _compare_stages(got, want, active_leaf):
    """Root intervals allclose, choice words exact; the "codes" and
    "simplify" stages exact where present; leaf distances allclose on
    evaluated leaves; fills (level tags included) exact and distances
    allclose where evaluated."""
    rlo_g, ch_g = got["root"]
    rlo_w, ch_w = want["root"]
    np.testing.assert_allclose(rlo_g, rlo_w, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ch_g, ch_w)
    for stage in ("codes", "simplify"):
        if stage in got:
            for g, w in zip(got[stage], want[stage]):
                np.testing.assert_array_equal(g, w, err_msg=stage)
    (dist_g,), (dist_w,) = got["leaf"], want["leaf"]
    assert active_leaf.any()
    np.testing.assert_allclose(
        dist_g[active_leaf], dist_w[active_leaf], rtol=1e-5, atol=1e-6
    )
    img_g, fill_g = got[None]
    img_w, fill_w = want[None]
    np.testing.assert_array_equal(fill_g, fill_w)
    ev = fill_g == FILL_NONE
    np.testing.assert_allclose(img_g[ev], img_w[ev], rtol=1e-5, atol=1e-6)


def _check_against_brute(pr, view, img, fill):
    """Occupancy equal to `render_brute`, fills conservative."""
    brute = pr.render_brute(view)
    img, fill = img[: pr.H, : pr.W], fill[: pr.H, : pr.W]
    cls = np.where(fill == FILL_NONE, fill, (fill - 1) % 2 + 1)
    assert (brute[cls == FILL_INSIDE] < 0).all()
    assert (brute[cls == FILL_OUTSIDE] > 0).all()
    occ = np.where(cls == FILL_NONE, img < 0, cls == FILL_INSIDE)
    np.testing.assert_array_equal(occ, brute < 0)


CODED_CASES = [("spiky", 128, PAN), ("union", 128, PAN)]


@pytest.mark.parametrize(
    "name,n,view", CODED_CASES, ids=[f"{c[0]}-{c[1]}" for c in CODED_CASES]
)
def test_coded_leaf_frame_matches_reference_stage_by_stage(name, n, view):
    """`_frame(..., leaf_coded=True)` against the reference's
    `_TracedBind(..., leaf_coded=True)`: K6 over the shared tape in
    place of child tapes and K3; also bit-equal to the port's standard
    frame where evaluated."""
    ctx = ref.Context()
    t_ref = ref.lower(ctx, [SHAPES[name](ctx)])
    rr = ref_r2d.PixelRenderer(t_ref, ref.ImageSize(n, n), tile_size=64,
                               interpret=True)
    pr = port.PixelRenderer(
        port_tape_from_ref(t_ref), port.ImageSize(n, n), tile_size=64,
        device="cpu",
    )
    p = rr.packed_b
    stages = ("root", "codes", "leaf", None)
    want = {}
    for stage in stages:
        b = ref_r2d._TracedBind(
            jnp.asarray(p.w1), jnp.asarray(p.w2), jnp.asarray(p.imm),
            jnp.asarray(p.lengths), jnp.asarray(rr.axis_idx), rr.Lcap_b,
            rr.nf_b, rr.n_inputs, rr.cw_b, True, True,
        )
        want[stage] = tuple(np.asarray(a) for a in ref_r2d._frame_core(
            b, rr.T0, rr.T0, rr.n0x, jnp.asarray(rr.tile_x0),
            jnp.asarray(rr.tile_y0), jnp.asarray(rr._mat4(view)),
            jnp.float32(0.0), jnp.asarray(rr._var_vec(None)),
            pixel_perfect=False, stop_after=stage,
        ))
    mat, vec = pr._mat4(view), pr._var_vec(None)
    got = {
        stage: tuple(a.numpy() for a in pr._frame(
            mat, 0.0, vec, stop_after=stage, leaf_coded=True))
        for stage in stages
    }
    active = _leaf_active(got[None][1], pr.T0, pr.T1, pr.n0x, pr.n0y)
    _compare_stages(got, want, active)
    img_s, fill_s = (a.numpy() for a in pr._frame(mat, 0.0, vec))
    np.testing.assert_array_equal(fill_s, got[None][1])
    ev = fill_s == FILL_NONE
    np.testing.assert_array_equal(img_s[ev].view(np.uint32),
                                  got[None][0][ev].view(np.uint32))
    _check_against_brute(pr, view, *got[None])


CONST_CASES = [
    ("spiky", 128, PAN, dict(tile_size=64, specialize=True)),
    ("union", 128, PAN, dict(tile_size=64, specialize=True)),
    ("spiky", 128, None, dict(tile_sizes=(64, 16))),
    ("union", 256, PAN, dict(tile_sizes=(64, 16))),
    ("union", 256, PAN, dict(tile_sizes=(128, 32))),
]


@pytest.mark.parametrize(
    "name,n,view,opts", CONST_CASES,
    ids=[
        f"{c[0]}-{c[1]}-" + ("specialize" if "specialize" in c[3] else
                             "x".join(str(t) for t in c[3]["tile_sizes"]))
        for c in CONST_CASES
    ],
)
def test_per_shape_frame_matches_reference_stage_by_stage(name, n, view, opts):
    """`specialize=True` and two-level tiles (`_ConstBind`: the arena at
    the tape's own length under the shape's op_order) against the
    reference's `_frame_tiles(stop_after=...)`: arenas and orders exact,
    every stage as in `_compare_stages`, occupancy equal to
    `render_brute`."""
    ctx = ref.Context()
    t_ref = ref.lower(ctx, [SHAPES[name](ctx)])
    rr = ref_r2d.PixelRenderer(t_ref, ref.ImageSize(n, n), interpret=True,
                               **opts)
    pr = port.PixelRenderer(
        port_tape_from_ref(t_ref), port.ImageSize(n, n), device="cpu", **opts
    )
    assert pr.op_order == rr.op_order
    from fidget_tpu.eval.pallas_interp import tape_n_ops as ref_tape_n_ops

    assert pr.nops_s == ref_tape_n_ops(t_ref, rr.op_order)
    for attr in ("T0", "T1", "m", "n0", "nc", "s0r", "s0s", "s0l", "nf",
                 "c_words", "two_level"):
        assert getattr(pr, attr) == getattr(rr, attr), attr
    for f in ("w1", "w2", "imm", "lengths"):
        np.testing.assert_array_equal(
            getattr(pr.packed, f), getattr(rr.packed, f), err_msg=f
        )
    stages = ("root", "simplify", "leaf", None)
    rargs = (
        jnp.asarray(rr._mat4(view)), jnp.float32(0.0),
        jnp.asarray(rr._var_vec(None)), jnp.asarray(rr.tile_x0),
        jnp.asarray(rr.tile_y0),
    )
    want = {
        stage: tuple(np.asarray(a) for a in rr._frame_tiles(
            *rargs, pixel_perfect=False, stop_after=stage))
        for stage in stages
    }
    mat, vec = pr._mat4(view), pr._var_vec(None)
    got = {
        stage: tuple(a.numpy() for a in pr._frame(mat, 0.0, vec,
                                                  stop_after=stage))
        for stage in stages
    }
    img, fill = got[None]
    active = _leaf_active(fill, pr.T0, pr.T1, pr.n0x, pr.n0y)
    _compare_stages(got, want, active)
    _check_against_brute(pr, view, img, fill)
    if pr.two_level:
        # subtile proofs carry level tag 1
        assert ((fill == FILL_INSIDE + 2) | (fill == FILL_OUTSIDE + 2)).any()
    else:
        # the per-shape single-level frame equals the bucketed one
        pb = port.PixelRenderer(pr.tape, port.ImageSize(n, n), tile_size=64,
                                device="cpu")
        img_b, fill_b = (a.numpy() for a in pb._frame(mat, 0.0, vec))
        np.testing.assert_array_equal(fill, fill_b)
        ev = fill == FILL_NONE
        np.testing.assert_array_equal(img[ev].view(np.uint32),
                                      img_b[ev].view(np.uint32))


@pytest.mark.parametrize(
    "opts", [dict(tile_size=32, specialize=True), dict(tile_sizes=(64, 16)),
             dict(tile_sizes=(128, 32))],
    ids=["specialize", "64x16", "128x32"],
)
def test_render_options_match_brute(opts):
    """The public entry point with each new option on the CPU, at a size
    that is no multiple of the tiles: occupancy equal to `render_brute`,
    distances allclose where evaluated, fills conservative, level tags
    read by `fill_level`, and no kernel launched."""
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["union"](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(200, 136), device="cpu", **opts)
    cuda.reset_launches()
    img = r.render(PAN)
    assert cuda.LAUNCHES == {k: 0 for k in cuda.KERNELS}
    brute = r.render_brute(PAN)
    dist, fill = img.distance.numpy(), img.fill.numpy()
    assert dist.shape == fill.shape == brute.shape == (136, 200)
    ev = fill == FILL_NONE
    np.testing.assert_allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6)
    cls = img.fill_class().numpy()
    assert (brute[cls == FILL_INSIDE] < 0).all()
    assert (brute[cls == FILL_OUTSIDE] > 0).all()
    np.testing.assert_array_equal(img.inside().numpy(), brute < 0)
    levels = set(np.unique(img.fill_level().numpy()).tolist())
    assert levels == ({-1, 0, 1} if r.two_level else {-1, 0})


def test_pixel_perfect_two_level_evaluates_every_pixel():
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["spiky"](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(128, 128), tile_sizes=(64, 16),
                           device="cpu")
    img = r.render(PAN, pixel_perfect=True)
    assert (img.fill == FILL_NONE).all()
    np.testing.assert_allclose(
        img.distance.numpy(), r.render_brute(PAN), rtol=1e-5, atol=1e-6
    )


@pytest.mark.parametrize("opts", [dict(), dict(tile_sizes=(64, 16))],
                         ids=["bucketed", "64x16"])
def test_render_shape_with_transform_and_vars(opts):
    """A `Shape` with a transform and a bound `ShapeVars` variable (the
    counterpart of tests/test_render2d.py): the transform is applied
    after the view, the variable is read from `vars`."""
    r_var = port.Var.new()
    x, y, _ = port.Tree.axes()
    tree = (x.square() + y.square()).sqrt() - port.Tree.var(r_var)
    # shrink the model 2x: the world-space radius doubles
    shape = port.Shape.from_tree(tree).apply_transform(
        np.diag([0.5, 0.5, 0.5, 1.0])
    )
    pr = port.PixelRenderer(shape, port.ImageSize(128, 128), device="cpu",
                            **opts)
    sv = port.ShapeVars({r_var: 0.4})
    img = pr.render(vars=sv)
    brute = pr.render_brute(vars=sv)
    ev = img.fill.numpy() == FILL_NONE
    np.testing.assert_allclose(
        img.distance.numpy()[ev], brute[ev], rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(img.inside().numpy(), brute < 0)
    # radius 0.4 in model space = 0.8 world: circle area / [-1, 1]^2 area
    frac = float(img.inside().float().mean())
    assert abs(frac - np.pi * 0.8**2 / 4.0) < 0.01
    img2 = port.render2d(shape, port.ImageSize(128, 128), vars={r_var: 0.4},
                         device="cpu", **opts)
    assert torch.equal(img2.fill, img.fill)


def test_render_shape_unbound_var_raises():
    x, y, _ = port.Tree.axes()
    tree = (x.square() + y.square()).sqrt() - port.Tree.var(port.Var.new())
    pr = port.PixelRenderer(port.Shape.from_tree(tree), port.ImageSize(64, 64),
                            device="cpu")
    with pytest.raises(ValueError, match="unbound"):
        pr.render()


def test_tile_size_checks():
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["circle"](ctx)])
    size = port.ImageSize(128, 128)
    with pytest.raises(ValueError, match="either"):
        port.PixelRenderer(tape, size, tile_size=64, tile_sizes=(64, 16),
                           device="cpu")
    with pytest.raises(ValueError, match="one or two"):
        port.PixelRenderer(tape, size, tile_sizes=(128, 64, 16), device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        port.PixelRenderer(tape, size, tile_sizes=(64, 48), device="cpu")
    with pytest.raises(ValueError, match="128-lane"):
        port.PixelRenderer(tape, size, tile_sizes=(64, 8), device="cpu")
    r = port.PixelRenderer(tape, size, tile_sizes=(64, 16), device="cpu")
    with pytest.raises(ValueError, match="coded leaf"):
        r._frame(r._mat4(None), 0.0, r._var_vec(None), leaf_coded=True)


@pytest.mark.parametrize("name", ["spiky", "union"])
@pytest.mark.parametrize(
    "binding", ["bucketed", "coded", "two-level"],
)
def test_register_file_sized_by_the_tape_equals_the_bucket(binding, name,
                                                           monkeypatch):
    """K1, K3 and K6 are launched with the registers the tape can name,
    not the bucket's 64: the frame is the same bit for bit (fills,
    distances, every stage the binding exposes), K2 keeps the bucket's
    nf, and the value kernels really are handed the small file."""
    from fidget_tpu_torch.render import render2d

    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES[name](ctx)])
    opts = dict(tile_sizes=(64, 16)) if binding == "two-level" else dict(
        tile_size=32)
    seen = {}
    for fn in ("interp_interval", "interp_float", "interp_float_coded"):
        def spy(*a, _fn=getattr(render2d, fn), _name=fn, **kw):
            seen.setdefault(_name, set()).add(kw["nf"])
            return _fn(*a, **kw)
        monkeypatch.setattr(render2d, fn, spy)

    def frames(nf_regs):
        r = port.PixelRenderer(tape, port.ImageSize(128, 128), device="cpu",
                               **opts)
        assert r._nf_regs == r.nf == tape.reg_count + tape.mem_count < r.nf_b
        if nf_regs == "bucket":
            r._nf_regs = r.nf_b
        mat, vec = r._mat4(PAN), r._var_vec(None)
        stages = ["root", "codes", "leaf", None]
        if binding != "coded":
            stages.insert(2, "simplify")
        seen.clear()
        out = {
            stage: tuple(
                None if a is None else a.numpy()
                for a in r._frame(mat, 0.0, vec, stop_after=stage,
                                  leaf_coded=binding == "coded")
            )
            for stage in stages
        }
        return r, out, {k: set(v) for k, v in seen.items()}

    r, small, nf_small = frames("tape")
    _, large, nf_large = frames("bucket")
    leaf = "interp_float_coded" if binding == "coded" else "interp_float"
    assert nf_small["interp_interval"] == {r.nf}
    assert nf_large["interp_interval"] == {r.nf_b}
    assert nf_small[leaf] == {r.nf} and nf_large[leaf] == {r.nf_b}
    for stage, got in small.items():
        for g, w in zip(got, large[stage]):
            if g is None:
                assert w is None
                continue
            same = g.view(np.uint32) == w.view(np.uint32) if (
                g.dtype == np.float32) else g == w
            assert same.all(), (stage, binding)
    img, fill = small[None]
    _check_against_brute(r, PAN, img, fill)


@pytest.mark.parametrize("name", ["spiky", "union"])
def test_coded_frame_at_the_tapes_registers_equals_the_bucketed_frame(
        name, monkeypatch):
    """The coded leaf (K6) at the tape's registers gives the bucketed
    frame's fills, and its distances bit for bit where a pixel was
    evaluated, under the same view."""
    from fidget_tpu_torch.render import render2d

    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES[name](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(128, 128), tile_size=32,
                           device="cpu")
    seen = []
    coded = render2d.interp_float_coded

    def spy(*a, **kw):
        seen.append(kw["nf"])
        return coded(*a, **kw)

    monkeypatch.setattr(render2d, "interp_float_coded", spy)
    mat, vec = r._mat4(PAN), r._var_vec(None)
    img, fill = r._frame(mat, 0.0, vec, leaf_coded=True)
    std = r.render(PAN)
    assert seen == [r.nf] and r.nf < r.nf_b
    img, fill = img[: r.H, : r.W], fill[: r.H, : r.W]
    assert torch.equal(fill, std.fill)
    ev = std.fill == FILL_NONE
    assert ev.any()
    assert torch.equal(img[ev].view(torch.int32),
                       std.distance[ev].view(torch.int32))
