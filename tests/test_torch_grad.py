"""Shape-parameter gradients of the port against fidget_tpu's, on the CPU.

`interp_float` is a `torch.autograd.Function` (`_FloatDiff`): its
Jacobian comes from the dual-number pass (K4; on the CPU its plain
version), non-finite partials read as 0, and `backward` / `jvp`
contract it. The reference's custom JVP does the same through its
Pallas kernels, here in interpret mode. Held to each other on the
op-matrix tapes of tests/test_kernel_ops.py and on the circle of
tests/test_grad_parity.py (rtol 1e-5, atol 1e-6), then through the 2D
frame: pixel tangents against central finite differences and against
the reference's `jax.jvp`, fills without a tangent, and reverse mode
equal to forward mode (`torch.func.jacfwd` and dual tensors) and to
the reference's `jax.grad`. Interval
proofs (K1) and voxel depths (K5) carry no gradient; the coded leaf
(K6) has none and raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import fidget_tpu as ref
from fidget_tpu.compiler.pack import pack_tapes as ref_pack_tapes
from fidget_tpu.core.var import Var as RefVar
from fidget_tpu.eval import pallas_interp as ref_interp
from fidget_tpu.render.render2d import FILL_NONE as REF_FILL_NONE
from fidget_tpu.render.render2d import PixelRenderer as RefPixelRenderer
from fidget_tpu.render.region import ImageSize as RefImageSize

import fidget_tpu_torch as port
from fidget_tpu_torch.compiler.pack import pack_tapes
from fidget_tpu_torch.eval import interp
from fidget_tpu_torch.render.render2d import FILL_NONE
from test_torch_compiler import port_tape_from_ref
from test_torch_kernels import CASES

S0 = 8
N = 64
H_FD = 1e-2
#: ops the reference's kernels compute with their own polynomials
#: (eval/softmath.py), whose values differ from the port's by more than
#: 1e-5; their tangents are algebraic in the inputs and are compared
SOFTMATH = ("ATAN", "ASIN", "ACOS", "ATAN2", "MOD")


def _arena_t(packed):
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a))
        for a in (packed.w1, packed.w2, packed.imm, packed.lengths)
    )


def _arena_j(packed):
    return tuple(
        jnp.asarray(a) for a in (packed.w1, packed.w2, packed.imm, packed.lengths)
    )


def _assert_close(got, want, rtol=1e-5, atol=1e-6, err=""):
    got, want = np.asarray(got), np.asarray(want)
    both_nan = np.isnan(got) & np.isnan(want)
    with np.errstate(invalid="ignore"):
        ok = both_nan | (got == want) | (np.abs(got - want) <= atol + rtol * np.abs(want))
    bad = np.nonzero(~ok)
    assert not bad[0].size, (err, bad[0][:5], got[bad][:5], want[bad][:5])


def _matrix_inputs(T, seed):
    """Seeded points [T, 2, S0, 128] in [-2.5, 2.5], the first 16 lanes
    of every plane at exactly 0 (the kinks of abs, sqrt and recip), and
    seeded tangents and cotangents."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2.5, 2.5, size=(T, 2, S0, 128)).astype(np.float32)
    pts[:, :, 0, :16] = 0.0
    dv = rng.normal(size=pts.shape).astype(np.float32)
    w = rng.normal(size=(T, 1, S0, 128)).astype(np.float32)
    return pts, dv, w


def _port_modes(arena, pts, dv, w, kw):
    """(primal, forward tangent, reverse gradient) of the port's
    interp_float."""
    v = torch.from_numpy(pts).requires_grad_(True)
    out = interp.interp_float(*arena, v, **kw)
    assert "_FloatDiff" in type(out.grad_fn).__name__
    (out * torch.from_numpy(w)).sum().backward()
    with fwAD.dual_level():
        d = fwAD.make_dual(torch.from_numpy(pts), torch.from_numpy(dv))
        tang = fwAD.unpack_dual(interp.interp_float(*arena, d, **kw)).tangent
    return out.detach().numpy(), tang.numpy(), v.grad.numpy()


def _ref_modes(arena, pts, dv, w, kw):
    def f(v):
        return ref_interp.interp_float(*arena, v, interpret=True, **kw)

    prim, tang = jax.jvp(f, (jnp.asarray(pts),), (jnp.asarray(dv),))
    grad = jax.grad(lambda v: jnp.sum(f(v) * w))(jnp.asarray(pts))
    return np.asarray(prim), np.asarray(tang), np.asarray(grad)


def test_float_diff_matches_reference_on_op_matrix():
    tapes = [t for _, t in CASES]
    nf = max(t.reg_count + t.mem_count for t in tapes)
    pp = pack_tapes([port_tape_from_ref(t) for t in tapes], capacity=64)
    rp = ref_pack_tapes(tapes, capacity=64)
    pts, dv, w = _matrix_inputs(len(tapes), seed=3)
    kw = dict(nf=nf, n_inputs=2, n_outputs=1, s0=S0)
    p_prim, p_tang, p_grad = _port_modes(_arena_t(pp), pts, dv, w, kw)
    r_prim, r_tang, r_grad = _ref_modes(_arena_j(rp), pts, dv, w, kw)
    for t, (label, tape) in enumerate(CASES):
        if not any(s in label for s in SOFTMATH):
            _assert_close(p_prim[t], r_prim[t], err=f"{label} primal")
        _assert_close(p_tang[t], r_tang[t], err=f"{label} tangent")
        _assert_close(p_grad[t], r_grad[t], err=f"{label} gradient")
    assert np.isfinite(p_tang).all() and np.isfinite(p_grad).all()
    # the kinks: sqrt'(0) and recip'(0) are infinite, masked to 0 on
    # both sides rather than poisoning the contraction
    for label in ("u:SQRT", "u:RECIP"):
        t = [lab for lab, _ in CASES].index(label)
        for g in (p_tang, r_tang, p_grad, r_grad):
            assert (g[t][..., 0, :16] == 0).all(), label


def _circle(pkg):
    """tests/test_grad_parity.py's circle sqrt((x-cx)^2 + y^2) - r."""
    ctx = pkg.Context()
    cx, rv = pkg.Var.new(), pkg.Var.new()
    x, y = ctx.x(), ctx.y()
    dx = ctx.sub(x, ctx.input(cx))
    f = ctx.sub(ctx.sqrt(ctx.add(ctx.square(dx), ctx.square(y))), ctx.input(rv))
    return pkg.lower(ctx, [f]), cx, rv


def port_tape_with_vars(t):
    """The reference's tape fields as a port tape, with a fresh port
    `Var` at the index of each of its shape variables."""
    kinds = [v.kind if v.kind in "xyz" else port.Var.new() for v in t.var_map]
    return port.Tape.from_arrays(
        t.op, t.out, t.a, t.b, t.imm, t.aux, t.reg_count, t.mem_count,
        t.choice_count, t.output_count, kinds,
    )


@pytest.fixture(scope="module")
def circle():
    """(reference tape, port tape, cx, rv): the reference's Vars index
    both tapes."""
    tape, cx, rv = _circle(ref)
    return tape, port_tape_with_vars(tape), cx, rv


def _vec(tape, cx, rv, cx_v, rv_v):
    v = np.zeros(len(tape.var_map), np.float32)
    v[tape.var_map[cx]] = cx_v
    v[tape.var_map[rv]] = rv_v
    return v


def test_float_diff_matches_reference_on_circle(circle):
    """All four inputs at once (V = 4: two K4 passes), with the circle's
    centre among the points: its partials are NaN and read as 0."""
    rtape, ptape, cx, rv = circle
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1, 1, size=(1, 4, S0, 128)).astype(np.float32)
    ix, iy = rtape.var_map[RefVar.X], rtape.var_map[RefVar.Y]
    pts[0, rtape.var_map[cx]] = 0.1
    pts[0, rtape.var_map[rv]] = 0.5
    pts[0, ix, 0, :4] = 0.1  # the centre (0.1, 0)
    pts[0, iy, 0, :4] = 0.0
    dv = rng.normal(size=pts.shape).astype(np.float32)
    w = rng.normal(size=(1, 1, S0, 128)).astype(np.float32)
    kw = dict(nf=rtape.reg_count, n_inputs=4, n_outputs=1, s0=S0)
    port_out = _port_modes(_arena_t(pack_tapes([ptape])), pts, dv, w, kw)
    ref_out = _ref_modes(_arena_j(ref_pack_tapes([rtape])), pts, dv, w, kw)
    for what, p, r in zip(("primal", "tangent", "gradient"), port_out, ref_out):
        _assert_close(p, r, err=what)
    grad = port_out[2]
    assert (grad[0, ix, 0, :4] == 0).all() and (grad[0, iy, 0, :4] == 0).all()
    # d/dr = -1 away from the centre; at the centre sqrt's infinite
    # partial times a zero tangent is NaN in every channel, so 0
    g_r = grad[0, rtape.var_map[rv]].copy()
    assert (g_r[0, :4] == 0).all()
    g_r[0, :4] = -w[0, 0, 0, :4]
    assert (g_r == -w[0, 0]).all()


def test_float_diff_under_torch_func(circle):
    """torch.func.jvp, jacfwd and jacrev through _FloatDiff agree with
    one another."""
    rtape, ptape, cx, rv = circle
    arena = _arena_t(pack_tapes([ptape]))
    kw = dict(nf=ptape.reg_count, n_inputs=4, n_outputs=1, s0=1)
    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.uniform(-1, 1, size=(1, 4, 1, 128)).astype(np.float32))
    i = rtape.var_map[rv]

    def f(p):  # one lane's inputs -> its distance
        v = base.clone()
        v[0, :, 0, 0] = p
        return interp.interp_float(*arena, v, **kw)[0, 0, 0, 0]

    p = base[0, :, 0, 0].clone()
    e = torch.zeros(4)
    e[i] = 1.0
    _, t = torch.func.jvp(f, (p,), (e,))
    assert float(t) == -1.0
    jf, jr = torch.func.jacfwd(f)(p), torch.func.jacrev(f)(p)
    np.testing.assert_allclose(jf.numpy(), jr.numpy(), rtol=1e-6, atol=0)
    assert float(jf[i]) == -1.0


# ----------------------------------------------------------------------
# the 2D frame: mirrors of tests/test_grad_parity.py


def _port_jvp(r, vec, dvec, **kw):
    """(image, tangent, fill) of one port frame by torch.func.jvp, which
    must equal forward mode through dual tensors."""
    def f(v):
        return r._frame(r._mat4(None), 0.0, v, **kw)[0][:N, :N]

    v, dv = torch.from_numpy(vec), torch.from_numpy(dvec)
    img, tang = torch.func.jvp(f, (v,), (dv,))
    with fwAD.dual_level():
        dual = fwAD.unpack_dual(f(fwAD.make_dual(v, dv))).tangent
    assert torch.equal(tang, dual)
    fill = r._frame(r._mat4(None), 0.0, v, **kw)[1][:N, :N]
    return img.numpy(), tang.numpy(), fill.numpy()


def _ref_jvp(r, vec, dvec, **kw):
    mat = jnp.asarray(r._mat4(None))

    def f(v):
        return r._frame(mat, jnp.float32(0.0), v, **kw)[0]

    img, tang = jax.jvp(f, (jnp.asarray(vec),), (jnp.asarray(dvec),))
    fill = r._frame(mat, jnp.float32(0.0), jnp.asarray(vec), **kw)[1]
    return np.asarray(img), np.asarray(tang), np.asarray(fill)


def test_pipeline_pixel_gradients_vs_fd_and_reference(circle):
    """test_grad_parity.py:108 on the port: pixel_perfect tangents
    against central differences of the port's own frame (rtol 2e-2,
    atol 2e-3, away from the centre's kink), and tangent for tangent
    against the reference's jax.jvp (rtol 1e-5, atol 1e-6)."""
    rtape, ptape, cx, rv = circle
    r = port.PixelRenderer(ptape, port.ImageSize(N, N), device="cpu")
    vec = _vec(rtape, cx, rv, 0.1, 0.5)
    dvec = _vec(rtape, cx, rv, 0.7, -0.3)
    img, tang, _ = _port_jvp(r, vec, dvec, pixel_perfect=True)

    def f(v):
        img = r._frame(r._mat4(None), 0.0, v, pixel_perfect=True)[0]
        return img[:N, :N].numpy()

    fd = (f(vec + H_FD * dvec) - f(vec - H_FD * dvec)) / (2 * H_FD)
    yy, xx = np.mgrid[0:N, 0:N]
    m = np.isfinite(fd) & ((xx - N / 2) ** 2 + (yy - N / 2) ** 2 > 49)
    assert m.mean() > 0.9
    np.testing.assert_allclose(tang[m], fd[m], rtol=2e-2, atol=2e-3)

    rr = RefPixelRenderer(rtape, RefImageSize(N, N), interpret=True)
    r_img, r_tang, _ = _ref_jvp(rr, vec, dvec, pixel_perfect=True)
    _assert_close(img, r_img, err="image")
    _assert_close(tang, r_tang, err="tangent")


def test_pipeline_jvp_with_fills(circle):
    """test_grad_parity.py:137 on the port: without pixel_perfect, the
    interval pass proves fills, which carry no tangent (0 here); the
    evaluated pixels have d/dr = -1 (rtol = atol = 1e-4) and equal the
    reference's tangents (rtol 1e-5, atol 1e-6), with the same fills."""
    rtape, ptape, cx, rv = circle
    r = port.PixelRenderer(ptape, port.ImageSize(N, N), tile_size=16,
                           device="cpu")
    vec = _vec(rtape, cx, rv, 0.1, 0.8)
    dvec = _vec(rtape, cx, rv, 0.0, 1.0)
    img, tang, fill = _port_jvp(r, vec, dvec, pixel_perfect=False)
    ev = fill == FILL_NONE
    assert ev.any() and (~ev).any()
    np.testing.assert_allclose(tang[ev], -1.0, rtol=1e-4, atol=1e-4)
    t_fill = tang[~ev]
    assert ((t_fill == 0.0) | ~np.isfinite(t_fill)).all()

    rr = RefPixelRenderer(rtape, RefImageSize(N, N), tile_size=16,
                          interpret=True)
    _, r_tang, r_fill = _ref_jvp(rr, vec, dvec, pixel_perfect=False)
    np.testing.assert_array_equal(fill == FILL_NONE, r_fill == REF_FILL_NONE)
    _assert_close(tang[ev], r_tang[ev], err="tangent")


def test_reverse_mode_matches_forward_fd_and_reference(circle):
    """test_grad_parity.py:230 on the port: backward() through the frame
    equals torch.func.grad, torch.func.jacfwd and forward mode through
    dual tensors (rtol 1e-5, atol 1e-6), central differences (rtol
    2e-2, atol 1e-3) and the reference's jax.grad (rtol 1e-5, atol
    1e-6)."""
    rtape, ptape, cx, rv = circle
    r = port.PixelRenderer(ptape, port.ImageSize(N, N), device="cpu")
    mat = r._mat4(None)

    def loss(v):
        img, _ = r._frame(mat, 0.0, v, pixel_perfect=True)
        return (img[:N, :N] ** 2).sum() / (N * N)

    vec = _vec(rtape, cx, rv, 0.1, 0.5)
    v = torch.from_numpy(vec).requires_grad_(True)
    loss(v).backward()
    g_rev = v.grad.numpy()
    g_fwd = np.zeros_like(vec)
    with fwAD.dual_level():
        for k in range(len(vec)):
            e = np.zeros_like(vec)
            e[k] = 1.0
            d = fwAD.make_dual(torch.from_numpy(vec), torch.from_numpy(e))
            g_fwd[k] = float(fwAD.unpack_dual(loss(d)).tangent)
    np.testing.assert_allclose(g_rev, g_fwd, rtol=1e-5, atol=1e-6)
    v0 = torch.from_numpy(vec)
    np.testing.assert_allclose(g_rev, torch.func.grad(loss)(v0).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g_rev, torch.func.jacfwd(loss)(v0).numpy(),
                               rtol=1e-5, atol=1e-6)
    for k in range(len(vec)):
        e = np.zeros_like(vec)
        e[k] = 1.0
        fd = (float(loss(torch.from_numpy(vec + H_FD * e)))
              - float(loss(torch.from_numpy(vec - H_FD * e)))) / (2 * H_FD)
        np.testing.assert_allclose(g_rev[k], fd, rtol=2e-2, atol=1e-3)

    rr = RefPixelRenderer(rtape, RefImageSize(N, N), interpret=True)
    rmat = jnp.asarray(rr._mat4(None))

    def ref_loss(v):
        img, _ = rr._frame(rmat, jnp.float32(0.0), v, pixel_perfect=True)
        return jnp.sum(img ** 2) / (N * N)

    g_ref = np.asarray(jax.grad(ref_loss)(jnp.asarray(vec)))
    np.testing.assert_allclose(g_rev, g_ref, rtol=1e-5, atol=1e-6)


# ----------------------------------------------------------------------
# the kernels without a derivative


def _planes(T, V, s0, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-1, 1, (T, V, s0, 128)).astype(np.float32))


def test_interval_and_voxel_outputs_carry_no_gradient(circle):
    """K1 and K5 return outputs without a gradient in reverse or forward
    mode (the reference's zero JVPs), even on the CPU, where the plain
    versions are torch ops."""
    _, ptape, _, _ = circle
    arena = _arena_t(pack_tapes([ptape]))
    nf = ptape.reg_count
    lo = _planes(1, 4, 1, 0).requires_grad_(True)
    hi = (lo.detach() + 0.1).requires_grad_(True)
    out = interp.interp_interval(*arena, lo, hi, nf=nf, n_inputs=4,
                                 n_outputs=1, s0=1, c_words=1)
    assert not any(o.requires_grad for o in out)
    vox = _planes(1, 4, 32, 1).requires_grad_(True)
    depth = interp.interp_voxel_depth(*arena, vox, nf=nf, n_inputs=4, s0=32,
                                      sub=16)
    assert not depth.requires_grad
    with fwAD.dual_level():
        d_lo = fwAD.make_dual(lo.detach(), torch.ones_like(lo))
        d_hi = fwAD.make_dual(hi.detach(), torch.ones_like(hi))
        out = interp.interp_interval(*arena, d_lo, d_hi, nf=nf, n_inputs=4,
                                     n_outputs=1, s0=1, c_words=1)
        assert all(fwAD.unpack_dual(o).tangent is None for o in out)
        d_vox = fwAD.make_dual(vox.detach(), torch.ones_like(vox))
        depth = interp.interp_voxel_depth(*arena, d_vox, nf=nf, n_inputs=4,
                                          s0=32, sub=16)
        assert fwAD.unpack_dual(depth).tangent is None


def test_coded_leaf_raises_under_gradient(circle):
    """K6 has no derivative (nor has the reference's): a var plane that
    requires grad, or a dual one, is refused; the same planes without
    a gradient evaluate."""
    rtape, ptape, cx, rv = circle
    p = pack_tapes([ptape])
    w1, w2, imm, _ = _arena_t(p)
    lens = torch.tensor([len(ptape)], dtype=torch.int32)
    codes = torch.full((1, -(-p.w1.shape[1] // 16)), 0x55555555,
                       dtype=torch.int32)  # every row: execute
    kw = dict(nf=ptape.reg_count, n_inputs=4, n_outputs=1, s0=1)
    v = _planes(1, 4, 1, 2)
    interp.interp_float_coded(w1, w2, imm, lens, codes, v, **kw)
    with pytest.raises(ValueError, match="no derivative"):
        interp.interp_float_coded(w1, w2, imm, lens, codes,
                                  v.clone().requires_grad_(True), **kw)
    with fwAD.dual_level():
        with pytest.raises(ValueError, match="no derivative"):
            interp.interp_float_coded(
                w1, w2, imm, lens, codes,
                fwAD.make_dual(v, torch.ones_like(v)), **kw,
            )
    r = port.PixelRenderer(ptape, port.ImageSize(N, N), device="cpu")
    vec = torch.from_numpy(_vec(rtape, cx, rv, 0.1, 0.5)).requires_grad_(True)
    with pytest.raises(ValueError, match="no derivative"):
        r._frame(r._mat4(None), 0.0, vec, leaf_coded=True)
