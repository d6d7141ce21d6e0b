"""The port's grad (K4) and voxel-depth (K5) interpreters, GradMode and
the 3D transforms against fidget_tpu's, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions to the reference: the Pallas
kernels in interpret mode on the same packed arenas (K4 at S0 = 8:
values allclose at 1e-6, derivatives at 1e-5; K5 at sub = 16, S0 = 32,
and at sub = 32: depths exact), both also on arenas packed under a
`frequency_op_order` with the same order handed to both sides, the
grad-mode op matrix against the reference's numpy
GradMode at the tolerances of tests/test_kernel_ops.py, and
`transform_duals` / `VoxelSize` against the reference's. The CUDA
kernels are held to the same plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.compiler.pack import frequency_op_order as ref_frequency_op_order
from fidget_tpu.compiler.pack import pack_tapes as ref_pack_tapes
from fidget_tpu.eval import pallas_interp as ref_interp
from fidget_tpu.eval.arith import GradMode as RefGradMode
from fidget_tpu.eval.simplify_device import DynamicSimplifier
from fidget_tpu.eval.unrolled import eval_tape as ref_eval_tape
from fidget_tpu.render.region import VoxelSize as RefVoxelSize
from fidget_tpu.render.transform import transform_duals as ref_transform_duals

import fidget_tpu_torch as port
from fidget_tpu_torch.compiler.pack import pack_tapes
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval.arith import GradMode
from fidget_tpu_torch.eval.interp import (
    interp_grad,
    interp_grad_plain,
    interp_interval,
    interp_voxel_depth,
)
from fidget_tpu_torch.eval.simplify_device import per_instance_codes
from fidget_tpu_torch.render.transform import transform_duals
from test_torch_compiler import port_tape_from_ref
from test_torch_kernels import (
    A_PTS,
    B_PTS,
    CASES,
    EDGES,
    REF_TAPES,
    S0,
    UNION,
    V3,
    _arena,
    _assert_matches,
)


def _grad_planes(tapes, seed):
    """Dual planes [T, 3, 4, S0, 128]: values in [-1.5, 1.5] and random
    seed derivatives, from a numpy seed."""
    rng = np.random.default_rng(seed)
    duals = rng.uniform(-1, 1, size=(len(tapes), V3, 4, S0, 128))
    duals[:, :, 0] *= 1.5
    return duals.astype(np.float32)


@pytest.fixture(scope="module")
def packed_pair():
    port_tapes = [port_tape_from_ref(t) for t in REF_TAPES]
    return (
        pack_tapes(port_tapes, capacity=512),
        ref_pack_tapes(REF_TAPES, capacity=512),
    )


# ----------------------------------------------------------------------
# K4


def test_k4_grad_matches_reference_kernel(packed_pair):
    pp, rp = packed_pair
    duals = _grad_planes(REF_TAPES, 0)
    want = np.asarray(ref_interp.interp_grad(
        rp.w1, rp.w2, rp.imm, rp.lengths, duals, nf=rp.nf, n_inputs=V3,
        n_outputs=1, s0=S0, interpret=True,
    ))
    got = interp_grad(
        *_arena(pp), torch.from_numpy(duals), nf=pp.nf, n_inputs=V3,
        n_outputs=1, s0=S0,
    ).numpy()
    assert got.shape == (len(REF_TAPES), 1, 4, S0, 128)
    np.testing.assert_allclose(got[:, :, 0], want[:, :, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], rtol=1e-5, atol=1e-5)
    assert np.abs(got[:, :, 1:]).max() > 0


def test_k4_grad_op_matrix():
    """Every op x operand-position case with x seeded d/dx and y seeded
    d/dy, against the reference's numpy GradMode: values at the float
    matrix's tolerance (2e-4 for EXP and LN), derivatives at 1e-4."""
    tapes = [port_tape_from_ref(t) for _, t in CASES]
    packed = pack_tapes(tapes, capacity=32)
    duals = np.zeros((len(CASES), 2, 4, S0, 128), np.float32)
    for t_i, (_, tape) in enumerate(CASES):
        for v, i in tape.var_map.items():
            is_x = v == ref.Var.X
            duals[t_i, i, 0] = (A_PTS if is_x else B_PTS).reshape(S0, 128)
            duals[t_i, i, 1 if is_x else 2] = 1.0
    out = interp_grad(
        *_arena(packed), torch.from_numpy(duals), nf=packed.nf, n_inputs=2,
        n_outputs=1, s0=S0,
    ).numpy()
    gm = RefGradMode(np)
    for t_i, (label, tape) in enumerate(CASES):
        inputs = [None] * len(tape.var_map)
        for v, i in tape.var_map.items():
            inputs[i] = tuple(duals[t_i, i, k].reshape(-1) for k in range(4))
        with np.errstate(all="ignore"):
            (want,), _ = ref_eval_tape(tape, gm, inputs)
        tol = 2e-4 if ("EXP" in label or "LN" in label) else 2e-5
        _assert_matches(out[t_i, 0, 0], want[0], label, rtol=tol, atol=tol)
        for k in (1, 2, 3):
            _assert_matches(out[t_i, 0, k], want[k], f"{label}:d{k}",
                            rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("op", [o.name for o in port.UnaryOp])
def test_grad_mode_unary_edges(op):
    """The port's GradMode (over torch) against the reference's (over
    numpy) on edge values, with a seed derivative of 1."""
    from fidget_tpu.compiler.tape import TapeOp as RefTapeOp
    from fidget_tpu_torch.compiler.tape import TapeOp

    a = EDGES
    one = np.ones_like(a)
    zero = np.zeros_like(a)
    with np.errstate(all="ignore"):
        got = GradMode(torch).unary(
            TapeOp[op], tuple(torch.from_numpy(x) for x in (a, one, zero, one))
        )
        want = RefGradMode(np).unary(RefTapeOp[op], (a, one, zero, one))
    for k, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5,
                                   err_msg=f"{op} plane {k}")


def test_k4_lane_chunks_agree(packed_pair):
    """Any split of the lanes gives the same duals: the chunk-equality
    property of the reference's s0 split (tests/test_pallas_interp.py),
    which the port keeps without splitting."""
    pp, _ = packed_pair
    duals = _grad_planes(REF_TAPES, 1)
    kw = dict(nf=pp.nf, n_inputs=V3, n_outputs=1)
    full = interp_grad(*_arena(pp), torch.from_numpy(duals), s0=S0, **kw)
    halves = [
        interp_grad(*_arena(pp), torch.from_numpy(duals[..., k:k + 4, :].copy()),
                    s0=4, **kw)
        for k in (0, 4)
    ]
    torch.testing.assert_close(full, torch.cat(halves, dim=3), rtol=0, atol=0)


@pytest.mark.parametrize("tangents", [1, 2])
def test_k4_narrow_duals_equal_the_first_planes(packed_pair, tangents):
    """Duals of 1 + tangents planes give the first 1 + tangents planes
    of the four-plane run, bit for bit: no plane reads another's
    tangents. The wrapper on the CPU takes the same route."""
    pp, _ = packed_pair
    duals = _grad_planes(REF_TAPES, 3)
    kw = dict(nf=pp.nf, n_inputs=V3, n_outputs=1, s0=S0)
    P = 1 + tangents
    full = interp_grad_plain(*_arena(pp), torch.from_numpy(duals), **kw)
    narrow = torch.from_numpy(duals[:, :, :P].copy())
    got = interp_grad_plain(*_arena(pp), narrow, **kw)
    assert got.shape == (len(REF_TAPES), 1, P, S0, 128)
    want = full[:, :, :P].contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(
        interp_grad(*_arena(pp), narrow, **kw), got)
    assert np.abs(got[:, :, 1:].numpy()).max() > 0


@pytest.mark.parametrize("tangents", [0, 4])
def test_k4_rejects_tangents_outside_one_to_three(packed_pair, tangents):
    """Duals of 1 + tangents planes, 2 to 4, and nothing else."""
    pp, _ = packed_pair
    duals = torch.zeros((len(REF_TAPES), V3, 1 + tangents, S0, 128))
    with pytest.raises(ValueError, match="2 to 4"):
        interp_grad(*_arena(pp), duals, nf=pp.nf, n_inputs=V3, n_outputs=1,
                    s0=S0)
    with pytest.raises(ValueError, match="1 to 3 tangents"):
        cuda.launch_geometry("interp_grad", nf=pp.nf, lanes=S0 * 128,
                             T=len(REF_TAPES), tangents=tangents)


def test_k4_zero_length_writes_zero(packed_pair):
    pp, _ = packed_pair
    w1, w2, imm, lens = _arena(pp)
    out = interp_grad(
        w1, w2, imm, torch.zeros_like(lens),
        torch.from_numpy(_grad_planes(REF_TAPES, 2)), nf=pp.nf, n_inputs=V3,
        n_outputs=2, s0=S0,
    )
    assert (out == 0).all()


# ----------------------------------------------------------------------
# K5

SUB = 16
S0V = SUB**3 // 128


def _voxel_case():
    """Instances over one 16^3 subtile each: the gyroid sphere and the
    union at several places and scales, then a length-0 instance and a
    tape cut before its OUTPUT. Voxel planes (vz, vy, vx) row-major."""
    rng = np.random.default_rng(3)
    gyroid = len(REF_TAPES) - 1
    picks = [gyroid, gyroid, gyroid, UNION, 0, gyroid]
    tapes = [REF_TAPES[i] for i in picks]
    vz, vy, vx = np.meshgrid(*[np.arange(SUB)] * 3, indexing="ij")
    vox = np.stack([vx, vy, vz]).reshape(3, -1).astype(np.float32)
    planes = np.zeros((len(tapes), V3, S0V, 128), np.float32)
    for t_i in range(len(tapes)):
        base = rng.uniform(-1.0, 0.6, size=3).astype(np.float32)
        step = np.float32(rng.uniform(0.02, 0.06))
        pts = base[:, None] + vox * step
        for v, i in tapes[t_i].var_map.items():
            planes[t_i, i] = pts["xyz".index(v.kind)].reshape(S0V, 128)
    return tapes, planes


def test_k5_voxel_depth_matches_reference_kernel():
    tapes, planes = _voxel_case()
    pp = pack_tapes([port_tape_from_ref(t) for t in tapes], capacity=512)
    rp = ref_pack_tapes(tapes, capacity=512)
    lens = rp.lengths.copy()
    lens[-2] = 0                  # culled subtile
    lens[-1] = lens[-1] - 1       # the tape never reaches its OUTPUT
    want = np.asarray(ref_interp.interp_voxel_depth(
        rp.w1, rp.w2, rp.imm, lens, planes, nf=rp.nf, n_inputs=V3, s0=S0V,
        sub=SUB, interpret=True,
    ))
    w1, w2, imm, _ = _arena(pp)
    got = interp_voxel_depth(
        w1, w2, imm, torch.from_numpy(lens), torch.from_numpy(planes),
        nf=pp.nf, n_inputs=V3, s0=S0V, sub=SUB,
    ).numpy()
    assert got.shape == want.shape == (len(tapes), 8, 128)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    live = got[:-2, :2]
    assert (live > 0).any() and (live == 0).any() and (live < SUB).any()
    assert (got[-2:] == 0).all() and (got[:, 2:] == 0).all()


@pytest.fixture(scope="module")
def voxel_order():
    """The gyroid's frequency order: sin and cos move ahead of the
    ops a canonical switch puts first."""
    order = ref_frequency_op_order(REF_TAPES[len(REF_TAPES) - 1])
    assert order[:4] != tuple(range(4))
    return order


def test_k4_under_op_order_matches_reference_kernel(voxel_order):
    """K4 on arenas packed under the gyroid's frequency order, the
    same order to both sides: values allclose at 2e-5, derivatives at
    1e-4, and equal to the port's own canonical result."""
    order = voxel_order
    port_tapes = [port_tape_from_ref(t) for t in REF_TAPES]
    pp = pack_tapes(port_tapes, capacity=512, op_order=order)
    rp = ref_pack_tapes(REF_TAPES, capacity=512, op_order=order)
    np.testing.assert_array_equal(pp.w1, rp.w1)
    duals = _grad_planes(REF_TAPES, 8)
    kw = dict(nf=rp.nf, n_inputs=V3, n_outputs=1, s0=S0)
    want = np.asarray(ref_interp.interp_grad(
        rp.w1, rp.w2, rp.imm, rp.lengths, duals, interpret=True,
        op_order=order, **kw))
    got = interp_grad(*_arena(pp), torch.from_numpy(duals), op_order=order,
                      **kw)
    np.testing.assert_allclose(got[:, :, 0], want[:, :, 0], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got[:, :, 1:], want[:, :, 1:], rtol=1e-4,
                               atol=1e-4)
    canonical = pack_tapes(port_tapes, capacity=512)
    torch.testing.assert_close(
        got, interp_grad(*_arena(canonical), torch.from_numpy(duals), **kw),
        rtol=0, atol=0)
    assert not np.array_equal(pp.w1, canonical.w1)


def test_k5_under_op_order_matches_reference_kernel(voxel_order):
    """K5 over `_voxel_case` packed under the gyroid's frequency order:
    depths equal the reference's and the port's canonical ones."""
    order = voxel_order
    tapes, planes = _voxel_case()
    pp = pack_tapes([port_tape_from_ref(t) for t in tapes], capacity=512,
                    op_order=order)
    rp = ref_pack_tapes(tapes, capacity=512, op_order=order)
    lens = rp.lengths.copy()
    lens[-2] = 0
    kw = dict(nf=rp.nf, n_inputs=V3, s0=S0V, sub=SUB)
    want = np.asarray(ref_interp.interp_voxel_depth(
        rp.w1, rp.w2, rp.imm, lens, planes, interpret=True, op_order=order,
        **kw))
    w1, w2, imm, _ = _arena(pp)
    got = interp_voxel_depth(w1, w2, imm, torch.from_numpy(lens),
                             torch.from_numpy(planes), op_order=order, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    cp = pack_tapes([port_tape_from_ref(t) for t in tapes], capacity=512)
    canonical = interp_voxel_depth(
        *_arena(cp)[:3], torch.from_numpy(lens), torch.from_numpy(planes), **kw)
    assert torch.equal(got, canonical)
    assert (got[:-2, :2] > 0).any() and (got[-2] == 0).all()


def test_k5_sub32_matches_reference_kernel():
    """K5 at sub = 32 (S0 = 256, eight column planes, no padding): the
    gyroid sphere at two places and a culled instance, depths exact."""
    sub = 32
    s0 = sub**3 // 128
    gyroid = REF_TAPES[len(REF_TAPES) - 1]
    tapes = [gyroid, REF_TAPES[UNION], gyroid]
    rng = np.random.default_rng(12)
    vz, vy, vx = np.meshgrid(*[np.arange(sub)] * 3, indexing="ij")
    vox = np.stack([vx, vy, vz]).reshape(3, -1).astype(np.float32)
    planes = np.zeros((len(tapes), V3, s0, 128), np.float32)
    for t_i, tape in enumerate(tapes):
        base = rng.uniform(-1.0, 0.2, size=3).astype(np.float32)
        pts = base[:, None] + vox * np.float32(0.03)
        for v, i in tape.var_map.items():
            planes[t_i, i] = pts["xyz".index(v.kind)].reshape(s0, 128)
    pp = pack_tapes([port_tape_from_ref(t) for t in tapes], capacity=512)
    rp = ref_pack_tapes(tapes, capacity=512)
    lens = rp.lengths.copy()
    lens[-1] = 0
    kw = dict(nf=rp.nf, n_inputs=V3, s0=s0, sub=sub)
    want = np.asarray(ref_interp.interp_voxel_depth(
        rp.w1, rp.w2, rp.imm, lens, planes, interpret=True, **kw))
    w1, w2, imm, _ = _arena(pp)
    got = interp_voxel_depth(w1, w2, imm, torch.from_numpy(lens),
                             torch.from_numpy(planes), **kw).numpy()
    assert got.shape == want.shape == (len(tapes), 8, 128)
    np.testing.assert_array_equal(got, want)
    live = got[:-1]
    assert (live > 0).any() and (live == 0).any() and (live < sub).any()
    assert (got[-1] == 0).all()


def test_k5_nan_distance_is_not_inside():
    ctx = port.Context()
    x = ctx.x()
    tape = port.lower(ctx, [ctx.sub(ctx.sqrt(x), 1.0)])  # NaN for x < 0
    pk = pack_tapes([tape])
    planes = torch.full((1, 1, S0V, 128), -4.0)
    planes[..., : S0V // 2, :] = 0.25  # sqrt(0.25) - 1 < 0: inside
    got = interp_voxel_depth(*_arena(pk), planes, nf=pk.nf, n_inputs=1,
                             s0=S0V, sub=SUB)
    # the first half of the lanes are slices vz < 8
    assert (got[0, :2] == SUB // 2).all()


def test_k5_rejects_bad_subtiles():
    pk = pack_tapes([port_tape_from_ref(REF_TAPES[0])])
    with pytest.raises(ValueError, match="sub"):
        interp_voxel_depth(*_arena(pk), torch.zeros((1, V3, 4, 128)),
                           nf=pk.nf, n_inputs=V3, s0=4, sub=8)


def test_cpu_path_launches_no_kernel(packed_pair):
    pp, _ = packed_pair
    cuda.reset_launches()
    interp_grad(*_arena(pp), torch.from_numpy(_grad_planes(REF_TAPES, 4)),
                nf=pp.nf, n_inputs=V3, n_outputs=1, s0=S0)
    tapes, planes = _voxel_case()
    vp = pack_tapes([port_tape_from_ref(t) for t in tapes[:2]])
    interp_voxel_depth(*_arena(vp), torch.from_numpy(planes[:2]), nf=vp.nf,
                       n_inputs=V3, s0=S0V, sub=SUB)
    assert cuda.LAUNCHES == {name: 0 for name in cuda.KERNELS}
    assert {"interp_grad", "interp_voxel_depth"} <= set(cuda.KERNELS)


# ----------------------------------------------------------------------
# K2 with per-instance tapes


def test_per_instance_codes_match_reference(packed_pair):
    pp, rp = packed_pair
    rng = np.random.default_rng(5)
    lo = rng.uniform(-1.5, 1.5, size=(len(REF_TAPES), V3, S0, 128))
    hi = lo + rng.uniform(0, 0.5, size=lo.shape)
    lo, hi = lo.astype(np.float32), hi.astype(np.float32)
    ch = interp_interval(
        *_arena(pp), torch.from_numpy(lo), torch.from_numpy(hi), nf=pp.nf,
        n_inputs=V3, n_outputs=1, s0=S0, c_words=4,
    )[2]
    w1, w2, _, lens = _arena(pp)
    got = per_instance_codes(w1, w2, lens, ch, nf=pp.nf)
    want = np.asarray(DynamicSimplifier.codes(
        rp.w1, rp.w2, rp.lengths, ch.numpy(), nf=pp.nf, interpret=True,
    ))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------------------
# transforms


def _views():
    rng = np.random.default_rng(6)
    out = [np.eye(4)]
    m = np.eye(4)
    m[:3, :3] = rng.uniform(-1, 1, size=(3, 3))
    m[:3, 3] = rng.uniform(-0.2, 0.2, size=3)
    out.append(m)
    p = m.copy()
    p[3, 2] = 0.3
    out.append(p)
    return out


@pytest.mark.parametrize("k", range(3), ids=["identity", "affine", "perspective"])
def test_transform_duals_match_reference(k):
    import jax.numpy as jnp

    mat = _views()[k].astype(np.float32)
    rng = np.random.default_rng(7 + k)
    x, y, z = rng.uniform(-1, 1, size=(3, 4, 128)).astype(np.float32)
    want = ref_transform_duals(jnp.asarray(mat), jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(z))
    got = transform_duals(torch.from_numpy(mat), torch.from_numpy(x),
                          torch.from_numpy(y), torch.from_numpy(z))
    for gi, wi in zip(got, want):
        for g, w in zip(gi, wi):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)
    # and numpy in, numpy out, as the normals oracle calls it
    host = transform_duals(mat, x, y, z)
    for hi, gi in zip(host, got):
        for h, g in zip(hi, gi):
            np.testing.assert_allclose(h, g.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", [(32, 32, 32), (64, 48, 128), (7, 9, 5)])
def test_voxel_size_matches_reference(size):
    np.testing.assert_array_equal(
        port.VoxelSize(*size).screen_to_world(),
        RefVoxelSize(*size).screen_to_world(),
    )
