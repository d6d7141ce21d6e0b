"""The port's 3D voxel renderer against fidget_tpu's, on the CPU.

`VoxelRenderer(specialize=False, device="cpu")` runs the bucketed
frame on the plain PyTorch versions of the kernels (the per-shape
frame, the default, is held to the reference in
test_torch_render3d_per_shape.py). The reference runs its bucketed frame
(`VoxelRenderer(..., specialize=False)`, `_TracedBind` under
`_Pipeline3.frame_tiles`) with its Pallas kernels in interpret mode.
At 32^3 with (tile 16, subtile 8) the voxel pass is K3 and with
(tile 32, subtile 16) it is K5. Stage by stage: root intervals
allclose and choice words exact; simplified tape words and lengths
exact; then the whole frame with depth exact and normals allclose
(rtol = atol = 1e-5). The reference's tests of the bucketed path
(overflow retry, shape variables and transforms, perspective) are
ported against the port's own `render_brute`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.render import render2d as ref_r2d
from fidget_tpu.render import render3d as ref_r3d
import fidget_tpu_torch as port
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.render import render3d
from fidget_tpu_torch.scenes import gyroid_sphere, sphere_union_shape
from test_torch_compiler import _assert_same_tape, port_tape_from_ref


def sphere_tape(r=0.6):
    ctx = port.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    r2 = ctx.add(ctx.square(x), ctx.add(ctx.square(y), ctx.square(z)))
    return port.lower(ctx, [ctx.sub(ctx.sqrt(r2), r)])


REF_GYROID = gyroid_sphere(ref).tape()

#: a rotation about z and x with a small shift, so subtiles straddle
#: the surface differently from the identity view
TURN = np.array([
    [0.96, -0.28, 0.0, 0.05],
    [0.2688, 0.9216, -0.28, -0.03],
    [0.0784, 0.2688, 0.96, 0.02],
    [0.0, 0.0, 0.0, 1.0],
])


def _reference_stages(rr, view):
    """The reference's root and simplify stages, eagerly, under the
    bucketed binding; then its whole frame through `render()`."""
    p = rr.packed_b
    b = ref_r2d._TracedBind(
        jnp.asarray(p.w1), jnp.asarray(p.w2), jnp.asarray(p.imm),
        jnp.asarray(p.lengths), jnp.asarray(rr.axis_idx), rr.Lcap_b,
        rr.nf_b, rr.n_inputs, rr.cw_b, True, False,
    )
    args = (
        b, jnp.asarray(rr._mat4(view)), jnp.asarray(rr._var_vec(None)),
        jnp.asarray(rr.tile_x0), jnp.asarray(rr.tile_y0),
        jnp.asarray(rr.tile_z0),
    )
    out = {
        stage: tuple(
            np.asarray(a) for a in rr.geo.frame_tiles(
                *args, mode="normals", cap=rr.cap, stop_after=stage
            )
        )
        for stage in ("root", "simplify")
    }
    img = rr.render(view, mode="normals")
    out[None] = (img.depth, img.normal)
    return out


@pytest.mark.parametrize(
    "ts,sub,view", [(16, 8, None), (32, 16, None), (32, 16, TURN)],
    ids=["k3-leaf", "k5-leaf", "k5-leaf-turned"],
)
def test_frame_matches_reference_stage_by_stage(ts, sub, view):
    size = (32, 32, 32)
    rr = ref_r3d.VoxelRenderer(
        REF_GYROID, ref_r3d.VoxelSize(*size), tile_size=ts, sub_size=sub,
        interpret=True, specialize=False,
    )
    pr = port.VoxelRenderer(
        port_tape_from_ref(REF_GYROID), port.VoxelSize(*size), tile_size=ts,
        sub_size=sub, specialize=False, device="cpu",
    )
    for attr in ("Lcap_b", "nf_b", "cw_b", "n_inputs", "cap"):
        assert getattr(pr, attr) == getattr(rr, attr), attr
    want = _reference_stages(rr, view)
    mat, vec = pr._mat4(view), pr._var_vec(None)
    got = {
        stage: tuple(a.numpy() for a in pr._frame(mat, vec, stop_after=stage))
        for stage in ("root", "simplify")
    }

    for g, w in zip(got["root"][:2], want["root"][:2]):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got["root"][2], want["root"][2])
    for g, w in zip(got["simplify"], want["simplify"]):
        np.testing.assert_array_equal(g, w)

    cuda.reset_launches()
    img = pr.render(view)
    assert cuda.LAUNCHES == {k: 0 for k in cuda.KERNELS}
    depth_w, normal_w = want[None]
    depth, normal = img.depth.numpy(), img.normal.numpy()
    np.testing.assert_array_equal(depth, depth_w)
    np.testing.assert_allclose(normal, normal_w, rtol=1e-5, atol=1e-5)
    assert 0 < (depth > 0).mean() < 1
    np.testing.assert_array_equal(depth, pr.render_brute(view).depth.numpy())
    np.testing.assert_allclose(
        normal, pr.brute_normals(depth, view), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("view", [None, TURN], ids=["identity", "turned"])
def test_voxel_and_grad_get_the_tapes_registers(monkeypatch, view):
    """K5 and K4 are launched with the registers the tape names (the
    gyroid's 6), K1 and K2 with the bucket's 64; the normals pass keeps
    the reference's lane split for the bucket's nf. Depth and normals
    equal a frame that hands K4 and K5 the bucket's nf."""
    pr = port.VoxelRenderer(
        port_tape_from_ref(REF_GYROID), port.VoxelSize(32, 32, 32),
        tile_size=32, sub_size=16, specialize=False, device="cpu",
    )
    assert (pr.nf, pr.nf_b) == (REF_GYROID.reg_count, 64)
    seen = []

    def recorder(name, fn):
        def call(*args, **kwargs):
            seen.append((name, kwargs["nf"], kwargs.get("s0")))
            return fn(*args, **kwargs)
        return call

    for name in ("interp_voxel_depth", "interp_grad", "interp_interval"):
        monkeypatch.setattr(render3d, name,
                            recorder(name, getattr(render3d, name)))
    img = pr.render(view)
    nfs = {(name, nf) for name, nf, _ in seen}
    assert nfs == {("interp_voxel_depth", pr.nf), ("interp_grad", pr.nf),
                   ("interp_interval", pr.nf_b)}
    s0n = {s0 for name, _, s0 in seen if name == "interp_grad"}
    assert s0n == {render3d._Pipeline3.s0n_of(pr.nf_b)}
    pr._nf_regs = pr.nf_b
    seen.clear()
    bucket = pr.render(view)
    assert {nf for name, nf, _ in seen if name != "interp_interval"} == {64}
    assert torch.equal(img.depth, bucket.depth)
    assert torch.equal(img.normal, bucket.normal)
    assert (img.depth > 0).any()


def test_overflow_retry():
    """tests/test_render3d.py::test_overflow_retry on the port: a tiny
    worklist must grow and still give brute's depth exactly."""
    shape = gyroid_sphere(port)
    r = port.VoxelRenderer(
        shape, port.VoxelSize(32, 32, 32), tile_size=16, sub_size=8, cap=8,
        specialize=False, device="cpu",
    )
    img = r.render(mode="heightmap", max_retries=8)
    assert img.normal is None
    np.testing.assert_array_equal(img.depth.numpy(),
                                  r.render_brute().depth.numpy())
    assert r.cap > 8


def test_shape_var_and_transform():
    """tests/test_render3d.py::test_shape_var_and_transform on the
    port: a custom variable and a Shape transform."""
    rv = port.Var.new()
    x, y, z = port.Tree.axes()
    tree = (x.square() + y.square() + z.square()).sqrt() - port.Tree.var(rv)
    shape = port.Shape.from_tree(tree).apply_transform(
        np.diag([2.0, 2.0, 2.0, 1.0])  # model = 2 * world
    )
    n = 64
    r = port.VoxelRenderer(shape, port.VoxelSize(n, n, n), tile_size=32,
                           sub_size=8, specialize=False, device="cpu")
    img = r.render(vars={rv: 0.8}, mode="heightmap")
    brute = r.render_brute(vars={rv: 0.8})
    np.testing.assert_array_equal(img.depth.numpy(), brute.depth.numpy())
    # world radius = 0.8 / 2 = 0.4: center column depth matches
    s2w = r.s2w
    pz = (0.4 - s2w[2, 3]) / s2w[2, 2]
    assert abs(int(img.depth[32, 32]) - 1 - np.floor(pz)) <= 1.0
    with pytest.raises(ValueError, match="unbound"):
        r.render(mode="heightmap")


def test_perspective_camera_matches_brute():
    """tests/test_render3d.py::test_perspective_camera_matches_brute on
    the port, in normals mode: saturated columns get [0, 0, 1]."""
    mat = np.eye(4)
    mat[3, 2] = 0.3
    r = port.VoxelRenderer(sphere_tape(0.6), port.VoxelSize(64, 64, 64),
                           tile_size=32, sub_size=8, specialize=False,
                           device="cpu")
    img = r.render(mat)
    depth = img.depth.numpy()
    np.testing.assert_array_equal(depth, r.render_brute(mat).depth.numpy())
    assert depth.max() > 0
    normal = img.normal.numpy()
    np.testing.assert_allclose(normal, r.brute_normals(depth, mat),
                               rtol=1e-4, atol=1e-4)
    assert (normal[depth == 0] == 0).all()
    assert (normal[depth == r.D] == (0.0, 0.0, 1.0)).all()


def test_render_brute_in_slabs_matches_reference(monkeypatch):
    """The port's oracle evaluates in z-slabs; with slabs of a few
    slices it still equals the reference's whole-volume oracle."""
    view = TURN.copy()
    view[3, 2] = 0.2
    size = (32, 48, 32)
    rr = ref_r3d.VoxelRenderer(REF_GYROID, ref_r3d.VoxelSize(*size),
                               tile_size=16, sub_size=8, interpret=True)
    pr = port.VoxelRenderer(port_tape_from_ref(REF_GYROID),
                            port.VoxelSize(*size), tile_size=16, sub_size=8,
                            device="cpu")
    monkeypatch.setattr(render3d, "BRUTE_SLAB_VOXELS", 32 * 48 * 5)
    got = pr.render_brute(view).depth
    assert got.dtype == torch.int32 and got.shape == (48, 32)
    np.testing.assert_array_equal(got.numpy(), rr.render_brute(view).depth)


def test_module_render_and_image_device():
    shape = gyroid_sphere(port)
    img = port.render3d(shape, port.VoxelSize(32, 32, 32), tile_size=16,
                        sub_size=8, device="cpu")
    assert isinstance(img, port.Image3D)
    assert img.depth.device.type == img.normal.device.type == "cpu"
    assert img.depth.dtype == torch.int32 and img.normal.dtype == torch.float32
    hm = port.render3d(shape, port.VoxelSize(32, 32, 32), tile_size=16,
                       sub_size=8, device="cpu", mode="heightmap")
    assert hm.normal is None
    np.testing.assert_array_equal(hm.depth.numpy(), img.depth.numpy())


def test_fired_cancel_token_stops_the_frame():
    from fidget_tpu_torch.render.config import CancelToken, RenderCancelled

    r = port.VoxelRenderer(sphere_tape(), port.VoxelSize(32, 32, 32),
                           tile_size=16, sub_size=8, device="cpu")
    token = CancelToken()
    assert (r.render(cancel=token).depth > 0).any()
    token.cancel()
    with pytest.raises(RenderCancelled):
        r.render(cancel=token)


def test_renderer_without_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.VoxelRenderer(sphere_tape(), port.VoxelSize(32, 32, 32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.render3d(sphere_tape(), port.VoxelSize(32, 32, 32))


def test_bad_geometry_is_refused():
    with pytest.raises(ValueError, match="multiples"):
        port.VoxelRenderer(sphere_tape(), port.VoxelSize(40, 32, 32),
                           tile_size=16, device="cpu")
    with pytest.raises(ValueError, match="multiple"):
        port.VoxelRenderer(sphere_tape(), port.VoxelSize(32, 32, 32),
                           tile_size=16, sub_size=6, device="cpu")


def test_shape_evaluators_match_reference():
    """`Shape.eval`, `eval_interval` and `eval_grad` (host numpy) equal
    the reference's on the same points, with an affine transform."""
    mat = TURN
    ps = gyroid_sphere(port).apply_transform(mat)
    rs = gyroid_sphere(ref).apply_transform(mat)
    rng = np.random.default_rng(8)
    x, y, z = rng.uniform(-1, 1, size=(3, 500)).astype(np.float32)
    np.testing.assert_array_equal(ps.eval(x, y, z), rs.eval(x, y, z))
    for g, w in zip(ps.eval_grad(x, y, z), rs.eval_grad(x, y, z)):
        np.testing.assert_array_equal(g, w)
    box = ((x, x + 0.1), (y, y + 0.1), (z, z + 0.1))
    (glo, ghi), gch = ps.eval_interval(*box, trace=True)
    (wlo, whi), wch = rs.eval_interval(*box, trace=True)
    np.testing.assert_array_equal(glo, wlo)
    np.testing.assert_array_equal(ghi, whi)
    np.testing.assert_array_equal(np.stack(gch), np.stack(wch))
    assert len(ps.vars) == 0 and ps.bind().shape is ps


def test_3d_scenes_lower_identically():
    """The 3D scenes of `fidget_tpu_torch.scenes`: the sphere union
    (3,303 ops, 13 registers, 299 choices) and the 28-op gyroid sphere
    lower to identical tapes in either package."""
    rc, pc = ref.Context(), port.Context()
    t_ref = ref.lower(rc, [sphere_union_shape(rc)])
    t_port = port.lower(pc, [sphere_union_shape(pc)])
    assert (len(t_ref), t_ref.reg_count, t_ref.choice_count) == (3303, 13, 299)
    _assert_same_tape(t_port, t_ref)
    _assert_same_tape(gyroid_sphere(port).tape(), REF_GYROID)
    assert len(REF_GYROID) == 28
