"""The port's sharded entry points on 2 and 4 gloo ranks on the CPU.

Each world runs as subprocesses of this file (the rank's code is its
`__main__`), initialized through a `FileStore` in the test's temporary
directory; every spawn has its own timeout and kills its ranks when it
runs out. Each rank saves what it computed to an `.npz`, and the tests
hold it:

- to the reference's sharded functions (`fidget_tpu.parallel.sharding`,
  interpret mode) on the conftest's 8-device CPU mesh at the same D;
- to the port's own single-device frames, bit for bit;
- and across ranks: every rank returns the same whole image.

The slab entry points (`PixelRenderer._frame_tiles`,
`VoxelRenderer._frame_tiles`) and `make_mesh` are also held here
in-process.

Run one world by hand: `python tests/test_torch_sharding.py RANK WORLD
STORE OUT` for each RANK in 0..WORLD-1.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: seconds a whole world may take, start-up included, before its ranks
#: are killed and the test fails
SPAWN_TIMEOUT = 240
WORLDS = (2, 4)
#: worklist capacities of `render_unrolled_sharded`: fewer slots than
#: active tiles, and more than the image has tiles
CAPS = {"small": 8, "large": 10**6}
#: the 2D frames' size: 4 root-tile rows of 32 px, 16 tile rows of 8 px
SIZE2 = (64, 128)
#: the fitting image (the reference's tests/test_grad_parity.py size)
FIT_N = 64
FIT_THETA = (0.1, 0.5)
FIT_TARGET = (0.25, 0.6)
FIT_LR = 0.5
H_FD = 1e-2
#: the 3D volume: the gyroid sphere, 32 px wide and deep, 16 px of
#: height a rank, in 16-px root tiles of 8-px subtiles
TILE3, SUB3 = 16, 8
BINDINGS3 = {
    "per_shape": dict(),
    "unrolled": dict(leaf="unrolled", proofs="unrolled"),
}


def _size3(world):
    return (32, 16 * world, 32)


# ----------------------------------------------------------------------
# scenes, built from one recipe in either package


def _circle(pkg):
    """A circle of radius Var rv about (Var cx, 0), as the reference's
    gradient tests build it."""
    ctx = pkg.Context()
    cx, rv = pkg.Var.new(), pkg.Var.new()
    x, y = ctx.x(), ctx.y()
    f = ctx.sub(
        ctx.sqrt(ctx.add(ctx.square(ctx.sub(x, ctx.input(cx))),
                         ctx.square(y))),
        ctx.input(rv),
    )
    return pkg.lower(ctx, [f]), cx, rv


def _skewed(pkg):
    """A small disk near the top edge: all of its geometry lands in the
    first rank's slab of tile rows."""
    ctx = pkg.Context()
    x, y = ctx.x(), ctx.y()
    f = ctx.sub(
        ctx.sqrt(ctx.add(ctx.square(x), ctx.square(ctx.sub(y, 1.3)))), 0.12
    )
    return pkg.lower(ctx, [f])


def _ring(pkg):
    ctx = pkg.Context()
    x, y = ctx.x(), ctx.y()
    r = ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y)))
    return pkg.lower(ctx, [ctx.sub(ctx.abs(ctx.sub(r, 0.6)), 0.15)])


# ----------------------------------------------------------------------
# the ranks


def _rank_main(rank, world, store, out):
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.distributed as dist

    import fidget_tpu_torch as port
    from fidget_tpu_torch.parallel import sharding as sh
    from fidget_tpu_torch.scenes import gyroid_sphere

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = sh.make_mesh(device="cpu")
    res = {}

    def put(name, t):
        res[name] = t.detach().cpu().numpy()

    size2 = port.ImageSize(*SIZE2)
    ring = _ring(port)
    for ts in ((32,), (32, 16)):
        img = sh.render_tiles_sharded(ring, size2, mesh, tile_sizes=ts)
        tag = "x".join(map(str, ts))
        put(f"tiles_{tag}_distance", img.distance)
        put(f"tiles_{tag}_fill", img.fill)
    img, counts = sh.render_unrolled_sharded(_skewed(port), size2, mesh,
                                             _debug_counts=True)
    put("skew_distance", img.distance)
    put("skew_fill", img.fill)
    put("skew_counts", counts)
    for name, cap in CAPS.items():
        img = sh.render_unrolled_sharded(ring, size2, mesh, cap=cap)
        put(f"{name}_cap_distance", img.distance)
        put(f"{name}_cap_fill", img.fill)

    tape, cx, rv = _circle(port)
    fit = port.ImageSize(FIT_N, FIT_N)
    target = sh.render_sharded(tape, fit, mesh,
                               params={cx: FIT_TARGET[0], rv: FIT_TARGET[1]})
    put("dense", target)
    theta = {cx: FIT_THETA[0], rv: FIT_THETA[1]}
    for pipeline in ("unrolled", "interp"):
        new, loss = sh.fit_step(tape, fit, mesh, theta, target, lr=FIT_LR,
                                pipeline=pipeline)
        res[f"fit_{pipeline}"] = np.array([new[cx], new[rv], loss])
    for k, v in enumerate((cx, rv)):
        for sign in (1, -1):
            p = dict(theta)
            p[v] = theta[v] + sign * H_FD
            put(f"fd_{k}_{sign}", sh.render_sharded(tape, fit, mesh, params=p))

    gyroid = gyroid_sphere(port)
    size3 = port.VoxelSize(*_size3(world))
    for name, kw in BINDINGS3.items():
        img = sh.render_voxels_sharded(gyroid, size3, mesh, tile_size=TILE3,
                                       sub_size=SUB3, **kw)
        put(f"vox_{name}_depth", img.depth)
        put(f"vox_{name}_normal", img.normal)

    # heights that do not divide over the ranks
    errors = []
    bad2 = port.ImageSize(SIZE2[0], 32 * (world + 1))
    for call in (
        lambda: sh.render_tiles_sharded(ring, bad2, mesh, tile_sizes=(32,)),
        lambda: sh.render_unrolled_sharded(
            ring, port.ImageSize(64, 8 * (world + 1)), mesh),
        lambda: sh.render_sharded(tape, port.ImageSize(64, world + 1), mesh),
        lambda: sh.render_voxels_sharded(
            gyroid, port.VoxelSize(32, 16 * (world + 1), 32), mesh,
            tile_size=TILE3, sub_size=SUB3),
    ):
        try:
            call()
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    res["errors"] = np.array(errors)
    np.savez(out, **res)
    dist.destroy_process_group()


def _spawn(world, tmp):
    """Runs a world of `world` ranks; returns each rank's outputs."""
    store = tmp / "store"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world), str(store),
             str(tmp / f"rank{rank}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT,
        )
        for rank in range(world)
    ]
    logs = []
    deadline = time.monotonic() + SPAWN_TIMEOUT
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"world of {world} ranks timed out after "
                    f"{SPAWN_TIMEOUT} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        tail = "\n".join(log.splitlines()[-30:])
        assert p.returncode == 0, f"rank {rank} of {world} failed:\n{tail}"
    return [dict(np.load(tmp / f"rank{rank}.npz"))
            for rank in range(world)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {D: _spawn(D, tmp_path_factory.mktemp(f"world{D}"))
            for D in WORLDS}


@pytest.fixture(scope="module")
def ref():
    import fidget_tpu
    import fidget_tpu.parallel.sharding as ref_sh

    return fidget_tpu, ref_sh


# ----------------------------------------------------------------------
# across ranks


@pytest.mark.parametrize("D", WORLDS)
def test_every_rank_returns_the_whole_image(worlds, D):
    ranks = worlds[D]
    for out in ranks[1:]:
        assert out.keys() == ranks[0].keys()
        for k, v in out.items():
            np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)


# ----------------------------------------------------------------------
# against the port's single-device frames, bit for bit


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("ts", [(32,), (32, 16)], ids=["one_level",
                                                       "two_level"])
def test_tiles_equal_the_per_shape_frame(worlds, D, ts):
    import torch

    import fidget_tpu_torch as port

    out = worlds[D][0]
    tag = "x".join(map(str, ts))
    r = port.PixelRenderer(_ring(port), port.ImageSize(*SIZE2),
                           tile_sizes=ts, specialize=True, device="cpu")
    want = r.render()
    np.testing.assert_array_equal(out[f"tiles_{tag}_fill"], want.fill.numpy())
    assert torch.equal(torch.from_numpy(out[f"tiles_{tag}_distance"]),
                       want.distance)


@pytest.mark.parametrize("D", WORLDS)
def test_rebalance_deals_the_skewed_scene_evenly(worlds, D):
    import fidget_tpu_torch as port

    out = worlds[D][0]
    r = port.PixelRenderer(_skewed(port), port.ImageSize(*SIZE2),
                           device="cpu")
    want = r.render_unrolled()
    np.testing.assert_array_equal(out["skew_fill"], want.fill.numpy())
    np.testing.assert_array_equal(out["skew_distance"],
                                  want.distance.numpy())
    counts = out["skew_counts"]
    total = int(counts.sum())
    # every active tile sits in the first rank's slab, yet the deal is
    # even
    assert total > 0
    assert counts.max() <= -(-total // D)
    rows_active = np.nonzero((out["skew_fill"] == 0).any(axis=1))[0]
    assert rows_active.max() < SIZE2[1] // D


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("cap", list(CAPS))
def test_any_cap_gives_the_single_device_frame(worlds, D, cap):
    """A worklist smaller than the active tiles grows before the leaf;
    one larger than the image's tiles shrinks to them."""
    import fidget_tpu_torch as port

    out = worlds[D][0]
    want = port.PixelRenderer(_ring(port), port.ImageSize(*SIZE2),
                              device="cpu").render_unrolled()
    np.testing.assert_array_equal(out[f"{cap}_cap_fill"], want.fill.numpy())
    np.testing.assert_array_equal(out[f"{cap}_cap_distance"],
                                  want.distance.numpy())


@pytest.mark.parametrize("D", WORLDS)
def test_dense_rows_equal_the_dense_frame(worlds, D):
    import fidget_tpu_torch as port

    tape, cx, rv = _circle(port)
    r = port.PixelRenderer(tape, port.ImageSize(FIT_N, FIT_N), device="cpu")
    want = r.render_dense(vars={cx: FIT_TARGET[0], rv: FIT_TARGET[1]})
    np.testing.assert_array_equal(worlds[D][0]["dense"],
                                  want.distance.numpy())


@pytest.mark.parametrize("D", WORLDS)
@pytest.mark.parametrize("binding", list(BINDINGS3))
def test_voxels_equal_the_single_device_frame(worlds, D, binding):
    import fidget_tpu_torch as port
    from fidget_tpu_torch.scenes import gyroid_sphere

    out = worlds[D][0]
    r = port.VoxelRenderer(gyroid_sphere(port), port.VoxelSize(*_size3(D)),
                           tile_size=TILE3, sub_size=SUB3, device="cpu",
                           **BINDINGS3[binding])
    want = r.render()
    np.testing.assert_array_equal(out[f"vox_{binding}_depth"],
                                  want.depth.numpy())
    np.testing.assert_array_equal(out[f"vox_{binding}_normal"],
                                  want.normal.numpy())


@pytest.mark.parametrize("D", WORLDS)
def test_indivisible_heights_raise(worlds, D):
    errors = worlds[D][0]["errors"]
    assert len(errors) == 4
    for msg in errors:
        assert f"must divide over {D} devices" in msg


# ----------------------------------------------------------------------
# fitting


def _fd_loss(out, key):
    target = out["dense"]
    return float(((out[key] - target) ** 2).mean())


@pytest.mark.parametrize("D", WORLDS)
def test_fit_step_gradient_matches_central_differences(worlds, D):
    out = worlds[D][0]
    new_cx, new_rv, _ = out["fit_unrolled"]
    g = [(FIT_THETA[0] - new_cx) / FIT_LR, (FIT_THETA[1] - new_rv) / FIT_LR]
    for k in range(2):
        fd = (_fd_loss(out, f"fd_{k}_1") - _fd_loss(out, f"fd_{k}_-1")) / (
            2 * H_FD
        )
        np.testing.assert_allclose(g[k], fd, rtol=2e-2, atol=1e-4)


@pytest.mark.parametrize("D", WORLDS)
def test_fit_step_interp_matches_unrolled(worlds, D):
    out = worlds[D][0]
    u, i = out["fit_unrolled"], out["fit_interp"]
    np.testing.assert_allclose(i[2], u[2], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(i[:2], u[:2], rtol=1e-4, atol=1e-5)


# ----------------------------------------------------------------------
# against the reference's sharded functions on the 8-device CPU mesh


@pytest.mark.parametrize("D", WORLDS)
def test_fit_step_matches_reference(worlds, ref, D):
    fidget_tpu, ref_sh = ref
    out = worlds[D][0]
    tape, cx, rv = _circle(fidget_tpu)
    mesh = ref_sh.make_mesh(D)
    size = fidget_tpu.ImageSize(FIT_N, FIT_N)
    target = np.asarray(ref_sh.render_sharded(
        tape, size, mesh, params={cx: FIT_TARGET[0], rv: FIT_TARGET[1]}))
    np.testing.assert_allclose(out["dense"], target, rtol=1e-5, atol=1e-6)
    theta = {cx: FIT_THETA[0], rv: FIT_THETA[1]}
    for pipeline in ("unrolled", "interp"):
        new, loss = ref_sh.fit_step(tape, size, mesh, theta, target,
                                    lr=FIT_LR, pipeline=pipeline,
                                    interpret=True)
        got = out[f"fit_{pipeline}"]
        np.testing.assert_allclose(got[2], loss, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(
            got[:2], [float(new[cx]), float(new[rv])], rtol=1e-4, atol=1e-5
        )


@pytest.mark.parametrize("D", WORLDS)
def test_frames_match_reference(worlds, ref, D):
    fidget_tpu, ref_sh = ref
    out = worlds[D][0]
    mesh = ref_sh.make_mesh(D)
    size = fidget_tpu.ImageSize(*SIZE2)
    ring = _ring(fidget_tpu)
    for ts in ((32,), (32, 16)):
        tag = "x".join(map(str, ts))
        img = ref_sh.render_tiles_sharded(ring, size, mesh, tile_sizes=ts,
                                          interpret=True)
        fill = out[f"tiles_{tag}_fill"]
        np.testing.assert_array_equal(fill, np.asarray(img.fill))
        ev = fill == 0
        np.testing.assert_allclose(out[f"tiles_{tag}_distance"][ev],
                                   np.asarray(img.distance)[ev],
                                   rtol=1e-5, atol=1e-6)
    img, counts = ref_sh.render_unrolled_sharded(
        _skewed(fidget_tpu), size, mesh, interpret=True, _debug_counts=True
    )
    np.testing.assert_array_equal(out["skew_fill"], np.asarray(img.fill))
    np.testing.assert_array_equal(out["skew_counts"], np.asarray(counts))
    ev = out["skew_fill"] == 0
    np.testing.assert_allclose(out["skew_distance"][ev],
                               np.asarray(img.distance)[ev],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("D", WORLDS)
def test_voxels_match_reference(worlds, ref, D):
    fidget_tpu, ref_sh = ref
    from fidget_tpu_torch.scenes import gyroid_sphere

    out = worlds[D][0]
    mesh = ref_sh.make_mesh(D)
    size = fidget_tpu.VoxelSize(*_size3(D))
    shape = gyroid_sphere(fidget_tpu)
    img = ref_sh.render_voxels_sharded(
        shape, size, mesh, tile_size=TILE3, sub_size=SUB3, mode="normals",
        interpret=True,
    )
    for binding in BINDINGS3:
        np.testing.assert_array_equal(out[f"vox_{binding}_depth"],
                                      np.asarray(img.depth))
    np.testing.assert_allclose(out["vox_per_shape_normal"],
                               np.asarray(img.normal), rtol=1e-4, atol=1e-4)


# ----------------------------------------------------------------------
# in-process: the slab entry points and make_mesh


@pytest.mark.parametrize("binding", [
    dict(specialize=False), dict(), dict(leaf="unrolled"),
    dict(leaf="unrolled", proofs="unrolled"),
], ids=["bucketed", "per_shape", "unrolled_leaf", "unrolled_proofs"])
def test_voxel_slab_equals_the_rows_of_the_whole_frame(binding):
    """`y_base`: a slab of root-tile rows renders exactly the matching
    rows of the whole frame, depth and normals, under every binding."""
    import torch

    import fidget_tpu_torch as port
    from fidget_tpu_torch.scenes import gyroid_sphere

    rot = np.eye(4)
    c, s = np.cos(0.4), np.sin(0.4)
    rot[0, 0], rot[0, 2], rot[2, 0], rot[2, 2] = c, s, -s, c
    r = port.VoxelRenderer(gyroid_sphere(port), port.VoxelSize(32, 48, 32),
                           tile_size=TILE3, sub_size=SUB3, device="cpu",
                           **binding)
    matM, vec = r._mat4(rot), r._var_vec(None)
    depth, normal, _ = r._frame(matM, vec)
    st = r.geo.statics(r.device)
    grid = (r.ntz, r.geo.nty, r.geo.ntx)
    for ty in range(r.geo.nty):
        tiles = [st[k].reshape(grid)[:, ty:ty + 1].reshape(-1)
                 for k in ("tile_x0", "tile_y0", "tile_z0")]
        d, n, _ = r._frame_tiles(matM, vec, *tiles, mode="normals",
                                 cap=r.cap)
        rows = slice(ty * TILE3, (ty + 1) * TILE3)
        assert torch.equal(d, depth[rows])
        assert torch.equal(n, normal[rows])
    assert (depth > 0).any()


@pytest.mark.parametrize("ts", [(32,), (32, 16)], ids=["one_level",
                                                       "two_level"])
def test_pixel_slab_equals_the_rows_of_the_whole_frame(ts):
    import torch

    import fidget_tpu_torch as port

    r = port.PixelRenderer(_ring(port), port.ImageSize(*SIZE2),
                           tile_sizes=ts, specialize=True, device="cpu")
    mat = torch.as_tensor(r._mat4(None))
    z = torch.tensor(0.0)
    vec = torch.as_tensor(r._var_vec(None))
    img, fill = r._frame(mat, 0.0, vec)
    x0 = r._x0.reshape(r.n0y, r.n0x)
    y0 = r._y0.reshape(r.n0y, r.n0x)
    for ty in range(r.n0y):
        si, sf = r._frame_tiles(mat, z, vec, x0[ty].contiguous(),
                                y0[ty].contiguous(), pixel_perfect=False)
        rows = slice(ty * r.T0, (ty + 1) * r.T0)
        assert torch.equal(si, img[rows]) and torch.equal(sf, fill[rows])


def test_make_mesh_without_a_process_group_raises():
    from fidget_tpu_torch.parallel.sharding import make_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(device="cpu")


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
