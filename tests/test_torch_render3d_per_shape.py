"""The port's per-shape 3D pipeline and its compiled frames against
fidget_tpu's, on the CPU.

`VoxelRenderer(device="cpu")` (specialize=True, the default) runs the
per-shape binding `_ConstBind3` on the plain PyTorch versions of the
kernels; the reference runs its own `_ConstBind3` frame with its Pallas
kernels in interpret mode. Stage by stage: opcode order and packed
arena equal; root intervals allclose (rtol 1e-6) and choice words
exact; root-simplified tapes and every stratum's re-specialized leaf
tapes word for word; depth exact; normals allclose (1e-5). Then the
per-stratum capacity schedules (host counts and tuples equal to the
reference's), the unrolled leaf and proofs (`leaf="unrolled"`, U1-3D;
`proofs="unrolled"`, U2-3D) against the reference's same modes and
`render_brute`, the plain versions of the two generated 3D kernels
against the reference's expressions, the constructor's refusals, the
asynchronous warm-up and the emitter.
"""

import hashlib
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.eval import simplify_device as ref_sd
from fidget_tpu.eval.arith import IntervalMode as RefIntervalMode
from fidget_tpu.eval.pallas_interp import tape_n_ops
from fidget_tpu.render import render3d as ref_r3d
import fidget_tpu_torch as port
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval import unrolled_cuda as uc
from fidget_tpu_torch.render import render3d
from fidget_tpu_torch.render import unrolled2d as u2
from fidget_tpu_torch.scenes import gyroid_sphere, sphere_union_shape
from test_torch_compiler import port_tape_from_ref

REF_GYROID = gyroid_sphere(ref).tape()
PORT_GYROID = port_tape_from_ref(REF_GYROID)

#: a rotation about z and x with a small shift (test_torch_render3d.TURN)
TURN = np.array([
    [0.96, -0.28, 0.0, 0.05],
    [0.2688, 0.9216, -0.28, -0.03],
    [0.0784, 0.2688, 0.96, 0.02],
    [0.0, 0.0, 0.0, 1.0],
])


def _sphere(pkg, r):
    ctx = pkg.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    r2 = ctx.add(ctx.square(x), ctx.add(ctx.square(y), ctx.square(z)))
    return pkg.lower(ctx, [ctx.sub(ctx.sqrt(r2), r)])


def _pair(ref_tape, n, ts, sub, **kw):
    size = (n, n, n)
    rr = ref_r3d.VoxelRenderer(ref_tape, ref_r3d.VoxelSize(*size),
                               tile_size=ts, sub_size=sub, interpret=True,
                               **kw)
    pr = port.VoxelRenderer(port_tape_from_ref(ref_tape),
                            port.VoxelSize(*size), tile_size=ts,
                            sub_size=sub, device="cpu", **kw)
    return rr, pr


def _ref_args(rr, view):
    return (jnp.asarray(rr._mat4(view)), jnp.asarray(rr._var_vec(None)),
            jnp.asarray(rr.tile_x0), jnp.asarray(rr.tile_y0),
            jnp.asarray(rr.tile_z0))


def _ref_frame_and_leaf_tapes(rr, view, monkeypatch):
    """The reference's whole frame through `render()` (jitted, strata in
    its `lax.scan`), with the re-specialized leaf tapes of every stratum,
    nearest first, handed out of the scan by `jax.debug.callback` (its
    `DynamicSimplifier.reconstruct` outputs, w1 / w2 / imm / lengths)."""
    seen = []
    real = ref_sd.DynamicSimplifier.reconstruct

    def record(*arrays):
        seen.append(tuple(np.asarray(a) for a in arrays))

    def recorder(*args, **kwargs):
        out = real(*args, **kwargs)
        jax.debug.callback(record, *out[:4], ordered=True)
        return out

    monkeypatch.setattr(ref_sd.DynamicSimplifier, "reconstruct",
                        staticmethod(recorder))
    img = rr.render(view, mode="normals")
    monkeypatch.setattr(ref_sd.DynamicSimplifier, "reconstruct",
                        staticmethod(real))
    return img, seen


@pytest.mark.parametrize(
    "ts,sub,view", [(16, 8, None), (32, 16, None), (32, 16, TURN)],
    ids=["k3-leaf", "k5-leaf", "k5-leaf-turned"],
)
def test_per_shape_stages_match_reference(ts, sub, view, monkeypatch):
    rr, pr = _pair(REF_GYROID, 32, ts, sub)
    assert pr.specialize and rr.specialize
    assert tuple(pr.op_order) == tuple(rr.op_order)
    assert tuple(pr.op_order) != tuple(range(len(pr.op_order)))
    for f in ("w1", "w2", "imm", "lengths"):
        np.testing.assert_array_equal(getattr(pr.packed, f),
                                      getattr(rr.packed, f))
    assert pr.nops_s == tape_n_ops(rr.tape, rr.op_order)
    mat, vec = pr._mat4(view), pr._var_vec(None)

    want = rr._frame_tiles(*_ref_args(rr, view), mode="normals", cap=rr.cap,
                           stop_after="root")
    got = pr._frame(mat, vec, stop_after="root")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))

    want = rr._frame_tiles(*_ref_args(rr, view), mode="normals", cap=rr.cap,
                           stop_after="simplify")
    got = pr._frame(mat, vec, stop_after="simplify")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    # the leaf tapes of every stratum, word for word
    want, want_leaf = _ref_frame_and_leaf_tapes(rr, view, monkeypatch)
    seen = []
    real = render3d.reconstruct

    def recorder(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append(tuple(a.numpy() for a in out[:4]))
        return out

    monkeypatch.setattr(render3d, "reconstruct", recorder)
    cuda.reset_launches()
    img = pr.render(view)
    assert cuda.LAUNCHES == {k: 0 for k in cuda.KERNELS}
    monkeypatch.setattr(render3d, "reconstruct", real)
    assert len(seen) == len(want_leaf) == pr.ntz
    assert any(int(w[3].sum()) for w in want_leaf)
    for g, w in zip(seen, want_leaf):
        for gf, wf in zip(g, w):
            np.testing.assert_array_equal(gf, wf)
    depth, normal = img.depth.numpy(), img.normal.numpy()
    np.testing.assert_array_equal(depth, want.depth)
    np.testing.assert_allclose(normal, want.normal, rtol=1e-5, atol=1e-5)
    assert 0 < (depth > 0).mean() < 1
    np.testing.assert_array_equal(depth, pr.render_brute(view).depth.numpy())


def test_every_kernel_call_gets_the_shapes_order(monkeypatch):
    """K1, K2 (per instance), `reconstruct`, K5 and K4 under the shape's
    `op_order` at the tape's own register file and choice words; the
    root codes through the simplifier, which holds the same order."""
    pr = port.VoxelRenderer(PORT_GYROID, port.VoxelSize(32, 32, 32),
                            tile_size=32, sub_size=16, device="cpu")
    seen = []

    def recorder(name, fn):
        def call(*args, **kwargs):
            seen.append((name, kwargs.get("op_order"), kwargs.get("nf"),
                         kwargs.get("c_words")))
            return fn(*args, **kwargs)
        return call

    for name in ("interp_interval", "interp_voxel_depth", "interp_grad",
                 "per_instance_codes", "reconstruct"):
        monkeypatch.setattr(render3d, name,
                            recorder(name, getattr(render3d, name)))
    pr.render(TURN)
    names = {name for name, *_ in seen}
    assert names == {"interp_interval", "interp_voxel_depth", "interp_grad",
                     "per_instance_codes", "reconstruct"}
    assert all(o == pr.op_order for _, o, _, _ in seen)
    assert {nf for n, _, nf, _ in seen if nf is not None} == {pr.nf}
    assert {cw for n, _, _, cw in seen if n == "interp_interval"} == {
        pr.c_words}
    assert pr.simplifier.op_order == pr.op_order
    assert (pr.nf, pr.c_words) != (pr.nf_b, pr.cw_b)


# ----------------------------------------------------------------------
# per-stratum capacity schedules


@pytest.mark.parametrize(
    "which,n,ts,sub,view",
    [("sphere", 64, 16, 8, None), ("gyroid", 64, 16, 8, TURN)],
    ids=["sphere", "turned-gyroid"],
)
def test_strata_schedule_matches_reference(which, n, ts, sub, view):
    tape = _sphere(ref, 0.5) if which == "sphere" else REF_GYROID
    rr, pr = _pair(tape, n, ts, sub)
    mat, vec = pr._mat4(view), pr._var_vec(None)
    counts = pr._host_strata_counts(mat, vec)
    np.testing.assert_array_equal(counts, rr._host_strata_counts(mat, vec))
    assert counts.sum() > 0 and len(counts) == pr.ntz
    for kw in ({}, {"max_segments": 2}, {"headroom": 1.5, "quantum": 32}):
        got = pr.strata_schedule(mat, vec, **kw)
        assert got == rr.strata_schedule(mat, vec, **kw), kw
        assert len(got) == pr.ntz


def test_strata_schedule_matches_uniform():
    """tests/test_render3d.py::test_strata_schedule_matches_uniform on
    the port: the scheduled frame equals the uniform one, render() adopts
    the schedule after the first frame, a starved schedule reports its
    overflow and render() recovers by rebuilding."""
    r = port.VoxelRenderer(_sphere(port, 0.5), port.VoxelSize(64, 64, 64),
                           tile_size=16, sub_size=8, device="cpu")
    img1 = r.render(mode="heightmap")  # uniform; builds the schedule
    assert r._sched is not None and len(r._sched) == r.ntz
    assert sum(r._sched) < r.ntz * min(r.cap, r.nl * r.ny2 * r.nx2)
    img2 = r.render(mode="heightmap")  # scheduled
    np.testing.assert_array_equal(img1.depth.numpy(), img2.depth.numpy())
    mat, vec = r._mat4(None), r._var_vec(None)
    depth, _, n_over = r._frame(mat, vec, mode="heightmap",
                                strata_caps=r._sched)
    assert int(n_over) == 0
    np.testing.assert_array_equal(depth.numpy(), img1.depth.numpy())
    tiny = tuple(8 for _ in r._sched)
    _, _, n_over2 = r._frame(mat, vec, mode="heightmap", strata_caps=tiny)
    assert int(n_over2) > 0
    r._sched = tiny
    img3 = r.render(mode="heightmap")
    np.testing.assert_array_equal(img3.depth.numpy(), img1.depth.numpy())
    assert r._sched is not None and r._sched != tiny
    np.testing.assert_array_equal(img1.depth.numpy(),
                                  r.render_brute().depth.numpy())
    with pytest.raises(ValueError, match="strata_caps"):
        r._frame(mat, vec, strata_caps=(64,))


def test_no_schedule_off_the_per_shape_path():
    r = port.VoxelRenderer(_sphere(port, 0.5), port.VoxelSize(64, 64, 64),
                           tile_size=16, sub_size=8, specialize=False,
                           device="cpu")
    r.render(mode="heightmap")
    assert r._sched is None


# ----------------------------------------------------------------------
# the unrolled leaf and proofs


@pytest.mark.parametrize("proofs", ["interp", "unrolled"])
@pytest.mark.parametrize("n,ts,sub", [(64, 32, 8), (32, 32, 16)],
                         ids=["64-32-8", "32-32-16"])
def test_unrolled_modes_match_reference_and_brute(n, ts, sub, proofs):
    rr, pr = _pair(REF_GYROID, n, ts, sub, leaf="unrolled", proofs=proofs)
    cuda.reset_launches()
    img = pr.render(TURN)
    assert cuda.LAUNCHES == {k: 0 for k in cuda.KERNELS}
    want = rr.render(TURN, mode="normals")
    depth = img.depth.numpy()
    np.testing.assert_array_equal(depth, want.depth)
    np.testing.assert_array_equal(depth, pr.render_brute(TURN).depth.numpy())
    hit = (depth > 0) & (depth < pr.D)
    assert hit.any()
    normal = img.normal.numpy()
    np.testing.assert_allclose(np.linalg.norm(normal[hit], axis=-1), 1.0,
                               atol=1e-4)
    np.testing.assert_allclose(normal, want.normal, rtol=1e-4, atol=1e-4)
    # the interpreter frame of the same shape gives the same image
    pi = port.VoxelRenderer(PORT_GYROID, port.VoxelSize(n, n, n),
                            tile_size=ts, sub_size=sub, device="cpu")
    ii = pi.render(TURN)
    np.testing.assert_array_equal(depth, ii.depth.numpy())
    np.testing.assert_allclose(normal, ii.normal.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_unrolled_frames_run_the_generated_kernels(monkeypatch):
    """Under the unrolled leaf no subtile is re-specialized (K2 runs only
    at the root) and U1-3D's frame entry (`unrolled_voxel_fold`) serves
    each stratum once; under unrolled proofs neither K1 nor K2 nor
    `reconstruct` runs, and U2-3D's frame entry (`unrolled_proofs3`)
    serves the roots and every subtile in one call a frame."""
    seen = []

    def recorder(name, fn):
        def call(*args, **kwargs):
            seen.append(name)
            return fn(*args, **kwargs)
        return call

    names = ("interp_interval", "interp_voxel_depth", "interp_float",
             "per_instance_codes", "reconstruct", "unrolled_voxel_fold",
             "unrolled_proofs3", "interp_grad")
    for name in names:
        monkeypatch.setattr(render3d, name,
                            recorder(name, getattr(render3d, name)))
    sd = render3d.DeviceSimplifier
    monkeypatch.setattr(sd, "codes_per_tile",
                        recorder("codes_per_tile", sd.codes_per_tile))
    got = {}
    for proofs in ("interp", "unrolled"):
        pr = port.VoxelRenderer(PORT_GYROID, port.VoxelSize(32, 32, 32),
                                tile_size=16, sub_size=8, leaf="unrolled",
                                proofs=proofs, device="cpu")
        seen.clear()
        pr.render(None)
        got[proofs] = set(seen)
        assert seen.count("unrolled_voxel_fold") == pr.ntz
        assert seen.count("unrolled_proofs3") == (proofs == "unrolled")
    assert got["interp"] == {"interp_interval", "codes_per_tile",
                             "unrolled_voxel_fold", "interp_grad"}
    assert got["unrolled"] == {"unrolled_proofs3", "unrolled_voxel_fold",
                               "interp_grad"}


def _boxes(n, rng, lo=0, hi=64, edge=8):
    return [torch.from_numpy(
        (rng.integers(lo, hi // edge, n) * edge).astype(np.float32))
        for _ in range(3)]


def _matrices():
    s2w = port.VoxelSize(64, 64, 64).screen_to_world().astype(np.float32)
    persp = np.eye(4)
    persp[3, 2] = 0.3
    return {"affine": (TURN @ s2w).astype(np.float32),
            "perspective": (persp @ TURN @ s2w).astype(np.float32)}


@pytest.mark.parametrize("matrix", ["affine", "perspective"])
@pytest.mark.parametrize("which", ["gyroid", "union"])
def test_plain_3d_kernels_match_the_reference(which, matrix):
    """`unrolled_interval3_plain` against `_unrolled_interval3` on random
    boxes (bounds at 1e-6, proofs exactly) and
    `unrolled_voxel_depth_plain` against the reference's unrolled
    `stratum_leaf` on a random worklist (depths exactly)."""
    if which == "gyroid":
        ref_tape = REF_GYROID
    else:
        ctx = ref.Context()
        ref_tape = ref.lower(ctx, [sphere_union_shape(ctx, n=20)])
    tape = port_tape_from_ref(ref_tape)
    axis_of = {v.kind: i for v, i in tape.var_map.items()}
    V = max(1, len(tape.var_map))
    mat = _matrices()[matrix]
    rng = np.random.default_rng(12)
    b = types.SimpleNamespace(V=V, axis_of=axis_of, tape=ref_tape,
                              leaf="unrolled")
    params = uc.params_tensor(torch.from_numpy(mat), torch.zeros(()),
                              torch.zeros(V))

    # U2-3D over boxes of two edges
    k3 = uc.Interval3Kernel(tape, axis_of, V)
    proven = active = 0
    for edge in (8, 32):
        x0, y0, z0 = _boxes(500, rng, edge=edge)
        lo, hi = uc.interval3_bounds(k3, x0, y0, z0, params, edge)
        wlo, whi = ref_r3d._unrolled_interval3(
            b, RefIntervalMode(jnp), jnp.asarray(mat), jnp.zeros(V),
            *[(jnp.asarray(c.numpy()), jnp.asarray(c.numpy() + edge))
              for c in (x0, y0, z0)],
        )
        np.testing.assert_allclose(lo.numpy(), np.asarray(wlo), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(hi.numpy(), np.asarray(whi), rtol=1e-6,
                                   atol=1e-7)
        full, empty = uc.unrolled_interval3(k3, x0, y0, z0, params, edge)
        np.testing.assert_array_equal(full.numpy(), np.asarray(whi) < 0)
        np.testing.assert_array_equal(empty.numpy(), np.asarray(wlo) > 0)
        proven += int((full | empty).sum())
        active += int((~(full | empty)).sum())
    assert proven and active

    # U1-3D over a worklist of subtiles, an invalid slot among them
    kv = uc.VoxelKernel(tape, axis_of, V)
    sub, n = 8, 96
    geo = ref_r3d._geo3(64, 64, 64, 32, sub)
    gx, gy, lz = (rng.integers(0, 8, n) for _ in range(3))
    lz = lz % geo.nl
    z_lo = np.float32(32.0)
    valid = np.arange(n) % 7 != 3
    got = uc.unrolled_voxel_depth(
        kv, torch.from_numpy((gx * sub).astype(np.float32)),
        torch.from_numpy((gy * sub).astype(np.float32)),
        torch.from_numpy((lz * sub).astype(np.float32) + z_lo),
        torch.from_numpy(valid), params, sub=sub,
    )
    idx = dict(gx=jnp.asarray(gx), gy=jnp.asarray(gy), lz=jnp.asarray(lz),
               valid=jnp.asarray(valid))
    want = geo.stratum_leaf(b, {}, {"z_lo": jnp.float32(z_lo)}, idx,
                            mat=jnp.asarray(mat), var_vec=jnp.zeros(V),
                            y_base=jnp.float32(0.0), cap_s=n)
    assert got.dtype == torch.int32 and got.shape == (n, sub, sub)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[~torch.from_numpy(valid)] == 0).all()
    assert len(got.unique()) > 2


def test_constructor_refusals():
    size = port.VoxelSize(64, 64, 64)
    with pytest.raises(ValueError, match="specialize"):
        port.VoxelRenderer(PORT_GYROID, size, leaf="unrolled",
                           specialize=False, device="cpu")
    with pytest.raises(ValueError, match="choice"):
        port.VoxelRenderer(PORT_GYROID, size, proofs="unrolled",
                           device="cpu")
    with pytest.raises(ValueError, match="leaf"):
        port.VoxelRenderer(PORT_GYROID, size, leaf="jit", device="cpu")
    with pytest.raises(ValueError, match="proofs"):
        port.VoxelRenderer(PORT_GYROID, size, proofs="jit", device="cpu")
    r = port.VoxelRenderer(PORT_GYROID, port.VoxelSize(32, 32, 32),
                           tile_size=16, sub_size=8, device="cpu")
    with pytest.raises(ValueError, match="warmup"):
        r.render(warmup="later")


def test_module_render_takes_the_modes():
    shape = gyroid_sphere(port)
    size = port.VoxelSize(32, 32, 32)
    base = port.render3d(shape, size, tile_size=16, sub_size=8,
                         specialize=False, device="cpu", mode="heightmap")
    for kw in ({}, {"leaf": "unrolled"},
               {"leaf": "unrolled", "proofs": "unrolled"}):
        img = port.render3d(shape, size, tile_size=16, sub_size=8,
                            device="cpu", mode="heightmap", **kw)
        np.testing.assert_array_equal(img.depth.numpy(), base.depth.numpy())
    with pytest.raises(ValueError, match="specialize"):
        port.render3d(shape, size, specialize=False, leaf="unrolled",
                      device="cpu")


def test_warmup_interp_serves_the_twin_then_switches(monkeypatch):
    """warmup="interp" under the unrolled modes: while the background
    build runs, frames come from the bucketed twin and equal brute; once
    it is done the compiled frame serves; a build that failed raises on
    the next call. (On a card `ready` sees a CUDA renderer; here it is
    handed one, and the build is a stand-in.)"""
    gate = threading.Event()
    state = {"built": False, "fail": False}

    def build(kernels):
        gate.wait(30)
        if state["fail"]:
            raise RuntimeError("nvcc failed for 1 generated unit(s)")
        state["built"] = True

    monkeypatch.setattr(u2, "build_kernels", build)
    monkeypatch.setattr(u2, "built", lambda kernels: state["built"])
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    monkeypatch.setattr(render3d, "ready",
                        lambda r, kernels, warmup: u2.ready(on_card, kernels,
                                                            warmup))
    # a shape of its own, so that no other test's build key is shared
    shape = gyroid_sphere(port).apply_transform(np.diag([1.01, 1, 1, 1]))
    r = port.VoxelRenderer(shape, port.VoxelSize(32, 32, 32), tile_size=16,
                           sub_size=8, leaf="unrolled", proofs="unrolled",
                           device="cpu")
    brute = r.render_brute(TURN).depth.numpy()
    served = []
    real_frame = render3d.VoxelRenderer._frame

    def frame(self, *args, **kwargs):
        served.append(self.specialize)
        return real_frame(self, *args, **kwargs)

    monkeypatch.setattr(render3d.VoxelRenderer, "_frame", frame)
    img = r.render(TURN, warmup="interp")
    assert served == [False] and r._twin.shape_transform is not None
    np.testing.assert_array_equal(img.depth.numpy(), brute)
    gate.set()
    key = u2._warm_key(r._generated_kernels())
    for _ in range(500):
        if u2._UWARM.get(key) == "ready":
            break
        time.sleep(0.01)
    served.clear()
    img = r.render(TURN, warmup="interp")
    assert served == [True]
    np.testing.assert_array_equal(img.depth.numpy(), brute)
    assert r._sched is None  # schedules are built under "block" only

    # a failed build raises on the next call; nothing falls back
    gate.clear()
    state.update(built=False, fail=True)
    r2 = port.VoxelRenderer(shape, port.VoxelSize(32, 32, 32), tile_size=16,
                            sub_size=8, leaf="unrolled", device="cpu")
    assert r2.render(warmup="interp") is not None  # the twin's frame
    gate.set()
    with pytest.raises(RuntimeError, match="nvcc"):
        for _ in range(500):
            r2.render(warmup="interp", mode="heightmap")
            time.sleep(0.01)


# ----------------------------------------------------------------------
# the emitter

#: sha256 of the 2D units' sources (`_2d_sources`) as the emitter wrote
#: them before the 3D variants were added: they must stay byte-identical
SOURCES_2D = "891c6a55a10cd0d86b9271648b19f9f7784627dc7dd53062c65e496560db44cd"


def _2d_sources():
    ctx = port.Context()
    union = port.lower(ctx, [sphere_union_shape(ctx, n=12)])
    out = []
    for tape in (gyroid_sphere(port).tape(), union):
        axis_of = {v.kind: i for v, i in tape.var_map.items()}
        V = max(1, len(tape.var_map))
        out.append(uc.emit_float_program(tape, V, "@"))
        out.append(uc.emit_float_kernel(["p0", "p1", "p1"], V, axis_of))
        for epi in uc.EPILOGUES:
            sched = uc.schedule_interval(tape, uc.INTERVAL_WARPS)
            for w in range(sched.k):
                out.append(uc.emit_interval_warp(sched, w, V, axis_of, epi,
                                                 "@"))
            for gw in (False, True):
                out.append(uc.emit_interval_kernel(
                    sched, V, axis_of, epi,
                    [f"w{i}" for i in range(sched.k)], gw))
    return out


def test_3d_units_and_unchanged_2d_sources():
    h = hashlib.sha256()
    for src in _2d_sources():
        assert "U_Z3" not in src and "U_VOXEL_KERNEL" not in src
        h.update(src.encode())
    assert h.hexdigest() == SOURCES_2D

    tape = PORT_GYROID
    axis_of = {v.kind: i for v, i in tape.var_map.items()}
    u1 = uc.FloatKernel([tape], axis_of, 3).unit()
    v1 = uc.VoxelKernel(tape, axis_of, 3).unit()
    assert v1.key != u1.key and "U_VOXEL_KERNEL" in v1.source
    assert "U_FLOAT_KERNEL" not in v1.source
    # U1's program unit is shared, not built twice
    assert [o.key for o in v1.objects] == [o.key for o in u1.objects]
    u2k = uc.IntervalKernel(tape, axis_of, 3, "proofs").unit()
    v2 = uc.Interval3Kernel(tape, axis_of, 3).unit()
    assert v2.key != u2k.key and "#define U_Z3 1" in v2.source
    assert "z0, params" in v2.source
    assert len(v2.objects) == len(u2k.objects)
    for a, b in zip(v2.objects, u2k.objects):
        assert a.key != b.key and "#define U_Z3 1" in a.source
        assert a.flags == b.flags == uc.INTERVAL_FLAGS
    assert uc.Interval3Kernel(tape, axis_of, 3).epilogue == "proofs"
    assert {"unrolled_voxel_depth", "unrolled_interval3"} <= set(cuda.KERNELS)


def test_3d_modules_import_no_jax():
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys, fidget_tpu_torch.render.render3d, "
        "fidget_tpu_torch.eval.unrolled_cuda\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fidget_tpu' or m.startswith('fidget_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
