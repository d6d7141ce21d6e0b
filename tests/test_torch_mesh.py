"""The port's `build_mesh` against fidget_tpu's, on the CPU.

The cases of tests/test_mesh.py, each built by the port on the plain
PyTorch versions of its kernels (`Settings(device="cpu")`) and, where
the reference can build the same mesh in interpret mode, held to it:
triangles equal and vertices within 1e-5. Shapes go from the reference
to the port as tape fields (`Tape.from_arrays`), or are built with the
graph API both packages share. The native QEF solve is held to a LAPACK
truncated SVD.
"""

import io

import numpy as np
import pytest

import fidget_tpu as ref
from fidget_tpu.mesh import Settings as RefSettings
from fidget_tpu.mesh import build_mesh as ref_build_mesh

import fidget_tpu_torch as port
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.mesh import Mesh, Settings, build_mesh, write_stl
from fidget_tpu_torch.mesh.tables import (
    CELL_TO_EDGE_TO_VERT,
    CELL_TO_VERT_TO_EDGES,
    VERT_COUNT,
)
from test_torch_grad import port_tape_with_vars


def sphere_tape(pkg, r=0.6):
    ctx = pkg.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    r2 = ctx.add(ctx.square(x), ctx.add(ctx.square(y), ctx.square(z)))
    return pkg.lower(ctx, [ctx.sub(ctx.sqrt(r2), r)])


def gyroid_shape(pkg):
    """tests/test_mesh.py's gyroid clipped to a sphere."""
    x, y, z = pkg.Tree.axes()
    s = 4.0
    g = ((x * s).sin() * (y * s).cos() + (y * s).sin() * (z * s).cos()
         + (z * s).sin() * (x * s).cos())
    return pkg.Shape.from_tree(
        (abs(g) - 0.2).max((x.square() + y.square() + z.square()).sqrt() - 0.8)
    )


def _manifold_stats(mesh):
    t = mesh.triangles
    v = mesh.vertices
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    e.sort(axis=1)
    _, counts = np.unique(
        e[:, 0].astype(np.int64) * len(v) + e[:, 1], return_counts=True
    )
    return counts


def _same_mesh(got, want):
    """Triangles equal, vertices within 1e-5."""
    np.testing.assert_array_equal(got.triangles, want.triangles)
    assert got.vertices.shape == want.vertices.shape
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-5)


def _both(tape_ref, **kw):
    """(port mesh, reference mesh) of one reference tape."""
    got = build_mesh(port_tape_with_vars(tape_ref), Settings(device="cpu", **kw))
    want = ref_build_mesh(tape_ref, RefSettings(interpret=True, **kw))
    return got, want


def _area(m):
    v, t = m.vertices, m.triangles
    n = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    return 0.5 * np.linalg.norm(n, axis=1).sum()


def test_tables_match_reference():
    from fidget_tpu.mesh import tables as rt

    assert len(CELL_TO_VERT_TO_EDGES) == 256
    assert VERT_COUNT[0] == 0 and VERT_COUNT[255] == 0
    np.testing.assert_array_equal(VERT_COUNT, rt.VERT_COUNT)
    np.testing.assert_array_equal(CELL_TO_EDGE_TO_VERT, rt.CELL_TO_EDGE_TO_VERT)
    assert CELL_TO_VERT_TO_EDGES == rt.CELL_TO_VERT_TO_EDGES


@pytest.mark.parametrize("collapse", [False, True])
def test_sphere_mesh(collapse):
    mesh, want = _both(sphere_tape(ref, 0.6), depth=5, collapse=collapse)
    _same_mesh(mesh, want)
    assert len(mesh.triangles) > 1000
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert r.min() > 0.58 and r.max() < 0.62
    # closed 2-manifold: every edge used exactly twice
    assert (_manifold_stats(mesh) == 2).all()
    # consistent outward winding
    v, t = mesh.vertices, mesh.triangles
    n = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
    c = (v[t[:, 0]] + v[t[:, 1]] + v[t[:, 2]]) / 3
    assert ((n * c).sum(1) > 0).all()
    assert _area(mesh) == pytest.approx(4 * np.pi * 0.36, rel=0.01)


def test_sphere_mesh_with_camera_transform():
    mat = np.eye(4)
    mat[:3, :3] *= 2.0  # world [-1,1] views model [-2,2]
    mat[0, 3] = 0.5

    def shape(pkg):
        return pkg.Shape.from_tree(
            (pkg.Tree.x().square() + pkg.Tree.y().square()
             + pkg.Tree.z().square()).sqrt() - 1.5
        )

    mesh = build_mesh(shape(port),
                      Settings(depth=5, world_to_model=mat, device="cpu"))
    want = ref_build_mesh(shape(ref),
                          RefSettings(depth=5, world_to_model=mat, interpret=True))
    _same_mesh(mesh, want)
    c = np.array([-0.25, 0.0, 0.0])
    r = np.linalg.norm(mesh.vertices - c, axis=1)
    assert r.min() > 0.72 and r.max() < 0.78


def test_mesh_with_var():
    def shape(pkg):
        rv = pkg.Var.new()
        t = (pkg.Tree.x().square() + pkg.Tree.y().square()
             + pkg.Tree.z().square()).sqrt() - pkg.Tree.var(rv)
        return pkg.Shape.from_tree(t), rv

    shape_p, rv_p = shape(port)
    shape_r, rv_r = shape(ref)
    mesh = build_mesh(shape_p, Settings(depth=4, vars={rv_p: 0.5}, device="cpu"))
    want = ref_build_mesh(shape_r, RefSettings(depth=4, vars={rv_r: 0.5},
                                               interpret=True))
    _same_mesh(mesh, want)
    r = np.linalg.norm(mesh.vertices, axis=1)
    assert r.min() > 0.45 and r.max() < 0.55
    with pytest.raises(ValueError, match="unbound"):
        build_mesh(shape_p, Settings(depth=3, device="cpu"))


def test_gyroid_mesh_manifold():
    mesh = build_mesh(gyroid_shape(port), Settings(depth=5, collapse=False,
                                                   device="cpu"))
    assert len(mesh.triangles) > 2000
    assert (_manifold_stats(mesh) == 2).mean() > 0.99


def test_collapse_keeps_gyroid_manifold_and_matches_reference():
    mesh = build_mesh(gyroid_shape(port), Settings(depth=4, device="cpu"))
    want = ref_build_mesh(gyroid_shape(ref), RefSettings(depth=4, interpret=True))
    _same_mesh(mesh, want)
    mesh = build_mesh(gyroid_shape(port), Settings(depth=5, device="cpu"))
    assert len(mesh.triangles) > 1000
    assert (_manifold_stats(mesh) == 2).mean() > 0.99


def test_empty_mesh():
    ctx = port.Context()
    tape = port.lower(ctx, [ctx.add(ctx.square(ctx.x()), 1.0)])  # never < 0
    mesh = build_mesh(tape, Settings(depth=4, device="cpu"))
    assert len(mesh.vertices) == 0 and len(mesh.triangles) == 0


def test_stl_roundtrip():
    mesh = build_mesh(sphere_tape(port, 0.5), Settings(depth=4, device="cpu"))
    buf = io.BytesIO()
    write_stl(mesh, buf)
    data = buf.getvalue()
    assert len(data) == 84 + 50 * len(mesh.triangles)
    (n,) = np.frombuffer(data[80:84], "<u4")
    assert n == len(mesh.triangles)
    rec = np.frombuffer(data[84 : 84 + 48], "<f4")
    np.testing.assert_allclose(
        rec[3:6], mesh.vertices[mesh.triangles[0, 0]], rtol=1e-6
    )
    sbuf = io.StringIO()
    mesh.write_obj(sbuf)
    lines = sbuf.getvalue().splitlines()
    vs = [l for l in lines if l.startswith("v ")]
    fs = [l for l in lines if l.startswith("f ")]
    assert len(vs) == len(mesh.vertices) and len(fs) == len(mesh.triangles)
    got = np.array([float(t) for t in vs[0].split()[1:]])
    np.testing.assert_allclose(got, mesh.vertices[0], rtol=1e-6)
    idx = np.array([int(t) for t in fs[0].split()[1:]]) - 1
    np.testing.assert_array_equal(idx, mesh.triangles[0])


def test_collapse_box_to_minimal():
    from fidget_tpu.shapes import Box

    tape = ref.Shape.from_tree(
        Box((-0.61, -0.61, -0.61), (0.59, 0.62, 0.63)).to_tree()
    ).tape()
    full, full_ref = _both(tape, depth=5, collapse=False)
    merged, merged_ref = _both(tape, depth=5, collapse=True)
    _same_mesh(full, full_ref)
    _same_mesh(merged, merged_ref)
    assert len(merged.triangles) == 12 and len(merged.vertices) == 8
    assert (_manifold_stats(merged) == 2).all()
    assert _area(merged) == pytest.approx(_area(full), rel=1e-3)


def test_collapse_mixed_flat_and_curved():
    from fidget_tpu.shapes import Box, Difference, Sphere

    tape = ref.Shape.from_tree(
        Difference(
            Box((-0.7, -0.7, -0.7), (0.7, 0.7, 0.7)), Sphere(radius=0.8)
        ).to_tree()
    ).tape()
    full = build_mesh(port_tape_with_vars(tape),
                      Settings(depth=5, collapse=False, device="cpu"))
    merged, want = _both(tape, depth=5, collapse=True)
    _same_mesh(merged, want)
    assert len(merged.triangles) < 0.8 * len(full.triangles)
    assert (_manifold_stats(merged) == 2).all()


def test_ambiguous_face_pinch_topology(monkeypatch):
    """tests/test_mesh.py's fuzz seed 1424: an ambiguous face pinches the
    surface as the reference's does (count <= 4, direction imbalance
    <= 1, one edge used 3 times).

    This tape takes a MOD at a point where its exact remainder is a
    tiny negative number: rem_euclid gives |b| there in f32 (as Rust
    does, and both packages' host evaluators), the reference's Pallas
    kernel 0 (its eval/softmath.py fmod wraps a + |b| == |b| to 0).
    So the reference's kernel and the port differ on a few edge-search
    samples, and their meshes differ. Held instead: every sign the
    port's evaluator gives during the build equals the reference's
    host evaluator (`eval_tape`, f32 numpy), and wherever the
    reference's kernel differs from the port, it differs from its own
    host evaluator too."""
    from fidget_tpu.compiler.tape import TapeOp
    from fidget_tpu.eval.arith import FloatMode
    from fidget_tpu.eval.bulk import BulkEvaluator as RefBulk
    from fidget_tpu.eval.unrolled import eval_tape
    from test_fuzz import random_tape

    from fidget_tpu_torch.eval import bulk

    tape = random_tape(1424, dims=3)
    assert int(TapeOp.MOD) in tape.op.tolist()
    calls = []
    real_eval = bulk.BulkEvaluator.eval

    def recording_eval(self, x, y, z, var_vec=None, *, signs=False):
        out = real_eval(self, x, y, z, var_vec, signs=signs)
        calls.append(([np.asarray(a, np.float32).copy() for a in (x, y, z)],
                      out.numpy().copy()))
        return out

    monkeypatch.setattr(bulk.BulkEvaluator, "eval", recording_eval)
    mesh = build_mesh(port_tape_with_vars(tape), Settings(depth=4, device="cpu"))
    monkeypatch.undo()
    rev = RefBulk(tape, interpret=True)
    kernel_faults = 0
    for (x, y, z), got in calls:
        inputs = [None] * 3
        for v, i in tape.var_map.items():
            inputs[i] = {"x": x, "y": y, "z": z}[v.kind]
        with np.errstate(all="ignore"):
            (host,), _ = eval_tape(tape, FloatMode(np), inputs)
        np.testing.assert_array_equal(got[0], host < 0)
        ref_kernel = np.asarray(rev.eval(x, y, z, signs=True))[0]
        differs = ref_kernel != got[0]
        assert (ref_kernel[differs] != (host < 0)[differs]).all()
        kernel_faults += int(differs.sum())
    assert kernel_faults > 0  # the reference's kernel fault shows here

    t = mesh.triangles
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    und = np.sort(e, axis=1)
    uniq, inv, counts = np.unique(
        und, axis=0, return_inverse=True, return_counts=True
    )
    assert counts.max() == 3
    assert (counts <= 4).all()
    fwd = np.bincount(inv, weights=(e[:, 0] < e[:, 1]), minlength=len(uniq))
    assert (np.abs(2 * fwd - counts) <= 1).all()


def test_mesh_settings_validation_and_pathlike_writers(tmp_path):
    tape = sphere_tape(port)
    with pytest.raises(ValueError, match="depth"):
        build_mesh(tape, Settings(depth=11, device="cpu"))
    with pytest.raises(ValueError, match="eval"):
        build_mesh(tape, Settings(depth=3, device="cpu", eval="unroled"))
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        build_mesh(tape, Settings(depth=3, device="cpu", eval="unrolled"))
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_mesh(tape, Settings(depth=3))
    cuda.reset_launches()
    m = build_mesh(tape, Settings(depth=3, device="cpu"))
    assert isinstance(m, Mesh) and sum(cuda.LAUNCHES.values()) == 0
    p = tmp_path / "out.stl"
    m.write_stl(p)
    assert p.stat().st_size > 84
    po = tmp_path / "out.obj"
    m.write_obj(po)
    assert po.read_text().startswith("v ")


def test_qef_solve_matches_svd():
    """The native solve (the port has no other) against a LAPACK
    truncated-SVD solve on every multiplicity pattern, including the
    repeated dominant eigenvalue of box edges (tests/test_mesh.py's
    cases, the same tolerance)."""
    from fidget_tpu_torch.mesh.collapse import _solve_qef

    def svd_ref(AtA, Atb, mass):
        rhs = Atb - np.einsum("vij,vj->vi", AtA, mass)
        U, S, Vt = np.linalg.svd(AtA)
        keep = S > np.maximum(S[:, :1] * 1e-3, 1e-12)
        sinv = np.divide(1.0, S, out=np.zeros_like(S), where=keep)
        delta = np.einsum(
            "vji,vj->vi", Vt, sinv * np.einsum("vij,vi->vj", U, rhs)
        )
        v = mass + delta
        return np.where(np.isfinite(v), v, mass)

    rng = np.random.default_rng(0)
    N = 500
    cases = []
    for rank in (3, 2, 1):
        M = rng.normal(size=(N, rank, 3))
        cases.append(np.einsum("vkj,vki->vji", M, M))
    cases.append(
        np.repeat(np.eye(3)[None], N, 0) * rng.uniform(0.5, 2, (N, 1, 1))
    )
    cases.append(np.zeros((N, 3, 3)))
    for pat in ([0, 1, 1], [1, 1, 0], [1, 0, 1], [0, 0, 1]):
        c = rng.uniform(1, 20, (N, 1))
        d = np.zeros((N, 3, 3))
        d[:, [0, 1, 2], [0, 1, 2]] = np.asarray(pat)[None] * c
        cases.append(d)
    qr = np.linalg.qr(rng.normal(size=(N, 3, 3)))[0]
    dd = np.zeros((N, 3, 3))
    dd[:, 0, 0] = dd[:, 1, 1] = rng.uniform(1, 20, N)
    cases.append(np.einsum("vij,vjk,vlk->vil", qr, dd, qr))
    AtA = np.concatenate(cases)
    n = len(AtA)
    Atb = rng.normal(size=(n, 3))
    mass = rng.normal(size=(n, 3)) * 0.1
    np.testing.assert_allclose(
        _solve_qef(AtA, Atb, mass), svd_ref(AtA, Atb, mass),
        rtol=1e-7, atol=1e-9,
    )
