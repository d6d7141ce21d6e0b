"""The port's compiled mesher against fidget_tpu's, on the CPU.

`build_mesh(Settings(eval="unrolled"))`: the device-resident fine stage
(`fidget_tpu_torch.mesh.fused`, on the plain versions of U1-P
`unrolled_points` / `unrolled_edges`, U2-B `level_active` and K4 here) against
the reference's `fidget_tpu.mesh.fused` with `Settings(interpret=True,
eval="unrolled")`, stage by stage and as whole meshes, under three
views: the identity, tests/test_mesh.py's scaled and offset camera, and
an oblique rotation (0.7 rad about (1, 2, 3)) whose coefficients mix
signs. Exact: the per-level counts, the compacted keys, the surface
keys and masks, the collapse round's topology and the triangles; and
U1-P's sign-table entries (`leaf_masks`, `merge_topo`, and the
table's contract through them) on their plain versions: masks,
topology, and a table that holds each distinct live point once with the
reference's sign.
Within tolerance: the edge core's QEF sums (rtol 1e-4, atol 1e-6) and
positions (1e-5), and the vertices (1e-5). The reference's f32 runs
through XLA on the CPU, which contracts a*b + c into one FMA and
rounds transcendentals its own way, where the port rounds each op (as
the card does); those differences stay inside the tolerances above.

Also `mesh/qef.py` against the reference's (numpy exactly, torch f64
and f32 against numpy and jnp), the plain versions of U1-P and U2-B
over tests/test_torch_unrolled.py's shapes against the reference's
`eval_tape_float_fast` / `eval_tape_interval_fast`, their live-count
masks, the emitter's units and keys, and `BulkEvaluator.eval_grad`'s
world seeds.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.eval import unrolled_fast as ref_fast
from fidget_tpu.mesh import Settings as RefSettings
from fidget_tpu.mesh import _get_evaluator as ref_evaluator
from fidget_tpu.mesh import build_mesh as ref_build_mesh
from fidget_tpu.mesh import fused as ref_fused
from fidget_tpu.mesh import qef as ref_qef

import fidget_tpu_torch as port
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval import unrolled_cuda as uc
from fidget_tpu_torch.mesh import Mesh, Settings, build_mesh
from fidget_tpu_torch.mesh import _get_evaluator as port_evaluator
from fidget_tpu_torch.mesh import fused
from fidget_tpu_torch.mesh import qef
from test_torch_mesh import _same_mesh, gyroid_shape, sphere_tape
from test_torch_unrolled import FAST_CASES, _boxes, _close, _tapes

DEPTH = 5


def _rotation(axis, angle):
    a = np.asarray(axis, np.float64)
    a /= np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    return m


def _camera():
    """tests/test_mesh.py's camera: world [-1, 1] views model [-2, 2],
    offset along x (the sphere of radius 1.5)."""
    m = np.eye(4)
    m[:3, :3] *= 2.0
    m[0, 3] = 0.5
    return m


#: view -> (world -> model matrix, sphere radius)
VIEWS = {
    "identity": (np.eye(4), 0.6),
    "camera": (_camera(), 1.5),
    "oblique": (_rotation((1, 2, 3), 0.7), 0.6),
}


# ----------------------------------------------------------------------
# qef.py


def _qef_inputs(n=3000, seed=0, shift=0.0):
    """Gram matrices of random rows (every rank, mixed conditioning),
    right-hand sides and mass points, float64."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, 3, 3))
    M[: n // 3, 2] = 0.0  # rank 2
    M[n // 3: n // 2, 1:] = 0.0  # rank 1
    A = np.einsum("nki,nkj->nij", M, M) + shift * np.eye(3)
    ata = tuple(A[:, i, j] for i, j in ((0, 0), (0, 1), (0, 2), (1, 1),
                                        (1, 2), (2, 2)))
    atb = tuple(rng.normal(size=n) for _ in range(3))
    mass = tuple(rng.normal(size=n) * 0.1 for _ in range(3))
    return ata, atb, mass


def _qef_all(xp, conv, ata, atb, mass):
    """(eigenvalues, solve, residual at the solve) of one namespace."""
    ata, atb, mass = (tuple(conv(a) for a in t) for t in (ata, atb, mass))
    mod = ref_qef if xp in (np, jnp) else qef
    w = mod.sym_eigvals3(xp, *ata)
    v = mod.solve_qef_c(xp, ata, atb, mass)
    e = mod.qef_err_c(xp, v, ata, atb, atb[0] * atb[0])
    return [np.asarray(a, np.float64) for a in (*w, *v, e)]


def test_qef_f64_matches_reference():
    """The port's module on numpy is the reference's, bit for bit; on
    torch float64 it agrees to libm rounding (rtol 1e-9, atol 1e-7 where
    an ill-conditioned solve amplifies a last-place acos / cos)."""
    ata, atb, mass = _qef_inputs()
    want = _qef_all(np, lambda a: a, ata, atb, mass)
    got_np = [np.asarray(a) for a in (
        *qef.sym_eigvals3(np, *ata), *qef.solve_qef_c(np, ata, atb, mass))]
    for g, w in zip(got_np, want):
        np.testing.assert_array_equal(g, w)
    got = _qef_all(torch, torch.from_numpy, ata, atb, mass)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-7)


@pytest.mark.parametrize("shift", [0.0, 2.0])
def test_qef_f32_matches_jnp(shift):
    """torch f32 against jnp f32 (the reference's device path). XLA's f32
    acos / cos / atan2 / sin and torch's round differently in the last
    place, and the closed-form solve amplifies that where AtA is
    ill-conditioned or an eigenvalue sits at the 1e-3 cutoff, so the
    float64 solve of the same f32 inputs is the witness (the
    trigonometric method's smaller eigenvalues lie up to ~1,000 f32 ulps
    of the matrix's scale from it, in both packages): eigenvalues,
    solves and residuals within rtol 1e-5 (atol 1e-6) of jnp's on 99% of
    the rows, and no farther from float64 than jnp's farthest."""
    ata, atb, mass = _qef_inputs(seed=1, shift=shift)
    f32 = [tuple(a.astype(np.float32) for a in t) for t in (ata, atb, mass)]
    exact = _qef_all(np, lambda a: a.astype(np.float64), *f32)
    want = _qef_all(jnp, jnp.asarray, *f32)
    got = _qef_all(torch, torch.from_numpy, *f32)
    for g, w, x in zip(got, want, exact):
        assert (np.abs(g - w) <= 1e-5 * np.abs(w) + 1e-6).mean() >= 0.99
        assert np.abs(g - x).max() <= 1.01 * np.abs(w - x).max() + 1e-6
    # the residual is arithmetic only: exactly the reference's at the
    # reference's solve
    v = tuple(torch.from_numpy(np.asarray(a, np.float32)) for a in want[3:6])
    t_ata, t_atb = (tuple(torch.from_numpy(a) for a in t) for t in f32[:2])
    j_ata, j_atb = (tuple(jnp.asarray(a) for a in t) for t in f32[:2])
    e_port = qef.qef_err_c(torch, v, t_ata, t_atb, t_atb[0])
    e_ref = ref_qef.qef_err_c(jnp, tuple(jnp.asarray(a.numpy()) for a in v),
                              j_ata, j_atb, j_atb[0])
    np.testing.assert_allclose(e_port.numpy(), np.asarray(e_ref), rtol=1e-5,
                               atol=1e-6)


# ----------------------------------------------------------------------
# the fine stage, core by core


class _Stages:
    """Both packages' cores over one view at DEPTH, run once: the
    checked chain of level cores and the leaf core from the same seed
    keys, then the edge core on the surface cells."""

    def __init__(self, view):
        m, radius = VIEWS[view]
        self.m = m
        self.rtape = sphere_tape(ref, radius)
        self.ptape = sphere_tape(port, radius)
        self.rev = ref_evaluator(self.rtape, True, True)
        self.pev = port_evaluator(self.ptape, "cpu", True)
        A = m[:3, :3].astype(np.float32)
        args = dict(pos=np.maximum(A, 0.0), neg=np.minimum(A, 0.0),
                    off3=m[:3, 3].astype(np.float32))
        self.mat = m[:3, :].astype(np.float32)
        vv = np.zeros(self.pev.n_inputs, np.float32)
        d0 = min(3, DEPTH - 1)
        g0 = np.arange(1 << d0, dtype=np.int32)
        gx, gy, gz = np.meshgrid(g0, g0, g0, indexing="ij")
        seed = ((gx.astype(np.int64) * fused._KS + gy) * fused._KS + gz
                ).reshape(-1).astype(np.int32)
        G = 1 << DEPTH
        self.cmax = cmax = fused._bucket_pow2(8 * G * G)
        keys0 = np.full(cmax, -1, np.int32)
        keys0[: len(seed)] = seed
        n_lv = DEPTH - d0
        rk, rn = jnp.asarray(keys0), jnp.int32(len(seed))
        rc = jnp.zeros(n_lv + 1, jnp.int32)
        pk = torch.from_numpy(keys0)
        pn = torch.tensor([len(seed)], dtype=torch.int32)
        self.pcvec = pc = torch.zeros(n_lv + 1, dtype=torch.int32)
        rcore = ref_fused.level_core(self.rev, cmax, cmax)
        t = {k: torch.from_numpy(v) for k, v in args.items()}
        self.levels = []
        for i, d in enumerate(range(d0, DEPTH)):
            hc = 2.0 / (1 << (d + 1))
            rk, rn, rc = rcore(rk, rn, rc, jnp.int32(i), jnp.float32(hc),
                               *(jnp.asarray(args[k]) for k in args),
                               jnp.asarray(vv))
            pk, pn = fused.level_core(self.pev, pk, pn, pc, i, hc, t["pos"],
                                      t["neg"], t["off3"],
                                      torch.from_numpy(vv), cmax)
            self.levels.append(((np.asarray(rk), int(rn)),
                                (pk.numpy().copy(), int(pn[0]))))
        self.h = h = 2.0 / G
        self.leaf_in = (pk, pn)  # the leaf cells and their count
        rsk, rsm, rns, self.rcvec = ref_fused.leaf_core(
            self.rev, cmax, cmax)(rk, rn, rc, jnp.int32(n_lv),
                                  jnp.float32(h), jnp.asarray(self.mat),
                                  jnp.asarray(vv))
        psk, psm, pns = fused.leaf_core(self.pev, pk, pn, pc, n_lv, h,
                                        torch.from_numpy(self.mat),
                                        torch.from_numpy(vv), cmax)
        self.surf = ((np.asarray(rsk), np.asarray(rsm), int(rns)),
                     (psk.numpy(), psm.numpy(), int(pns[0])))
        self.ns = ns = int(rns)
        self.cs = cs = fused._bucket_half(ns, lo=1024)
        self.rres = ref_fused.edges_core(self.rev, cmax, cs, 4, 16)(
            rsk, rsm, jnp.float32(h), jnp.asarray(self.mat), jnp.asarray(vv))
        self.pres = fused.edges_core(
            self.pev, psk, psm, pns, h, torch.from_numpy(self.mat),
            torch.from_numpy(vv), cs, 4, 16,
            torch.from_numpy(self.mat[:, :3]))


@pytest.fixture(scope="module")
def stages():
    cache = {}

    def get(view):
        if view not in cache:
            cache[view] = _Stages(view)
        return cache[view]

    return get


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_level_chain_matches_reference(stages, view):
    """Per-level counts (the count vector), compacted child keys, and
    the leaf core's surface keys and masks, exactly."""
    s = stages(view)
    for (rk, rn), (pk, pn) in s.levels:
        assert rn == pn and 0 < pn <= s.cmax
        np.testing.assert_array_equal(pk, rk)
    (rsk, rsm, rns), (psk, psm, pns) = s.surf
    assert rns == pns > 0
    np.testing.assert_array_equal(psk, rsk)
    np.testing.assert_array_equal(psm, rsm)
    np.testing.assert_array_equal(s.pcvec.numpy(), np.asarray(s.rcvec))


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_edges_core_matches_reference(stages, view):
    """The surface cells' QEF sums (rtol 1e-4, atol 1e-6), solved
    positions (1e-5), residuals and frame origins, over the live rows
    (4 * n_surf)."""
    s = stages(view)
    rows = 4 * s.ns
    got = {k: s.pres[k][:rows].numpy() for k in ("qef", "vpos", "verr",
                                                   "vorig")}
    want = {k: np.asarray(s.rres[k])[:rows] for k in got}
    np.testing.assert_allclose(got["qef"], want["qef"], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["vpos"], want["vpos"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["verr"], want["verr"], rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_array_equal(got["vorig"], want["vorig"])
    # the counts (column 13) are whole numbers of crossing edges
    np.testing.assert_array_equal(got["qef"][:, 13], want["qef"][:, 13])
    assert s.pres["qef"].shape == (5 * s.cs, 14)  # 4 slots + the extension
    # the distance at every crossing intersection is small against the
    # cell (the edge search's last bracket)
    lv = fused.CELL_TO_EDGE_TO_VERT[s.surf[1][1][: s.ns]].T
    d = s.pres["idist"][:, : s.ns].numpy()[lv >= 0]
    assert np.isfinite(d).all() and np.abs(d).max() < s.h


def _first_round(s):
    """The first collapse round's arguments (member ids, segments, parent
    corners, parent size) of the port's own collapse over a stage's
    surface."""
    from fidget_tpu_torch.mesh.collapse import collapse_and_walk

    _, (psk, psm, _) = s.surf
    ns = s.ns
    sk = psk[:ns].astype(np.int64)
    cells = np.stack([sk // fused._KS ** 2, (sk // fused._KS) % fused._KS,
                      sk % fused._KS], axis=1)
    mask = psm[:ns]
    rounds = []

    class Recording(fused.DeviceVertexStore):
        def merge_round(self, *args):
            rounds.append(args)
            return super().merge_round(*args)

    G = 1 << DEPTH
    crossing = fused.CELL_TO_EDGE_TO_VERT[mask] >= 0
    oci, oei = np.nonzero(crossing & ((np.arange(12) % 4) == 0)[None, :])
    store = Recording(s.pev, s.m, None, s.h, dict(s.pres), s.cs, DEPTH)
    collapse_and_walk(ev=s.pev, m=s.m, var_vec=None, G=G, h=s.h,
                      cells=cells, mask=mask,
                      nvert=fused.VERT_COUNT[mask],
                      voff=np.arange(ns + 1, dtype=np.int64) * 4,
                      oci=oci, oei=oei, store=store)
    assert rounds
    return rounds[0]


@pytest.mark.parametrize("view", ["identity", "oblique"])
def test_merge_round_matches_reference(stages, view):
    """One collapse round of the device store against the reference's:
    the first round's candidates of the port's own collapse, topology
    exactly, merged positions within 1e-5, residuals within rtol 1e-4."""
    s = stages(view)
    args = _first_round(s)
    fresh = {k: v.clone() for k, v in s.pres.items()}
    got = fused.DeviceVertexStore(s.pev, s.m, None, s.h, fresh, s.cs,
                                  DEPTH).merge_round(*args)
    want = ref_fused.DeviceVertexStore(s.rev, s.m, None, s.h, s.rres, s.cs,
                                       DEPTH).merge_round(*args)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def _ref_signs(s, keys):
    """The reference's `eval_tape_float_fast` sign at packed lattice keys
    (numpy int64): world k * h - 1 and the model point in f32, left to
    right as both packages form them."""
    ks = fused._KS
    world = [(c.astype(np.float32) * np.float32(s.h) - np.float32(1.0))
             for c in (keys // (ks * ks), keys // ks % ks, keys % ks)]
    model = [s.mat[r, 0] * world[0] + s.mat[r, 1] * world[1]
             + s.mat[r, 2] * world[2] + s.mat[r, 3] for r in range(3)]
    d = ref_fast.eval_tape_float_fast(s.rtape, [jnp.asarray(m)
                                                for m in model])[0]
    return np.broadcast_to(np.asarray(d), keys.shape) < 0


def _leaf_entry(s):
    """The leaf entry on a stage's leaf cells with a fresh table: (masks,
    the table)."""
    kern = fused._kernels(s.pev)["table"]
    keys, n = s.leaf_in
    table = uc.SignTable(8 * keys.shape[0], "cpu")
    mask = uc.leaf_masks(kern, keys, n, s.h, torch.from_numpy(s.mat),
                         torch.zeros(s.pev.n_inputs), table)
    return mask, table


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_leaf_entry_matches_reference(stages, view):
    """`leaf_masks` (its plain version here) on the leaf cells of the
    chain: the compacted surface cells and masks equal the reference's
    `leaf_core` exactly, dead cells get 0, and the table holds each
    distinct live corner once with the reference's sign there
    (count[0]: how many the kernel evaluates, against 8 a cell)."""
    s = stages(view)
    keys, n = s.leaf_in
    mask, table = _leaf_entry(s)
    cl = keys.shape[0]
    live = (torch.arange(cl) < n) & (keys >= 0)
    assert mask.dtype == torch.int32 and (mask[~live] == 0).all()
    surf = live & (mask != 0) & (mask != 255)
    sk, sm, ns = fused._compact_keys(surf, keys, s.cmax, mask)
    (rsk, rsm, rns), _ = s.surf
    assert int(ns[0]) == rns
    np.testing.assert_array_equal(sk.numpy(), rsk)
    np.testing.assert_array_equal(sm.numpy(), rsm)
    lk = keys[live].numpy().astype(np.int64)
    ks = fused._KS
    corners = np.unique(lk[:, None] + (fused._CORNER_OFF
                                       @ np.array([ks * ks, ks, 1]))[None])
    tk, ts = table.entries()
    np.testing.assert_array_equal(tk.numpy(), corners)
    np.testing.assert_array_equal(ts.numpy(), _ref_signs(s, corners))
    assert table.count.tolist() == [len(corners), len(corners), 0]
    assert len(corners) < 8 * len(lk)  # neighbours share corners


@pytest.mark.parametrize("view", ["identity", "oblique"])
def test_merge_entry_matches_topo_safe(stages, view):
    """`merge_topo` (its plain version here) on the first collapse
    round's candidates, with the table the leaf entry filled: topo equals
    `topo_safe` of the reference's signs at the 27 lattice points and the
    reference's `merge_core`, False past the live candidates; the table
    gains exactly the round's distinct lattice points that are no leaf
    corner."""
    from fidget_tpu_torch.mesh.collapse import _LATTICE, topo_safe

    s = stages(view)
    members, seg, pbase, ps = _first_round(s)
    K = len(pbase)
    kcap = fused._bucket_half(K)
    pb3 = np.zeros((3, kcap), np.int32)
    pb3[:, :K] = pbase.T
    _, table = _leaf_entry(s)
    leaf_keys = table.entries()[0].numpy().astype(np.int64)
    topo = uc.merge_topo(fused._kernels(s.pev)["table"],
                         torch.from_numpy(pb3), ps, K, s.h,
                         torch.from_numpy(s.mat),
                         torch.zeros(s.pev.n_inputs), table)
    assert topo.shape == (kcap,) and not topo[K:].any()
    ks = fused._KS
    pts = pbase[:, None, :] + _LATTICE[None, :, :] * (ps // 2)  # [K, 27, 3]
    lat = (pts[..., 0] * ks + pts[..., 1]) * ks + pts[..., 2]
    inside = _ref_signs(s, lat)
    np.testing.assert_array_equal(topo[:K].numpy(), topo_safe(inside))
    want = ref_fused.DeviceVertexStore(s.rev, s.m, None, s.h, s.rres, s.cs,
                                       DEPTH).merge_round(members, seg,
                                                          pbase, ps)
    np.testing.assert_array_equal(topo[:K].numpy(), want[0])
    new = np.setdiff1d(np.unique(lat), leaf_keys)
    assert int(table.count[0]) == len(new) < lat.size
    tk, ts = table.entries()
    np.testing.assert_array_equal(tk.numpy(),
                                  np.union1d(leaf_keys, np.unique(lat)))
    np.testing.assert_array_equal(ts.numpy(), _ref_signs(s, tk.numpy()))


def test_sign_table_contract():
    """The sign table's contract through the entries' plain versions:
    leaf cells with duplicated keys, -1 padding and a live count below
    the list's length record each distinct live corner once (count[0]:
    the points the kernels evaluate) with `unrolled_points_plain`'s sign
    there, and form every live cell's mask from those signs (dead cells
    0); a collapse round on the same table adds only the lattice points
    it lacked. The kernels' table decodes its slots (sign in bit 31) in
    `entries`."""
    from fidget_tpu_torch.mesh.collapse import _LATTICE

    tape = sphere_tape(port)
    kern = uc.TableKernel(tape, _kinds(tape), 3)
    rng = np.random.default_rng(11)
    ks = fused._KS
    G = 1 << DEPTH
    xyz = rng.integers(0, G - 1, (3, 300))
    distinct = (xyz[0] * ks + xyz[1]) * ks + xyz[2]
    keys = np.concatenate([distinct, distinct[:120], distinct[50:80]])
    rng.shuffle(keys)
    keys = np.concatenate([keys, np.full(40, -1)]).astype(np.int32)
    keys[[3, 17]] = -1  # padding among the live keys too
    count = 400  # of 470 keys
    mat = torch.from_numpy(VIEWS["oblique"][0][:3].astype(np.float32))
    params = torch.zeros(3)
    h = 2.0 / G
    table = uc.SignTable(0, "cpu")
    mask = uc.leaf_masks(kern, torch.from_numpy(keys),
                         torch.tensor([count], dtype=torch.int32), h, mat,
                         params, table)
    live = (np.arange(len(keys)) < count) & (keys >= 0)
    corner_off = fused._CORNER_OFF @ np.array([ks * ks, ks, 1])
    corners = keys[live, None].astype(np.int64) + corner_off[None]
    want_keys = np.unique(corners)
    assert len(want_keys) < corners.size  # duplicates and shared corners
    assert table.count.tolist() == [len(want_keys), len(want_keys), 0]

    def signs(k):
        """`unrolled_points_plain`'s sign at packed keys k (int64)."""
        x, y, z = uc._lattice(torch.from_numpy(k.astype(np.int32)))
        world = [c.to(torch.float32) * h - 1.0 for c in (x, y, z)]
        return uc.unrolled_points(
            uc.PointsKernel(tape, _kinds(tape), 3, "sign"),
            *uc._model_pts(mat, *world), params).numpy()

    tk, ts = table.entries()
    np.testing.assert_array_equal(tk.numpy(), want_keys)
    np.testing.assert_array_equal(ts.numpy(), signs(want_keys))
    assert ts.any() and not ts.all()
    held = signs(corners.reshape(-1)).reshape(corners.shape)
    np.testing.assert_array_equal(
        mask.numpy()[live], (held << np.arange(8)[None]).sum(1))
    assert (mask.numpy()[~live] == 0).all()
    # a collapse round: only the lattice points the leaf left out are new
    ps, n_cand, kcap = 2, 25, 32
    pb3 = np.zeros((3, kcap), np.int32)
    pb3[:, :n_cand] = xyz[:, :n_cand]
    topo = uc.merge_topo(kern, torch.from_numpy(pb3), ps, n_cand, h, mat,
                         params, table)
    assert not topo[n_cand:].any()
    lat = (xyz[:, :n_cand].T[:, None, :] + _LATTICE[None] * (ps // 2)).T
    lat_keys = np.unique((lat[0] * ks + lat[1]) * ks + lat[2])
    fresh = np.setdiff1d(lat_keys, want_keys)
    assert 0 < int(table.count[0]) == len(fresh) < lat_keys.size
    assert int(table.count[1]) == len(want_keys) + len(fresh)
    tk, ts = table.entries()
    np.testing.assert_array_equal(tk.numpy(), np.union1d(want_keys,
                                                         lat_keys))
    np.testing.assert_array_equal(ts.numpy(), signs(tk.numpy()))
    # the slots of the kernels' table: -1 empty, the sign in bit 31
    slots = uc.SignTable(300, "cpu", plain=False)
    assert slots.slots.numel() == 1024 and (slots.slots == -1).all()
    slots.slots[[5, 9, 700]] = torch.tensor(
        [77, 12 | -(1 << 31), 40], dtype=torch.int32)
    k, sg = slots.entries()
    assert k.tolist() == [12, 40, 77] and sg.tolist() == [True, False, False]
    slots.reserve(kern, 512)  # a load of 1/2: no growth
    assert slots.slots.numel() == 1024 and slots.bound == 512
    assert uc._table_cap(513) == 2048


# ----------------------------------------------------------------------
# whole meshes


@pytest.fixture(scope="module")
def ref_meshes():
    """The reference's compiled meshes (interpret mode), built once."""
    cache = {}

    def get(key, shape, **kw):
        if key not in cache:
            cache[key] = ref_build_mesh(shape, RefSettings(
                interpret=True, eval="unrolled", **kw))
        return cache[key]

    return get


@pytest.mark.parametrize("collapse", [True, False])
def test_sphere_mesh_matches_reference(ref_meshes, collapse):
    cuda.reset_launches()
    got = build_mesh(sphere_tape(port), Settings(
        depth=DEPTH, device="cpu", eval="unrolled", collapse=collapse))
    assert sum(cuda.LAUNCHES.values()) == 0  # plain versions on the CPU
    want = ref_meshes(("sphere", collapse), sphere_tape(ref), depth=DEPTH,
                      collapse=collapse)
    assert len(got.triangles) > 0
    _same_mesh(got, want)


def test_gyroid_sphere_mesh_matches_reference(ref_meshes):
    got = build_mesh(gyroid_shape(port), Settings(depth=4, device="cpu",
                                                  eval="unrolled"))
    want = ref_meshes("gyroid", gyroid_shape(ref), depth=4)
    _same_mesh(got, want)


@pytest.mark.parametrize("view", ["camera", "oblique"])
def test_transformed_mesh_matches_reference(ref_meshes, view):
    m, radius = VIEWS[view]
    got = build_mesh(sphere_tape(port, radius), Settings(
        depth=DEPTH, world_to_model=m, device="cpu", eval="unrolled"))
    want = ref_meshes(view, sphere_tape(ref, radius), depth=DEPTH,
                      world_to_model=m)
    _same_mesh(got, want)


def test_unrolled_mesh_equals_interp_topology():
    """The two eval modes mesh the same surface: without collapse, as
    many vertices and triangles on the gyroid sphere, the vertices
    within 1e-4 of each other (the modes take their edge brackets and
    QEF sums in different arithmetic, f32 on the device against f64 on
    the host)."""
    shape = gyroid_shape(port)
    a = build_mesh(shape, Settings(depth=4, device="cpu", collapse=False))
    b = build_mesh(shape, Settings(depth=4, device="cpu", eval="unrolled",
                                   collapse=False))
    assert a.vertices.shape == b.vertices.shape
    assert a.triangles.shape == b.triangles.shape
    # the modes number their cells in different orders: every vertex of
    # each lies within 1e-4 of one of the other's, and the surfaces'
    # areas agree
    d = np.linalg.norm(b.vertices[:, None, :] - a.vertices[None, :, :],
                       axis=2)
    assert d.min(axis=1).max() < 1e-4 and d.min(axis=0).max() < 1e-4

    def area(m):
        v, t = m.vertices.astype(np.float64), m.triangles
        n = np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])
        return 0.5 * np.linalg.norm(n, axis=1).sum()

    assert abs(area(a) - area(b)) < 1e-4 * area(a)


def test_overflow_retry_and_cached_capacity(ref_meshes):
    """A capacity seeded too small: the speculative chain sees the
    overflow in its count vector and retries checked with the real
    count; the mesh is the reference's, and the capacity is cached."""
    tape = sphere_tape(port)
    settings = Settings(depth=DEPTH, device="cpu", eval="unrolled")
    build_mesh(tape, settings)  # fills the evaluator's caches
    ev = port_evaluator(tape, torch.device("cpu"), True)
    caps = ev._fused_caps
    assert ("cmax", DEPTH) in caps and ("cs", DEPTH) in caps
    caps[("cmax", DEPTH)] = 1024
    got = build_mesh(tape, settings)
    assert caps[("cmax", DEPTH)] > 1024
    _same_mesh(got, ref_meshes(("sphere", True), sphere_tape(ref),
                               depth=DEPTH, collapse=True))


def test_empty_and_full_shapes():
    for offset in (6.0, -6.0):  # outside, then inside, everywhere
        ctx = port.Context()
        tape = port.lower(ctx, [ctx.add(ctx.x(), offset)])
        m = build_mesh(tape, Settings(depth=4, device="cpu", eval="unrolled"))
        assert isinstance(m, Mesh) and len(m.triangles) == 0
        assert m.vertices.shape == (0, 3)


def test_host_reads_of_the_chain(monkeypatch):
    """The first build (checked chain) reads one count a level and the
    surface count; once its capacity is cached, a chain reads none of
    them (only the count vector, at its end)."""
    tape = sphere_tape(port)
    settings = Settings(depth=DEPTH, device="cpu", eval="unrolled")
    reads = []
    real = torch.Tensor.__int__

    def counting(self):
        reads.append(self.numel())
        return real(self)

    monkeypatch.setattr(torch.Tensor, "__int__", counting)
    build_mesh(tape, settings)
    assert reads == [1] * (DEPTH - min(3, DEPTH - 1) + 1)
    reads.clear()
    build_mesh(tape, settings)
    assert reads == []


# ----------------------------------------------------------------------
# U1-P and U2-B: plain versions, masks, units


def _kinds(t_port):
    return {v.kind: i for v, i in t_port.var_map.items()}


@pytest.mark.parametrize("name", FAST_CASES)
def test_points_plain_matches_reference(name):
    """U1-P's plain version under both epilogues over a [3, 1365] list
    with 1000 live columns: distances allclose to the reference's
    `eval_tape_float_fast` (rtol = atol = 2e-5) where live and 0 where
    dead; signs exactly `d < 0` of those distances where live."""
    t_ref, t_port = _tapes(name)
    V = max(1, len(t_ref.var_map))
    rng = np.random.default_rng(7)
    pts = rng.uniform(-1.3, 1.3, (V, 3, 1365)).astype(np.float32)
    want = np.asarray(ref_fast.eval_tape_float_fast(
        t_ref, [jnp.asarray(p) for p in pts])[0])
    axis_of = _kinds(t_port)
    assert sorted(axis_of.values()) == list(range(V)), "the cases have no vars"
    params = torch.zeros(V)
    xyz = [torch.from_numpy(pts[axis_of[k]]) if k in axis_of
           else torch.zeros(3, 1365) for k in "xyz"]
    count = torch.tensor([1000], dtype=torch.int32)
    live = np.arange(1365)[None, :] < 1000
    dist = uc.unrolled_points_plain(uc.PointsKernel(t_port, axis_of, V),
                                    *xyz, params, count)
    sign = uc.unrolled_points(uc.PointsKernel(t_port, axis_of, V, "sign"),
                              *xyz, params, count)
    assert dist.shape == sign.shape == (3, 1365) and sign.dtype == torch.bool
    d = dist.numpy()
    _close(d[:, :1000], np.broadcast_to(want, (3, 1365))[:, :1000])
    assert (d[:, 1000:] == 0).all()
    np.testing.assert_array_equal(sign.numpy(), (d < 0) & live)
    all_live = uc.unrolled_points(uc.PointsKernel(t_port, axis_of, V),
                                  *xyz, params)
    np.testing.assert_array_equal(all_live.numpy()[:, :1000], d[:, :1000])


@pytest.mark.parametrize("name", FAST_CASES)
def test_boxes_plain_matches_reference(name):
    """U2-B's plain version over [2, 256] boxes with 200 live columns:
    the proofs of the reference's `eval_tape_interval_fast` exactly
    where live, neither proof where dead."""
    t_ref, t_port = _tapes(name)
    V = max(1, len(t_ref.var_map))
    lo, hi = _boxes(13, V, n=512)
    wl, wh = ref_fast.eval_tape_interval_fast(
        t_ref, [(jnp.asarray(a), jnp.asarray(b)) for a, b in zip(lo, hi)])
    axis_of = _kinds(t_port)
    assert sorted(axis_of.values()) == list(range(V)), "the cases have no vars"
    tl = [torch.from_numpy(lo[axis_of[k]]).reshape(2, 256) if k in axis_of
          else torch.zeros(2, 256) for k in "xyz"]
    th = [torch.from_numpy(hi[axis_of[k]]).reshape(2, 256) if k in axis_of
          else torch.zeros(2, 256) for k in "xyz"]
    kern = uc.BoxesKernel(t_port, axis_of, V)
    count = torch.tensor([200], dtype=torch.int32)
    full, empty = uc.unrolled_interval_boxes(kern, tl, th, torch.zeros(V),
                                             count)
    live = np.arange(256)[None, :] < 200
    np.testing.assert_array_equal(
        full.numpy(), (np.asarray(wh[0]) < 0).reshape(2, 256) & live)
    np.testing.assert_array_equal(
        empty.numpy(), (np.asarray(wl[0]) > 0).reshape(2, 256) & live)


def test_mesher_kernels_units_and_keys():
    """U1-P shares U1's (and U1-3D's) program object: its two epilogues
    and its edge search are three kernel units; U2-B is one stream unit
    of its own (U_BOX, U2's schedule at one warp: no hand-off slot, no
    barrier) behind U_BOX_KERNEL and U_LEVEL_KERNEL, with BOX_FLAGS."""
    tape = sphere_tape(port)
    axis_of = _kinds(tape)
    u1 = uc.FloatKernel([tape], axis_of, 3).unit()
    v1 = uc.VoxelKernel(tape, axis_of, 3).unit()
    p_dist = uc.PointsKernel(tape, axis_of, 3).unit()
    p_sign = uc.PointsKernel(tape, axis_of, 3, "sign").unit()
    edges = uc.EdgesKernel(tape, axis_of, 3).unit()
    keys = [o.key for o in u1.objects]
    assert [o.key for o in p_dist.objects] == keys
    assert [o.key for o in p_sign.objects] == [o.key for o in v1.objects]
    assert [o.key for o in edges.objects] == keys
    assert "U_POINTS_KERNEL(0)" in p_dist.source
    assert "U_POINTS_KERNEL(1)" in p_sign.source
    assert edges.source.rstrip().endswith("U_EDGE_KERNEL")
    assert len({u1.key, v1.key, p_dist.key, p_sign.key, edges.key}) == 5
    b = uc.BoxesKernel(tape, axis_of, 3)
    assert b.epilogue == "proofs" and not b.Z3
    assert b.schedule().k == 1 and b.schedule().n_slots == 0
    assert b.schedule().n_stages == 1
    bu = b.unit()
    assert "U_BOX_KERNEL" in bu.source and "U_LEVEL_KERNEL" in bu.source
    assert "#define U_BOX 1" in bu.source and "U_INTERVAL_KERNEL" not in bu.source
    assert f"#define U_BLOCK {uc.BOX_BLOCK}" in bu.source
    assert f"#define U_KS {fused._KS}" in bu.source
    i3 = uc.Interval3Kernel(tape, axis_of, 3).unit()
    i2 = uc.IntervalKernel(tape, axis_of, 3, "proofs").unit()
    assert len(bu.objects) == 1
    assert len(i3.objects) == len(i2.objects) == uc.INTERVAL_WARPS
    (o,) = bu.objects
    assert "#define U_BOX 1" in o.source and "#define U_K 1" in o.source
    assert "U_Z3" not in o.source and "U_SH(" not in o.source
    assert "U_BAR()" not in o.source and "U_OUT(" in o.source
    assert o.flags == bu.flags == uc.BOX_FLAGS
    assert o.key not in {x.key for x in i3.objects + i2.objects}
    # another block or register cap is another unit
    other = uc.BoxesKernel(tape, axis_of, 3, block=64,
                           flags=("-maxrregcount=64",)).unit()
    assert other.key != bu.key and other.objects[0].key != o.key
    assert {"unrolled_points", "unrolled_interval_boxes", "unrolled_edges",
            "level_active"} <= set(cuda.KERNELS)
    with pytest.raises(ValueError, match="epilogue"):
        uc.PointsKernel(tape, axis_of, 3, "depth")
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="count"):
        uc.unrolled_points(uc.PointsKernel(tape, axis_of, 3), x, x, x,
                           torch.zeros(3), torch.tensor([1]))
    with pytest.raises(ValueError, match="params"):
        uc.unrolled_interval_boxes(b, (x, x, x), (x, x, x), torch.zeros(2))


def test_fused_kernels_are_the_tapes():
    tape = sphere_tape(port)
    ev = port_evaluator(tape, torch.device("cpu"), True)
    ks = fused.fused_kernels(ev)
    assert [type(k).__name__ for k in ks] == ["TableKernel", "EdgesKernel",
                                              "BoxesKernel"]
    assert fused.fused_kernels(ev)[0] is ks[0]
    assert ks[0].tapes[0] is tape and ks[1].tapes[0] is tape
    assert ks[2].tape is tape
    assert port_evaluator(tape, torch.device("cpu"), False) is not ev


def test_eval_grad_world_seeds():
    """Seeds M (3 x 3) give the model gradient times M: d/d(world) at
    the model points under an affine world -> model matrix."""
    tape = sphere_tape(port)
    ev = port.BulkEvaluator(tape, device="cpu")
    rng = np.random.default_rng(3)
    pts = rng.uniform(-1, 1, (3, 500)).astype(np.float32)
    M = _rotation((1, 2, 3), 0.7)[:3, :3].astype(np.float32) * 1.3
    plain = ev.eval_grad(*pts)[0].numpy()
    seeded = ev.eval_grad(*pts, seeds=M)[0].numpy()
    np.testing.assert_array_equal(seeded[0], plain[0])
    np.testing.assert_allclose(seeded[1:], M.T @ plain[1:], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(ev.eval_grad(*pts, seeds=np.eye(3))
                                  .numpy(), ev.eval_grad(*pts).numpy())
    with pytest.raises(ValueError, match="3 x 3"):
        ev.eval_grad(*pts, seeds=np.eye(2))


def test_fused_modules_import_no_jax():
    code = (
        "import sys, fidget_tpu_torch.mesh.fused, fidget_tpu_torch.mesh.qef\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'fidget_tpu')]\n"
        "assert not bad, bad\n"
    )
    root = __import__("pathlib").Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   timeout=120)
