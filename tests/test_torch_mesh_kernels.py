"""The compiled mesher's edge search and crossing list, on the CPU.

`fidget_tpu_torch.mesh.fused` runs the N-ary edge search on a compacted
list of crossing (cell, edge) slots (`crossing_list`, U1-P
`unrolled_edges`) where it once ran dense rounds over all 12 edges of
every surface cell. Here, on the surface cells of a depth-5 sphere
under two views (the cells the port's level and leaf cores give, which
tests/test_torch_mesh_fused.py holds to fidget_tpu's exactly):

- `unrolled_edges_plain` on the list equals those dense rounds (the
  edge core as it was, restated below on `unrolled_points`' plain
  versions) at every crossing slot exactly: the brackets, the
  intersection, the distance there; for 16, 5 and 40 samples and 1 and
  4 rounds;
- the crossing list's keys, masks, slots and device count equal a
  numpy compaction, and past its capacity it keeps the first slots and
  counts them all; a build whose cached list bucket is too small lists
  again with the real count and meshes the same;
- the edge kernel's tables are mesh/tables.py's, and its group of lanes
  the sample count rounded up to a power of two, at most a warp.
"""

import re

import numpy as np
import pytest
import torch

import fidget_tpu_torch as port
from fidget_tpu_torch.eval import unrolled_cuda as uc
from fidget_tpu_torch.mesh import Settings, build_mesh
from fidget_tpu_torch.mesh import _get_evaluator as port_evaluator
from fidget_tpu_torch.mesh import fused
from fidget_tpu_torch.mesh.tables import CELL_TO_EDGE_TO_VERT, EDGE_HI, EDGE_LO
from test_torch_mesh import sphere_tape
from test_torch_mesh_fused import VIEWS

DEPTH = 5


def _surface(view):
    """The port's checked chain at DEPTH under `view`: (ev, surface keys,
    masks, count, h, mat, vv)."""
    m, radius = VIEWS[view]
    ev = port_evaluator(sphere_tape(port, radius), "cpu", True)
    A = m[:3, :3].astype(np.float32)
    pos, neg = torch.from_numpy(np.maximum(A, 0.0)), torch.from_numpy(
        np.minimum(A, 0.0))
    off3 = torch.from_numpy(m[:3, 3].astype(np.float32))
    mat = torch.from_numpy(m[:3, :].astype(np.float32))
    vv = torch.zeros(ev.n_inputs)
    d0 = min(3, DEPTH - 1)
    g0 = np.arange(1 << d0, dtype=np.int64)
    gx, gy, gz = np.meshgrid(g0, g0, g0, indexing="ij")
    seed = ((gx * fused._KS + gy) * fused._KS + gz).reshape(-1)
    G = 1 << DEPTH
    cmax = fused._bucket_pow2(8 * G * G)
    keys = torch.full((cmax,), -1, dtype=torch.int32)
    keys[: len(seed)] = torch.from_numpy(seed.astype(np.int32))
    n = torch.tensor([len(seed)], dtype=torch.int32)
    cvec = torch.zeros(DEPTH - d0 + 2, dtype=torch.int32)
    for i, d in enumerate(range(d0, DEPTH)):
        keys, n = fused.level_core(ev, keys, n, cvec, i, 2.0 / (2 << d), pos,
                                   neg, off3, vv, cmax)
    h = 2.0 / G
    sk, sm, ns = fused.leaf_core(ev, keys, n, cvec, DEPTH - d0, h, mat, vv,
                                 cmax)
    assert int(ns) > 0
    return ev, sk, sm, ns, h, mat, vv


@pytest.fixture(scope="module")
def surface():
    cache = {}

    def get(view):
        if view not in cache:
            cache[view] = _surface(view)
        return cache[view]

    return get


def _dense_search(ev, surf_keys, surf_mask, n_surf, h, mat, vv, cs, rounds,
                  samples):
    """The edge core's search as it ran before the crossing list: every
    (edge, cell) slot of [12, cs], `rounds` dense rounds of U1-P "sign"
    and the "distance" at the intersections. Returns ta, tb, the
    intersection's x, y, z and its distance, [12, cs] each."""
    sign = uc.PointsKernel(ev.tape, ev.axis_of, ev.n_inputs, "sign")
    distance = uc.PointsKernel(ev.tape, ev.axis_of, ev.n_inputs)
    surf_keys, mask = surf_keys[:cs], surf_mask[:cs]
    x, y, z = fused._dec(surf_keys)
    lo_c = torch.as_tensor(EDGE_LO)[:, None].expand(12, cs)
    hi_c = torch.as_tensor(EDGE_HI)[:, None].expand(12, cs)
    lo_in = (mask[None, :] >> lo_c) & 1
    start_c = torch.where(lo_in == 1, lo_c, hi_c).long()
    end_c = torch.where(lo_in == 1, hi_c, lo_c).long()
    coff = fused._corner_off("cpu")

    def corner_pos(c):
        return tuple((v[None, :] + coff[c, k]).to(torch.float32) * h - 1.0
                     for k, v in enumerate((x, y, z)))

    sx, sy, sz = corner_pos(start_c)
    ex, ey, ez = corner_pos(end_c)
    dx, dy, dz = ex - sx, ey - sy, ez - sz
    frac = ((torch.arange(samples, dtype=torch.float32) + 1.0)
            / (samples + 1.0))[:, None, None]
    idx = torch.arange(samples)[:, None, None]
    ta = torch.zeros((12, cs))
    tb = torch.ones((12, cs))
    for _ in range(rounds):
        ts = ta[None] + (tb - ta)[None] * frac
        inside = uc.unrolled_points(
            sign, *fused._model_pts(mat, sx[None] + dx[None] * ts,
                                    sy[None] + dy[None] * ts,
                                    sz[None] + dz[None] * ts), vv, n_surf)
        outside = ~inside
        any_out = outside.any(dim=0)
        F = torch.where(outside, idx, samples).amin(dim=0).to(torch.float32)
        span = tb - ta
        tbF = ta + span * (F + 1.0) / (samples + 1.0)
        taF = ta + span * F / (samples + 1.0)
        ts_last = ta + span * samples / (samples + 1.0)
        new_tb = torch.where(any_out, tbF, tb)
        ta = torch.where(any_out & (F > 0), taF,
                         torch.where(any_out, ta, ts_last))
        tb = new_tb
    t = 0.5 * (ta + tb)
    ip = (sx + dx * t, sy + dy * t, sz + dz * t)
    d = uc.unrolled_points(distance, *fused._model_pts(mat, *ip), vv, n_surf)
    return ta, tb, *ip, d


@pytest.mark.parametrize("rounds", [1, 4])
@pytest.mark.parametrize("samples", [16, 5, 40])
@pytest.mark.parametrize("view", ["identity", "oblique"])
def test_edges_plain_matches_dense_rounds(surface, view, samples, rounds):
    ev, sk, sm, ns, h, mat, vv = surface(view)
    n = int(ns)
    cs = fused._bucket_half(n, lo=1024)
    key, mask, slot, count = fused.crossing_list(sk[:cs], sm[:cs], ns,
                                                 12 * cs)
    kern = uc.EdgesKernel(ev.tape, ev.axis_of, ev.n_inputs)
    got = uc.unrolled_edges(kern, key, mask, slot, count, mat, vv, h,
                            samples=samples, rounds=rounds)
    assert got.shape == (uc.EDGE_OUTS, 12 * cs) and got.dtype == torch.float32
    dense = _dense_search(ev, sk, sm, ns, h, mat, vv, cs, rounds, samples)
    c = int(count)
    j, e = (slot[:c] // 12).long(), (slot[:c] % 12).long()
    assert (j < n).all()
    for row, want in zip((0, 1, 2, 3, 4, 8), dense):
        np.testing.assert_array_equal(got[row, :c].numpy(),
                                      want[e, j].numpy())
    mp = fused._model_pts(mat, *(got[k, :c] for k in (2, 3, 4)))
    for k in range(3):
        np.testing.assert_array_equal(got[5 + k, :c].numpy(), mp[k].numpy())
    assert (got[:, c:] == 0).all()  # dead slots
    # the intersections lie within a cell of the surface
    assert torch.isfinite(got[8, :c]).all()
    assert got[8, :c].abs().max() < h
    # the margin: the least |distance| a slot's samples met, 0 where dead
    out, near = uc.unrolled_edges_plain(kern, key, mask, slot, count, mat,
                                        vv, h, samples=samples, rounds=rounds,
                                        margin=True)
    assert torch.equal(out, got)
    assert (near[:c] >= 0).all() and (near[c:] == 0).all()
    assert torch.isfinite(near[:c]).all()


@pytest.mark.parametrize("view", ["identity", "oblique"])
def test_crossing_list_matches_numpy(surface, view):
    _, sk, sm, ns, _, _, _ = surface(view)
    keys, masks, n = sk.numpy(), sm.numpy(), int(ns)
    live = (np.arange(len(keys)) < n) & (keys >= 0)
    j, e = np.nonzero((CELL_TO_EDGE_TO_VERT[masks] >= 0) & live[:, None])
    total = len(j)
    assert total > 1024
    for ccap in (fused._bucket_pow2(total), 1024):
        cvec = torch.zeros(4, dtype=torch.int32)
        key, mask, slot, count = fused.crossing_list(sk, sm, ns, ccap, cvec,
                                                     2)
        assert key.shape == mask.shape == slot.shape == (ccap,)
        assert key.dtype == mask.dtype == slot.dtype == torch.int32
        assert count.tolist() == [total] and cvec.tolist() == [0, 0, total, 0]
        k = min(total, ccap)
        np.testing.assert_array_equal(key[:k].numpy(), keys[j[:k]])
        np.testing.assert_array_equal(mask[:k].numpy(), masks[j[:k]])
        np.testing.assert_array_equal(slot[:k].numpy(), 12 * j[:k] + e[:k])
        assert (key[k:] == -1).all() and (mask[k:] == 0).all()
        assert (slot[k:] == 0).all()


def test_crossing_list_overflow_retry(monkeypatch):
    """A cached crossing-list bucket below the real count: the cached
    chain sees it in its count vector and lists the slots again at the
    real count's bucket, with no other read; the mesh is the same, and
    the larger bucket is cached."""
    tape = sphere_tape(port)
    settings = Settings(depth=DEPTH, device="cpu", eval="unrolled")
    first = build_mesh(tape, settings)
    ev = port_evaluator(tape, torch.device("cpu"), True)
    caps = ev._fused_caps
    bucket = caps[("cross", DEPTH)]
    assert bucket // 2 > 1024
    caps[("cross", DEPTH)] = 1024
    seen = []
    real = fused.crossing_list

    def recording(*args, **kwargs):
        seen.append(args[3])
        return real(*args, **kwargs)

    monkeypatch.setattr(fused, "crossing_list", recording)
    again = build_mesh(tape, settings)
    assert seen == [1024, bucket]
    assert caps[("cross", DEPTH)] == bucket
    np.testing.assert_array_equal(again.triangles, first.triangles)
    np.testing.assert_array_equal(again.vertices, first.vertices)
    seen.clear()
    build_mesh(tape, settings)
    assert seen == [bucket]


def test_edge_kernel_tables_and_groups():
    tape = sphere_tape(port)
    kern = uc.EdgesKernel(tape, {v.kind: i for v, i in tape.var_map.items()},
                          3)
    src = kern.unit().source
    for name, table in (("u_edge_lo", EDGE_LO), ("u_edge_hi", EDGE_HI)):
        body = re.search(name + r"\[12\] = \{([^}]*)\}", src).group(1)
        assert [int(v) for v in body.split(",")] == table.tolist()
    assert f"#define U_KS {fused._KS}" in src
    assert [uc.edge_group(s) for s in (1, 2, 5, 16, 17, 32, 40, 100)] == [
        1, 2, 8, 16, 32, 32, 32, 32]
    i32 = torch.zeros(8, dtype=torch.int32)
    mat, vv = torch.zeros(3, 4), torch.zeros(3)
    count = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(ValueError, match="live count"):
        uc.unrolled_edges(kern, i32, i32, i32, None, mat, vv, 0.1,
                          samples=16, rounds=4)
    with pytest.raises(ValueError, match="int32"):
        uc.unrolled_edges(kern, i32.float(), i32, i32, count, mat, vv, 0.1,
                          samples=16, rounds=4)
    with pytest.raises(ValueError, match=r"\[3, 4\]"):
        uc.unrolled_edges(kern, i32, i32, i32, count, mat[:, :3], vv, 0.1,
                          samples=16, rounds=4)
    with pytest.raises(ValueError, match="samples"):
        uc.unrolled_edges(kern, i32, i32, i32, count, mat, vv, 0.1,
                          samples=0, rounds=4)
