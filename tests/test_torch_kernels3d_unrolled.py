"""The frame entries of the compiled 3D frame's two kernels, on the CPU:
U2-3D's `unrolled_proofs3` (a frame's root tiles and every subtile of
them in one call) and U1-3D's `unrolled_voxel_fold` (a stratum's
worklist read and folded into the floor), through their plain versions,
against the per-box and per-candidate paths that the frame took before
them (`unrolled_interval3_plain` on the boxes the glue formed,
`unrolled_voxel_depth_plain` and the scatter fold) and against
fidget_tpu's `_unrolled_interval3`, `_compact_stratum`, unrolled
`stratum_leaf` and `stratum_fold` on the same inputs, made from a seed
with numpy: proofs and floors exactly. Then the layout rules and the
emitted units.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidget_tpu.eval.arith import IntervalMode as RefIntervalMode
from fidget_tpu.render import render3d as ref_r3d
import fidget_tpu_torch as port
from fidget_tpu_torch.eval import unrolled_cuda as uc
from fidget_tpu_torch.render import render3d
from test_torch_render3d_per_shape import REF_GYROID, TURN, PORT_GYROID

#: (volume edge, tile, subtile)
GEOMETRIES = [(64, 32, 8), (64, 32, 16), (32, 16, 8)]


def _kernels(tape=PORT_GYROID):
    axis_of = {v.kind: i for v, i in tape.var_map.items()}
    V = max(1, len(tape.var_map))
    return (uc.Interval3Kernel(tape, axis_of, V),
            uc.VoxelKernel(tape, axis_of, V), axis_of, V)


def _screen_mat(n, which):
    """Screen -> model of an n^3 volume under TURN, affine or with a
    perspective w row."""
    s2w = port.VoxelSize(n, n, n).screen_to_world().astype(np.float32)
    m = TURN
    if which == "perspective":
        persp = np.eye(4)
        persp[3, 2] = 0.3
        m = persp @ TURN
    return (m @ s2w).astype(np.float32)


def _params(mat, V):
    return uc.params_tensor(torch.from_numpy(mat), torch.zeros(()),
                            torch.zeros(V))


def _ref_b(axis_of, V):
    import types

    return types.SimpleNamespace(V=V, axis_of=axis_of, tape=REF_GYROID,
                                 leaf="unrolled")


@pytest.mark.parametrize("slab", ["whole", "slab"])
@pytest.mark.parametrize("matrix", ["affine", "perspective"])
@pytest.mark.parametrize("n,ts,sub", GEOMETRIES,
                         ids=[f"{n}-{t}-{s}" for n, t, s in GEOMETRIES])
def test_proofs3_plain_matches_the_per_box_proofs(n, ts, sub, matrix, slab):
    """`unrolled_proofs3` (plain on the CPU) over a frame's roots, or a
    y-slab of them: column 0 equals `unrolled_interval3_plain` on the
    roots at edge ts, columns 1.. equal it on the subtile boxes that the
    glue formed stratum by stratum (each root's corner plus the
    geometry's `sub_dx` / `sub_dy` / `sub_dz`) at edge sub, and both
    equal fidget_tpu's `_unrolled_interval3` on the same boxes."""
    k3, _, axis_of, V = _kernels()
    geo = render3d._geo3(n, n, n, ts, sub)
    st = geo.statics(torch.device("cpu"))
    x0, y0, z0 = st["tile_x0"], st["tile_y0"], st["tile_z0"]
    if slab == "slab":  # the second half of the tile rows, every z and x
        keep = y0 >= (geo.nty // 2) * ts
        x0, y0, z0 = x0[keep], y0[keep], z0[keep]
    mat = _screen_mat(n, matrix)
    params = _params(mat, V)
    full, empty = uc.unrolled_proofs3(k3, x0, y0, z0, params, ts, sub)
    nt, m = x0.shape[0], geo.m
    assert full.shape == empty.shape == (nt, 1 + m)
    assert full.dtype == torch.bool

    rf, re_ = uc.unrolled_interval3_plain(k3, x0, y0, z0, params, ts)
    assert torch.equal(full[:, 0], rf) and torch.equal(empty[:, 0], re_)
    # the subtile boxes as the glue formed them, nearest stratum first
    ntxy = nt // geo.ntz
    for k in range(geo.ntz):
        tz = geo.ntz - 1 - k
        x0s, y0s, z0s = (a.reshape(geo.ntz, ntxy)[tz] for a in (x0, y0, z0))
        sx0 = x0s[:, None] + st["sub_dx"][None, :]
        sy0 = y0s[:, None] + st["sub_dy"][None, :]
        sz0 = z0s[:, None] + st["sub_dz"][None, :]
        sf, se = uc.unrolled_interval3_plain(
            k3, sx0.reshape(-1), sy0.reshape(-1), sz0.reshape(-1), params,
            sub)
        got_f = full[:, 1:].reshape(geo.ntz, ntxy, m)[tz]
        got_e = empty[:, 1:].reshape(geo.ntz, ntxy, m)[tz]
        assert torch.equal(got_f, sf.reshape(ntxy, m))
        assert torch.equal(got_e, se.reshape(ntxy, m))

    # fidget_tpu on the same boxes
    rgeo = ref_r3d._geo3(n, n, n, ts, sub)
    b = _ref_b(axis_of, V)
    im = RefIntervalMode(jnp)
    xr, yr, zr = (jnp.asarray(a.numpy()) for a in (x0, y0, z0))
    boxes = {
        "root": ((xr, yr, zr), ts),
        "sub": ((xr[:, None] + rgeo.sub_dx[None, :],
                 yr[:, None] + rgeo.sub_dy[None, :],
                 zr[:, None] + rgeo.sub_dz[None, :]), sub),
    }
    for where, ((bx, by, bz), e) in boxes.items():
        lo, hi = ref_r3d._unrolled_interval3(
            b, im, jnp.asarray(mat), jnp.zeros(V),
            (bx, bx + e), (by, by + e), (bz, bz + e))
        cols = slice(0, 1) if where == "root" else slice(1, None)
        np.testing.assert_array_equal(
            full[:, cols].numpy(), np.asarray(hi).reshape(nt, -1) < 0)
        np.testing.assert_array_equal(
            empty[:, cols].numpy(), np.asarray(lo).reshape(nt, -1) > 0)
    proven = int((full | empty).sum())
    assert 0 < proven < full.numel()


def _old_fold(floor, dcand, idx, *, nl, sub):
    """The frame's fold before U1-3D folded: the candidates scattered back
    through the compaction's inverse, the max over the stratum's z
    layers, then the max with the floor."""
    H, W = floor.shape
    ny2, nx2 = H // sub, W // sub
    cap = dcand.shape[0]
    order, valid = idx["order"], idx["valid"]
    slot_of = torch.full((nl * ny2 * nx2,), cap, dtype=torch.int64).scatter(
        0, order, torch.where(valid, torch.arange(cap), cap))
    pad = torch.cat([dcand, dcand.new_zeros((1, sub, sub))])
    vox = (pad[slot_of].reshape(nl, ny2, nx2, sub, sub)
           .permute(0, 1, 3, 2, 4).reshape(nl, H, W).amax(0))
    return torch.maximum(floor, vox)


#: (label, share of the stratum's subtiles active, cap over the count,
#: slab's first tile row)
FOLD_CASES = [
    ("below-cap", 0.3, 2.0, 0),
    ("count-0", 0.0, 1.0, 0),
    ("y-base", 0.3, 1.5, 1),
    ("over-cap", 0.6, 0.5, 0),
]


@pytest.mark.parametrize("case", FOLD_CASES, ids=[c[0] for c in FOLD_CASES])
@pytest.mark.parametrize("n,ts,sub", GEOMETRIES,
                         ids=[f"{n}-{t}-{s}" for n, t, s in GEOMETRIES])
def test_voxel_fold_plain_matches_candidates_and_fold(n, ts, sub, case):
    """`unrolled_voxel_fold` (plain on the CPU) on a stratum's worklist
    from random active flags: the floor it folds into in place equals the
    floor of the path before it (the worklist decoded, the corners formed
    as `stratum_leaf` formed them, `unrolled_voxel_depth_plain`, the
    scatter fold) and fidget_tpu's (`_compact_stratum`, the unrolled
    `stratum_leaf`, `stratum_fold`), bit for bit: with fewer active
    subtiles than slots, with none, on a slab whose first row is not 0,
    and with more than the slots."""
    _, share, over, row0 = case
    _, kv, axis_of, V = _kernels()
    geo = render3d._geo3(n, n, n, ts, sub)
    nl, nx2 = geo.nl, geo.nx2
    nty = geo.nty - row0
    ny2 = nty * nl
    y_base = float(row0 * ts)
    rng = np.random.default_rng(31 + row0 + int(10 * share))
    act = rng.random(nl * ny2 * nx2) < share
    count = int(act.sum())
    cap = max(1, int(np.ceil(max(count, 4) * over)))
    act_t = torch.from_numpy(act)
    idx = render3d._compact_stratum(act_t, nl=nl, ny2=ny2, nx2=nx2,
                                    cap_s=cap)
    z_lo = np.float32((geo.ntz - 1) * ts)
    mat = _screen_mat(n, "affine")
    params = _params(mat, V)
    floor0 = torch.from_numpy(
        rng.integers(0, n // 2, (nty * ts, n)).astype(np.int32))

    # the frame's path before the frame entry
    f32 = torch.float32
    gy_sub = (idx["gy"] * sub).to(f32)
    if y_base:
        gy_sub = gy_sub + y_base
    dcand = uc.unrolled_voxel_depth_plain(
        kv, (idx["gx"] * sub).to(f32), gy_sub,
        (idx["lz"] * sub).to(f32) + torch.tensor(z_lo), idx["valid"], params,
        sub=sub)
    want = _old_fold(floor0, dcand, idx, nl=nl, sub=sub)

    floor = floor0.clone()
    got = uc.unrolled_voxel_fold(kv, idx["order"], act_t.sum(),
                                 torch.tensor([z_lo]), params, floor,
                                 sub=sub, nl=nl, y_base=y_base)
    assert got is floor and got.dtype == torch.int32
    assert torch.equal(floor, want)
    if count:
        assert not torch.equal(floor, floor0)
    else:
        assert torch.equal(floor, floor0)

    # fidget_tpu's stratum on the same flags
    rgeo = ref_r3d._geo3(n, n, n, ts, sub)
    ridx = ref_r3d._compact_stratum(jnp.asarray(act), nl=nl, ny2=ny2,
                                    nx2=nx2, cap_s=cap, xp=jnp)
    rcand = rgeo.stratum_leaf(
        _ref_b(axis_of, V), {}, {"z_lo": jnp.float32(z_lo)}, ridx,
        mat=jnp.asarray(mat), var_vec=jnp.zeros(V),
        y_base=jnp.float32(y_base), cap_s=cap)
    rfloor = rgeo.stratum_fold(jnp.asarray(floor0.numpy()), rcand, ridx,
                               nty=nty, cap_s=cap)
    np.testing.assert_array_equal(floor.numpy(), np.asarray(rfloor))


def test_voxel_fold_checks_its_arguments():
    _, kv, _, V = _kernels()
    params = _params(_screen_mat(32, "affine"), V)
    order = torch.arange(8)
    floor = torch.zeros((16, 16), dtype=torch.int32)
    ok = dict(sub=8, nl=2)
    with pytest.raises(ValueError, match="order"):
        uc.unrolled_voxel_fold(kv, order.int(), order.sum(),
                               torch.zeros(1), params, floor, **ok)
    with pytest.raises(ValueError, match="count"):
        uc.unrolled_voxel_fold(kv, order, order.sum().int(),
                               torch.zeros(1), params, floor, **ok)
    with pytest.raises(ValueError, match="floor"):
        uc.unrolled_voxel_fold(kv, order, order.sum(), torch.zeros(1),
                               params, floor.float(), **ok)
    with pytest.raises(ValueError, match="group"):
        uc.unrolled_voxel_fold(kv, order, order.sum(), torch.zeros(1),
                               params, floor, group=16, **ok)
    with pytest.raises(ValueError, match="multiple"):
        uc.unrolled_proofs3(uc.Interval3Kernel(PORT_GYROID, {}, V),
                            torch.zeros(2), torch.zeros(2), torch.zeros(2),
                            params, 12, 8)


def test_layout_rules():
    """U1-3D's lanes a column fill the card twice over from the slot count
    (the 128³ union's 128 slots of 16³: 16; the 512³ gyroid's heaviest
    strata of 1,024 and 640: 2), at most the subtile's edge; U2-3D takes
    one thread a box from a warp a scheduler on (the gyroid's 33,280
    boxes), else 4 warps a group (the union's 576)."""
    assert uc.voxel_group(128, 16) == 16
    assert uc.voxel_group(1024, 16) == 2
    assert uc.voxel_group(640, 16) == 2
    assert uc.voxel_group(4096, 16) == 1
    assert uc.voxel_group(4, 8) == 8
    assert uc.voxel_group(1, 4) == 4
    assert uc.voxel_group(0, 16) == 16
    for slots in (1, 7, 100, 513, 4096):
        for sub in (4, 8, 16, 32):
            G = uc.voxel_group(slots, sub)
            assert G in uc.VOXEL_GROUPS and sub % G == 0
            assert G == 1 or slots * sub * sub * G <= uc.FILL_THREADS
    assert uc.proofs3_warps(512 * 65) == 1
    assert uc.proofs3_warps(64 * 9) == 4
    assert uc.proofs3_warps(32 * uc.PROOFS3_ONE_THREAD_GROUPS) == 1
    assert uc.proofs3_warps(32 * uc.PROOFS3_ONE_THREAD_GROUPS - 32) == 4


@pytest.mark.parametrize("warps", uc.PROOFS3_WARPS)
def test_proofs3_layouts_emit_their_units(warps):
    """An Interval3Kernel at each layout: k streams under U_Z3 behind one
    kernel unit at k warps a group (k = 1: one stream, no barrier), the
    subtiles' edge and count in its arguments; each layout its own
    build key. The renderer picks `proofs3_warps` of its frame."""
    k3 = uc.Interval3Kernel(PORT_GYROID, {"x": 0, "y": 1, "z": 2}, 3,
                            warps=warps)
    unit = k3.unit()
    assert k3.schedule().k == warps
    assert f"#define U_K {warps}\n" in unit.source
    assert "Ts, nl, sh" in unit.source
    assert len(unit.objects) == warps
    if warps == 1:
        assert "U_BAR" not in unit.objects[0].source
    keys = {uc.Interval3Kernel(PORT_GYROID, {"x": 0}, 3, warps=k).unit().key
            for k in uc.PROOFS3_WARPS}
    assert len(keys) == len(uc.PROOFS3_WARPS)
    with pytest.raises(ValueError, match="warps"):
        uc.Interval3Kernel(PORT_GYROID, {"x": 0}, 3, warps=3)
    r = port.VoxelRenderer(PORT_GYROID, port.VoxelSize(64, 64, 64),
                           tile_size=32, sub_size=8, leaf="unrolled",
                           proofs="unrolled", device="cpu")
    assert r._interval3_kernel.warps == uc.proofs3_warps(8 * 65)
    assert "fidget_unrolled_voxel_fold_launch" in uc._ARGTYPES
