"""Device-resident octree fine stage for Settings(eval="unrolled").

The counterpart of `fidget_tpu.mesh.fused`: the whole fine stage of a
mesh build stays on the device, in torch ops around kernels generated
for the tape (eval/unrolled_cuda.py) and the gradient kernel:

- level cores: U2-B `level_active` decodes each active cell's key,
  forms its 8 children's boxes (the exact box transform, in the
  reference's positive/negative coefficient order) and
  interval-classifies them, one thread a child; survivors are compacted
  on the device; only a cell COUNT comes back per level, and none at
  all on a chain whose capacity is cached (speculative mode: one count
  vector a chain);
- leaf core: U1-P's leaf entry `leaf_masks` decodes each leaf cell's
  key, forms its 8 corners and inserts them into the build's sign table
  (`SignTable`, on the card), evaluates each distinct corner once and
  forms the 8-bit masks; then the compacted surface cells and the
  crossing list: the (cell, edge) slots whose edge crosses the surface,
  compacted (`crossing_list`);
- edge core: on the crossing list, the N-ary bisection search in one
  launch (U1-P `unrolled_edges`: a group of lanes a slot, the brackets
  in registers, the intersection and its distance), world-space
  gradients there (one K4 launch with world seeds, the tangents
  `jax.linearize` pushes through the reference's `_model_pts`), both
  scattered back to the [12, cs] (edge, cell) layout, QEF accumulation
  into per-(cell, vertex-slot) sums, and the closed-form f32 QEF solve
  (mesh/qef.py).

The collapse rounds (`merge_core`, against `DeviceVertexStore`) solve
the merged QEFs in torch ops and run the topology test through U1-P's
merge entry `merge_topo`, on the same sign table: a round evaluates
only the lattice points that the leaf core and the rounds before it
left out.

The generated kernels read the live count from device memory, so a
chain of levels is enqueued without a host read; the plain versions
(the CPU) compute every lane and mask it, as the reference's cores do.
Capacities are power-of-two buckets, kept on the evaluator with its
kernels (`_fused_caps`, `_fused_kernels`); the host syncs one scalar
per level on a checked chain and retries on overflow. Vertex ids are
flat `4*cell+slot` (VERT_COUNT <= 4). The reference's own arithmetic is
kept where the interpreter path differs from it: the bisection's new
brackets are recomputed from F, not gathered from the samples; QEF sums
are taken in the cell-local frame, with selects, edge by edge in order;
merged QEFs shift into the parent frame.

Reference behavior being matched: fidget-mesh/src/octree.rs:94-210
(recursive build), :687-767 (edge search); fidget-mesh/src/qef.rs
(truncated solve).
"""

from __future__ import annotations

import numpy as np
import torch

from ..eval.unrolled_cuda import LATTICE_KS as _KS
from ..eval.unrolled_cuda import (
    BoxesKernel,
    EdgesKernel,
    SignTable,
    TableKernel,
    _lattice as _dec,
    _model_pts,
    build_kernels,
    built,
    leaf_masks,
    level_active,
    merge_topo,
    unrolled_edges,
)
from ..render.config import check_cancel
from .qef import qef_err_c, solve_qef_c
from .tables import CELL_TO_EDGE_TO_VERT, VERT_COUNT

#: crossing edges of a cell by its corner mask
_CROSSINGS = (CELL_TO_EDGE_TO_VERT >= 0).sum(axis=1)

_CORNER_OFF = np.array(
    [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
    np.int32,
)


def _compact_keys(act, keys, cap, *extra):
    """Stable device compaction of `keys[act]` (row-major order) into
    a [cap] buffer (-1 padding). Returns (out, *extras, n_act): each
    `extra` (same-shape i32) payload compacted alike (0 padding); n_act
    is an int32 [1] device tensor. Lanes past the capacity (and culled
    ones) scatter to a spare slot past `cap`, which is dropped: the
    counterpart of the reference's `mode="drop"`; a count past `cap`
    takes the caller's overflow retry."""
    act = act.reshape(-1)
    pos = torch.cumsum(act, 0, dtype=torch.int32) - 1
    dest = torch.where(act & (pos < cap), pos, cap).long()

    def scatter(vals, fill):
        out = torch.full((cap + 1,), fill, dtype=torch.int32,
                         device=act.device)
        return out.scatter_(0, dest, vals.reshape(-1).to(torch.int32))[:cap]

    n_act = act.sum(dtype=torch.int32).reshape(1)
    return (scatter(keys, -1), *(scatter(x, 0) for x in extra), n_act)


def _corner_off(device):
    return torch.as_tensor(_CORNER_OFF, device=device)


def _kernels(ev) -> dict:
    """The tape's generated kernels, kept on the evaluator: U1-P's sign
    table and edge search, and U2-B."""
    ks = ev.__dict__.get("_fused_kernels")
    if ks is None:
        args = (ev.tape, ev.axis_of, ev.n_inputs)
        ks = {"table": TableKernel(*args),
              "edges": EdgesKernel(*args),
              "boxes": BoxesKernel(*args)}
        ev._fused_kernels = ks
    return ks


def fused_kernels(ev) -> list:
    """The kernels generated for the fine stage of `ev`'s tape."""
    return list(_kernels(ev).values())


def level_core(ev, keys, n_in, cvec, li, h_child, pos, neg, off3, vv, cout):
    """Parents at depth d -> compacted active children at d+1.

    keys [cin] i32 (-1 padding), n_in int32 [1] (live parents), cvec the
    int32 per-level count vector of the chain (cvec[li] is set to the
    children's count), h_child the children's edge, pos / neg / off3
    the world -> model matrix split by sign, vv the input values.
    Returns (child_keys [cout] i32, n_out int32 [1])."""
    act, kid = level_active(_kernels(ev)["boxes"], keys, n_in, h_child, pos,
                            neg, off3, vv)
    # parent-major order keeps spatial (row-major) order stable
    out, n_out = _compact_keys(act, kid, cout)
    cvec[li] = n_out[0]
    return out, n_out


def leaf_core(ev, keys, n_leaf, cvec, li, h, mat, vv, cs, table=None):
    """Leaf cells -> compacted surface cells with sign masks, the
    corners' signs through the build's sign table `table` (a table of
    its own when none is given).

    Returns (surf_keys [cs], surf_mask [cs], n_surf int32 [1]); cvec[li]
    is set to n_surf."""
    dev = keys.device
    cl = keys.shape[0]
    if table is None:
        table = SignTable(8 * cl, dev)
    mask = leaf_masks(_kernels(ev)["table"], keys, n_leaf, h, mat, vv, table)
    live = (torch.arange(cl, device=dev) < n_leaf) & (keys >= 0)
    surf = live & (mask != 0) & (mask != 255)
    out_k, out_m, n_surf = _compact_keys(surf, keys, cs, mask)
    cvec[li] = n_surf[0]
    return out_k, out_m, n_surf


def crossing_list(surf_keys, surf_mask, n_surf, ccap, cvec=None, li=None):
    """Surface cells -> the compacted list of their crossing (cell,
    edge) slots, cell-major: (key, mask, slot = 12 * cell + edge) int32
    [ccap] each and the live count int32 [1] (cvec[li] is set to it
    when a count vector is given). A surface cell crosses at most 12
    edges."""
    dev = surf_keys.device
    c = surf_keys.shape[0]
    lv_tab = torch.as_tensor(CELL_TO_EDGE_TO_VERT.astype(np.int32),
                             device=dev)
    live = (torch.arange(c, device=dev) < n_surf) & (surf_keys >= 0)
    act = (lv_tab[surf_mask.long()] >= 0) & live[:, None]  # [c, 12]
    slot = torch.arange(c * 12, dtype=torch.int32, device=dev)
    key, mask, slot, n = _compact_keys(act, surf_keys[:, None].expand(c, 12),
                                       ccap, surf_mask[:, None].expand(c, 12),
                                       slot)
    if cvec is not None:
        cvec[li] = n[0]
    return key, mask, slot, n


def _slot_sums(vals, lv):
    """[4, C, cs]: vals [C, 12, cs] summed over the 12 edges into the 4
    vertex slots lv [12, cs] names, with selects, one edge after
    another from 0 (the order of the reference's sum over its edge
    axis, on every device)."""
    acc = None
    for e in range(12):
        sel = torch.stack([lv[e] == k for k in range(4)])[:, None, :]
        term = torch.where(sel, vals[None, :, e, :], 0.0)
        acc = term + 0.0 if acc is None else acc + term
    return acc


def edge_search(ev, cross, h, mat, vv, cs, rounds, samples, seeds):
    """The crossing list's edge search and gradients, scattered back to
    the [12, cs] (edge, cell) layout (zeros where no edge crosses): the
    intersection's world x, y, z, the distance there and the world
    gradient's x, y, z, f32 [12, cs] each."""
    ckey, cmask, cslot, ncross = cross
    dev = ckey.device
    found = unrolled_edges(_kernels(ev)["edges"], ckey, cmask, cslot, ncross,
                           mat, vv, h, samples=samples, rounds=rounds)
    # world gradients: one K4 launch over the list, model x's tangents
    # seeded with row 0 of the matrix's linear part (y's row 1, z's row 2)
    g = ev.eval_grad(*found[5:8], vv, seeds=seeds)[0]
    # slot 12 j + e -> e * cs + j; dead slots to a spare past the end
    live = torch.arange(ckey.shape[0], device=dev) < ncross
    dest = torch.where(live, (cslot % 12) * cs + cslot // 12,
                       12 * cs).long()

    def dense(v):
        out = torch.zeros(12 * cs + 1, dtype=torch.float32, device=dev)
        return out.scatter_(0, dest, v)[:12 * cs].reshape(12, cs)

    return (*(dense(found[k]) for k in (2, 3, 4, 8)),
            *(dense(g[1 + k]) for k in range(3)))


def edges_core(ev, surf_keys, surf_mask, n_surf, h, mat, vv, cs, rounds,
               samples, seeds, cross=None):
    """Surface cells -> per-(cell, vertex-slot) QEF data.

    `cross` is `crossing_list`'s (key, mask, slot, count) of the cells
    (listed here, at 12 slots a cell, when not given). Every
    crossing slot runs the N-ary bisection in one U1-P `unrolled_edges`
    launch and a gradient evaluation (K4 over the list); both scatter
    back to the [12, cs] (edge, cell) layout, zeros where no edge
    crosses, and reduce 12 -> 4 vertex slots through the
    CELL_TO_EDGE_TO_VERT table with pure selects. `seeds` is the world
    -> model matrix's linear part (K4's tangents).

    Returns a dict of flat id-ordered arrays ((cs + ext) * 4 rows, ids
    4*cell + slot, pre-padded with the collapse extension region):
      qef:   [*, 14] f32 (a00,a01,a02,a11,a12,a22, b0,b1,b2, btb,
                          sx,sy,sz, cnt), cell-local frame
      vpos:  [*, 3] world positions (QEF-solved, cell-clamped)
      verr:  [*] residuals
      vorig: [*, 3] the frame origin (the cell's lo corner)
    and idist [12, cs], the distance at each crossing slot's
    intersection (the primal of the reference's linearization; 0 where
    no edge crosses)."""
    dev = surf_keys.device
    surf_keys = surf_keys[:cs]
    mask = surf_mask[:cs]
    x, y, z = _dec(surf_keys)
    lv_tab = torch.as_tensor(CELL_TO_EDGE_TO_VERT.astype(np.int32),
                             device=dev)
    lv = lv_tab[mask.long()].T  # [12, cs]
    crossing = (lv >= 0) & (surf_keys >= 0)[None, :]

    if cross is None:
        cross = crossing_list(surf_keys, mask, n_surf, 12 * cs)
    ipx, ipy, ipz, idist, gx, gy, gz = edge_search(
        ev, cross, h, mat, vv, cs, rounds, samples, seeds)
    fin = torch.isfinite(gx) & torch.isfinite(gy) & torch.isfinite(gz)
    gn = torch.sqrt(gx * gx + gy * gy + gz * gz)
    w_ok = crossing & fin & (gn > 1e-20)
    inv = torch.where(w_ok, 1.0 / torch.where(gn == 0, 1.0, gn), 0.0)
    nx, ny, nz = gx * inv, gy * inv, gz * inv

    # QEF accumulation in the CELL-LOCAL frame (origin = the cell's lo
    # corner), where the f32 residual's cancellation noise stays below
    # the 1e-10 accept threshold (fidget_tpu/mesh/fused.py:314-320)
    clo = tuple(c.to(torch.float32) * h - 1.0 for c in (x, y, z))  # [cs]
    rpx = ipx - clo[0][None, :]
    rpy = ipy - clo[1][None, :]
    rpz = ipz - clo[2][None, :]
    bw = nx * rpx + ny * rpy + nz * rpz

    weighted = [nx * nx, nx * ny, nx * nz, ny * ny, ny * nz, nz * nz,
                nx * bw, ny * bw, nz * bw, bw * bw]
    plain = [rpx, rpy, rpz, torch.ones_like(ipx)]
    vals = torch.stack(
        [torch.where(w_ok, v, 0.0) for v in weighted]
        + [torch.where(crossing, v, 0.0) for v in plain])  # [14, 12, cs]
    sums = _slot_sums(vals, lv)  # [4, 14, cs]
    comps = [sums[:, k] for k in range(14)]  # [4, cs] each

    cnt = comps[13]
    massd = torch.clamp_min(cnt, 1.0)
    m3 = (comps[10] / massd, comps[11] / massd, comps[12] / massd)
    ata = tuple(comps[k] for k in range(6))
    atb = (comps[6], comps[7], comps[8])
    vx, vy, vz = solve_qef_c(torch, ata, atb, m3)
    vx = torch.clamp(vx, 0.0, h)
    vy = torch.clamp(vy, 0.0, h)
    vz = torch.clamp(vz, 0.0, h)
    verr = qef_err_c(torch, (vx, vy, vz), ata, atb, comps[9])
    # one relayout at the end: slot-major [4, cs, *] -> flat id-ordered
    # [(cs + ext) * 4, *], padded with the collapse extension region
    ext = cs  # covers the sum of the rounds' candidate slabs (< cs/3)

    def flat(a, k):
        return torch.cat([a.transpose(0, 1).reshape(cs * 4, k),
                          a.new_zeros((ext, k))])

    qef = flat(sums.permute(0, 2, 1), 14)
    vpos = flat(torch.stack([vx + clo[0][None, :], vy + clo[1][None, :],
                             vz + clo[2][None, :]], dim=2), 3)
    vorig = flat(torch.stack([c[None, :].expand(4, cs) for c in clo],
                             dim=2), 3)
    verr_f = torch.cat([verr.T.reshape(cs * 4), verr.new_zeros(ext)])
    return {"qef": qef, "vpos": vpos, "verr": verr_f, "vorig": vorig,
            "idist": idist}


def _bucket_pow2(n: int, lo: int = 1024) -> int:
    return max(lo, 1 << max(0, int(n - 1).bit_length()))


def _bucket_half(n: int, lo: int = 256) -> int:
    """Power-of-two bucket with 3/4 half-steps (<= 33% padding)."""
    p = _bucket_pow2(n, lo)
    if p * 3 // 4 >= max(n, lo):
        return p * 3 // 4
    return p


def _padded_vars(ev, var_vec):
    vv = np.zeros(max(1, ev.n_inputs), np.float32)
    if var_vec is not None:
        vv[: len(var_vec)] = np.asarray(var_vec, np.float32)
    return vv


def _tensor(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def fine_stage(ev, m, var_vec, depth, *, rounds, samples, cancel=None,
               clock=None):
    """Runs the device-resident fine pipeline.

    Returns None for an empty surface, else (cells [N,3] i64, mask [N]
    i32, the edge core's device arrays, n_surf, cs_cap): the device
    arrays stay resident; callers slice or gather what they need.
    """
    dev = ev.device
    kernels = fused_kernels(ev)
    if dev.type == "cuda" and not built(kernels):
        build_kernels(kernels)
    A = m[:3, :3].astype(np.float32)
    pos = _tensor(np.maximum(A, 0.0), dev)
    neg = _tensor(np.minimum(A, 0.0), dev)
    off3 = _tensor(m[:3, 3].astype(np.float32), dev)
    mat = _tensor(m[:3, :].astype(np.float32), dev)
    vv = _tensor(_padded_vars(ev, var_vec), dev)

    d0 = min(3, depth - 1)
    g0 = np.arange(1 << d0, dtype=np.int32)
    gx, gy, gz = np.meshgrid(g0, g0, g0, indexing="ij")
    keys_np = (
        (gx.astype(np.int64) * _KS + gy) * _KS + gz
    ).reshape(-1).astype(np.int32)
    n_seed = len(keys_np)

    # ONE worklist capacity for every level (early levels waste lanes;
    # the generated kernels skip them by the live count). Surface cells
    # are bounded by active leaves, so the leaf and edge cores share
    # the same bucket.
    cap_cache = ev.__dict__.setdefault("_fused_caps", {})
    G = 1 << depth
    cmax = cap_cache.get(
        ("cmax", depth), _bucket_pow2(max(n_seed, 8 * G * G))
    )

    # speculative mode: once a capacity is cached for this (tape, depth),
    # enqueue every level, the leaf pass and the crossing list WITHOUT
    # reading the per-level counts; the host reads the count vector once
    # at the end and falls back to the checked chain with a bigger bucket
    # on overflow
    h = 2.0 / (1 << depth)
    speculative = ("cmax", depth) in cap_cache

    def run_chain(cmax, checked):
        keys0 = np.full(cmax, -1, np.int32)
        keys0[:n_seed] = keys_np
        keys = _tensor(keys0, dev)
        n_in = _tensor(np.array([n_seed], np.int32), dev)
        n_lv = depth - d0
        cvec = torch.zeros(n_lv + 2, dtype=torch.int32, device=dev)
        # the build's sign table, sized for the leaf pass's 8 inserts a
        # cell (no count is read for it)
        table = SignTable(8 * cmax, dev)
        for i, d in enumerate(range(d0, depth)):
            check_cancel(cancel)
            h_child = 2.0 / (1 << (d + 1))
            keys, n_out = level_core(ev, keys, n_in, cvec, i, h_child, pos,
                                     neg, off3, vv, cmax)
            if checked:
                n = int(n_out)
                if n > cmax:
                    return None, n
                if clock is not None:
                    clock.tick(f"classify d={d + 1} ({n} active)")
                if n == 0:
                    return "empty", 0
            n_in = n_out
        surf_keys, surf_mask, n_surf = leaf_core(ev, keys, n_in, cvec, n_lv,
                                                 h, mat, vv, cmax, table)
        if not checked:
            # the cached bucket of the crossing list (the surface cells'
            # crossing edges), counted into the same vector
            ccap = cap_cache.get(("cross", depth), _bucket_pow2(12 * cmax))
            cross = crossing_list(surf_keys, surf_mask, n_surf, ccap,
                                  cvec, n_lv + 1)
            # one read for the whole chain (the count vector)
            cn = cvec.tolist()
            if max(cn[:-1]) > cmax:
                return None, max(cn[:-1])
            if clock is not None:
                clock.tick(
                    "classify chain (" +
                    "/".join(str(c) for c in cn[:-2]) +
                    f" active, {cn[-2]} surface, {cn[-1]} crossing)"
                )
            if 0 in cn[:-2]:
                return "empty", 0
            n_leaf = cn[-3]
            ns_here = cn[-2]
            if cn[-1] > ccap:  # only the list overflowed: list it again
                cross = crossing_list(surf_keys, surf_mask, n_surf,
                                      _bucket_pow2(cn[-1]), cvec, n_lv + 1)
        else:
            n_leaf = n
            ns_here = int(n_surf)
            if clock is not None:
                clock.tick(f"corner masks ({ns_here} surface)")
            # at most 12 crossing edges a surface cell: no overflow and
            # no read, over the lanes of the [12, cs] layout
            cross = crossing_list(surf_keys, surf_mask, n_surf,
                                  12 * _bucket_half(ns_here, lo=1024), cvec,
                                  n_lv + 1)
        # the table holds at most the leaf cells' 8 corners each, which
        # the count just read bounds more tightly than the bucket
        table.bound = 8 * n_leaf
        return (surf_keys, surf_mask, n_surf, cross, ns_here, table), ns_here

    while True:
        r, n = run_chain(cmax, checked=not speculative)
        if r is not None:
            break
        speculative = False
        cmax = _bucket_pow2(n)  # overflow: retry with the real count
    cap_cache[("cmax", depth)] = cmax
    if r == "empty":
        return None
    surf_keys, surf_mask, n_surf, cross, ns, table = r
    if ns == 0:
        return None
    # right-size the surface worklist: the edge core's [12, cs] layout
    # (the QEF sums), a half-step bucket (<= 33% padding) instead of cmax
    cs_cap = min(cmax, max(
        cap_cache.get(("cs", depth), 0), _bucket_half(ns, lo=1024)
    ))
    cap_cache[("cs", depth)] = cs_cap

    check_cancel(cancel)
    res = edges_core(ev, surf_keys, surf_mask, n_surf, h, mat, vv, cs_cap,
                     rounds, samples, mat[:, :3], cross)
    res["table"] = table  # the collapse rounds' (DeviceVertexStore)

    # host copies of the cell list (needed for the walk either way)
    sk = surf_keys[:ns].cpu().numpy().astype(np.int64)
    mk = surf_mask[:ns].cpu().numpy().astype(np.int32)
    # the crossing list's bucket for the next chain, counted on the host
    n_cross = int(_CROSSINGS[mk].sum())
    cap_cache[("cross", depth)] = max(cap_cache.get(("cross", depth), 0),
                                      _bucket_pow2(n_cross))
    cells = np.stack(
        [sk // (_KS * _KS), (sk // _KS) % _KS, sk % _KS], axis=1
    )
    if clock is not None:
        clock.tick(f"edge solve ({ns} cells, {n_cross} crossing edges)")
    return cells, mk, res, ns, cs_cap


# ----------------------------------------------------------------------
# device-resident collapse support


def _member_sum(a, kcap):
    """[kcap, ...]: a [kcap * 8, ...] summed over each candidate's 8
    member rows, one after another (the reference's order)."""
    a = a.reshape((kcap, 8) + a.shape[1:])
    acc = a[:, 0] + 0.0
    for j in range(1, 8):
        acc = acc + a[:, j]
    return acc


def merge_core(store, mvid, pb3, ps, kcap, n_cand):
    """One collapse round on the device: merged QEF solve and 27-point
    topology probe for kcap candidates (the first n_cand live), the
    store's arrays staying on the device. mvid [kcap * 8] i32 is the
    dense member table (candidate k's members at k*8..k*8+7, -1
    padding), pb3 [3, kcap] i32 the parents' lo corners (fine lattice),
    ps the parent size. Writes every
    candidate's merged QEF, position, residual and origin at the
    contiguous slab ext_base..ext_base+kcap; returns packed [kcap, 6]
    f32: topo, merged position xyz, merr, cerr + the f32 noise
    tolerance."""
    dev = store.qef.device
    h = store.h
    valid = mvid >= 0
    rid = torch.clamp_min(mvid, 0).long()
    rows = torch.where(valid[:, None], store.qef[rid], 0.0)  # [kcap*8, 14]
    segc = torch.arange(kcap * 8, device=dev) // 8
    lo = tuple(pb3[k].to(torch.float32) * h - 1.0 for k in range(3))

    # shift each member QEF from its own cell frame into the parent
    # frame (exact translation covariance: AtA fixed, Atb += AtA t,
    # btb += 2 t.Atb + t'AtA t, msum += cnt t)
    org = torch.where(valid[:, None], store.vorig[rid], 0.0)
    tx = org[:, 0] - lo[0][segc]
    ty = org[:, 1] - lo[1][segc]
    tz = org[:, 2] - lo[2][segc]
    a00, a01, a02 = rows[:, 0], rows[:, 1], rows[:, 2]
    a11, a12, a22 = rows[:, 3], rows[:, 4], rows[:, 5]
    b0, b1, b2 = rows[:, 6], rows[:, 7], rows[:, 8]
    at0 = a00 * tx + a01 * ty + a02 * tz
    at1 = a01 * tx + a11 * ty + a12 * tz
    at2 = a02 * tx + a12 * ty + a22 * tz
    nb0, nb1, nb2 = b0 + at0, b1 + at1, b2 + at2
    nbtb = (
        rows[:, 9]
        + 2.0 * (tx * b0 + ty * b1 + tz * b2)
        + (tx * at0 + ty * at1 + tz * at2)
    )
    cntm = rows[:, 13]
    rows = torch.stack(
        [a00, a01, a02, a11, a12, a22, nb0, nb1, nb2, nbtb,
         rows[:, 10] + cntm * tx, rows[:, 11] + cntm * ty,
         rows[:, 12] + cntm * tz, cntm],
        dim=1,
    )
    mqef = _member_sum(rows, kcap)
    cerr = _member_sum(torch.where(valid, store.verr[rid], 0.0), kcap)
    ata = tuple(mqef[:, k] for k in range(6))
    atb = (mqef[:, 6], mqef[:, 7], mqef[:, 8])
    btb = mqef[:, 9]
    cnt = torch.clamp_min(mqef[:, 13], 1.0)
    mass = (mqef[:, 10] / cnt, mqef[:, 11] / cnt, mqef[:, 12] / cnt)
    vx, vy, vz = solve_qef_c(torch, ata, atb, mass)
    top = float(np.float32(ps) * np.float32(h))
    vx = torch.clamp(vx, 0.0, top)
    vy = torch.clamp(vy, 0.0, top)
    vz = torch.clamp(vz, 0.0, top)
    merr = qef_err_c(torch, (vx, vy, vz), ata, atb, btb)
    # f32 cancellation floor of the residual, returned so the accept
    # test can discount it (scales with the largest term)
    tol = 2.4e-7 * torch.abs(btb)

    # the topology test on the 27-point sign lattice (U1-P's merge entry:
    # only the points the build's sign table lacks are evaluated)
    topo = merge_topo(_kernels(store.ev)["table"], pb3, ps, n_cand, h,
                      store.mat, store.vv, store.table)

    # the ext region write is one contiguous slab
    base = store.ext_base
    mvg = torch.stack([vx + lo[0], vy + lo[1], vz + lo[2]], dim=1)
    store.qef[base:base + kcap] = mqef
    store.vpos[base:base + kcap] = mvg
    store.verr[base:base + kcap] = merr
    store.vorig[base:base + kcap] = torch.stack(lo, dim=1)
    # one packed download: topo, merged position, merr, cerr+tol
    return torch.cat(
        [topo.to(torch.float32)[:, None], mvg,
         merr[:, None], (cerr + tol)[:, None]], dim=1,
    )


class DeviceVertexStore:
    """Collapse vertex store with all per-vertex data on the device.

    Fine vertices occupy flat ids 4*cell + slot (the edge core's [cs, 4]
    layout); merged vertices append into an extension region. Per round
    only (topo, mv, merr, cerr) come to the host; the QEF sums never
    leave the device.
    """

    def __init__(self, ev, m, var_vec, h, res, cs_cap, depth):
        self.ev = ev
        self.h = float(h)
        self.depth = depth
        dev = res["qef"].device
        self.mat = _tensor(m[:3, :].astype(np.float32), dev)
        self.vv = _tensor(_padded_vars(ev, var_vec), dev)
        # the arrays arrive flat and pre-padded from the edge core
        self.cap = int(res["verr"].shape[0])
        self.qef = res["qef"]
        self.vpos = res["vpos"]
        self.verr = res["verr"]
        self.vorig = res["vorig"]
        self.ext_base = cs_cap * 4
        # the build's sign table from the leaf core (any table serves: a
        # point's sign depends on its key alone)
        self.table = res.get("table")
        if self.table is None:
            self.table = SignTable(0, dev)

    def _ensure_ext(self, need):
        """Grows the extension region in slabs."""
        if self.ext_base + need <= self.cap:
            return
        ext = max(need, self.cap // 2)
        self.qef = torch.cat([self.qef, self.qef.new_zeros((ext, 14))])
        self.vpos = torch.cat([self.vpos, self.vpos.new_zeros((ext, 3))])
        self.verr = torch.cat([self.verr, self.verr.new_zeros(ext)])
        self.vorig = torch.cat([self.vorig, self.vorig.new_zeros((ext, 3))])
        self.cap += ext

    def merge_round(self, member_vids, seg_member, pbase, ps):
        """Merged QEF solve + topology test for K candidate parents, as
        `HostVertexStore.merge_round` (mesh/collapse.py). Returns (topo
        [K], mv [K,3], merr [K], cerr [K]) as host numpy."""
        K = len(pbase)
        M = len(member_vids)
        # per-round half-step buckets: uploads and downloads are sized to
        # the round
        kcap = _bucket_half(K)
        self._ensure_ext(kcap)
        # dense member table [kcap, 8]: <= 8 same-size members a parent
        starts = np.searchsorted(seg_member, np.arange(K))
        slot = np.arange(M) - starts[seg_member]
        mv_p = np.full(kcap * 8, -1, np.int32)
        mv_p[seg_member * 8 + slot] = member_vids
        pb_p = np.zeros((3, kcap), np.int32)
        pb_p[:, :K] = pbase.T
        dev = self.qef.device
        packed = merge_core(self, _tensor(mv_p, dev),
                            _tensor(pb_p, dev), int(ps), kcap, K)
        self._last = (self.ext_base, kcap)
        self.ext_base += kcap
        p = packed[:K].cpu().numpy().astype(np.float64)
        return p[:, 0] > 0.5, p[:, 1:4], p[:, 4], p[:, 5]

    def commit(self, accept):
        base, _ = self._last
        return base + np.nonzero(accept)[0]

    def final_positions(self, ids):
        u = len(ids)
        ucap = _bucket_pow2(max(1, u), 256)
        idp = np.zeros(ucap, np.int32)
        idp[:u] = ids
        out = self.vpos[_tensor(idp, self.vpos.device).long()].cpu().numpy()
        return out[:u].astype(np.float32)
