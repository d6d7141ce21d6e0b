"""Manifold Dual Contouring meshing.

The counterpart of `fidget_tpu.mesh`. With `Settings(eval="interp")`
(the default), the reference's octree mesher
(fidget-mesh/src/{octree,cell,dc,qef}.rs) as dense batched levels, on
`BulkEvaluator` (eval/bulk.py):

1. **Level-synchronous build** — all active cells of one depth are
   interval-evaluated in one K1 launch (`_classify_cells`); empty and
   full cells are dropped and survivors subdivide 8x (octree.rs:521-583
   restructured as worklists).
2. **Leaf pass** — unique corner lattice points are deduplicated and
   point-evaluated in one K3 launch (`_corner_signs`); corner signs form
   the 8-bit MDC mask per cell (octree.rs:596-637).
3. **Edge search** — crossing edges are deduplicated across cells and
   refined with the reference's N-ary search: 4 rounds of 16 samples,
   one K3 launch a round (`_edge_search`, octree.rs:687-767).
4. **Gradients + QEF** — one K4 launch at the intersections; per-vertex
   QEFs (grouped by the MDC corner-cluster tables) are accumulated and
   solved by the native host kernels (native/mesh_kernels.cpp), clamped
   to cell bounds.
5. **Dual triangulation** — the uniform dual walk, or with
   `Settings.collapse` (the default) the topology-safe collapse and
   adaptive dual walk of `collapse.py`, whose 27-point sign probes run
   on K3 (`offset_signs`).

Cell lists, keys and topology stay host-side numpy, as in the
reference; the box and lattice decode of each evaluation runs on the
device in torch ops, and only lattice coordinates go up and signs or
t* come back.

With `Settings(eval="unrolled")`, stages 1-4 run as the device-resident
fine stage of `fused.py` on two kernels generated for the tape (U2-B
classifies the octree's boxes, U1-P the corner, edge and lattice
points) and K4 (the gradients): only a count per level (none on a chain
whose capacity is cached), the surface cells and each collapse round's
results come to the host, and the collapse keeps the vertices' QEF
data on the device (`fused.DeviceVertexStore`).

Known topology caveat (shared with the reference): an *ambiguous face*
— alternating corner signs, so all 4 of its lattice edges cross — whose
two adjacent cells each cluster to a single vertex pinches the surface:
that vertex pair is a quad side once per crossing edge, i.e. 4 times
(2 per direction; 3 when one ring quad is dropped at the open volume
boundary). The reference's dual walk emits the identical topology (same
Nielson clustering per fidget-mesh/build.rs, same quad-per-crossing-edge
emission per dc.rs:11-226). Resolving the pinch requires
face-sample-dependent vertex splitting (MC33-style), which neither
implementation performs.
"""

from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..compiler.tape import Tape
from ..eval import cuda
from ..eval.bulk import BulkEvaluator
from ..render.config import check_cancel
from ..shape import Shape, ShapeVars
from .tables import (
    CELL_TO_EDGE_TO_VERT,
    EDGE_AXIS,
    EDGE_HI,
    EDGE_LO,
    VERT_COUNT,
)

__all__ = ["Mesh", "Settings", "build_mesh", "write_obj", "write_stl"]

_EDGE_SAMPLES = 16  # octree.rs: 16 samples ...
_EDGE_ROUNDS = 4  # ... x 4 rounds

class _StageClock:
    """Wall-clock stage attribution. When enabled, each `tick` waits for
    the card (so a stage's kernels land in it) and records (label, ms)
    in `stages`."""

    def __init__(self, enabled=False, device=None):
        self.enabled = enabled
        self.sync = device is not None and torch.device(device).type == "cuda"
        self.stages = []
        self.t = time.perf_counter()

    def tick(self, label):
        if not self.enabled:
            return
        if self.sync:
            torch.cuda.synchronize()
        now = time.perf_counter()
        ms = (now - self.t) * 1e3
        self.stages.append((label, ms))
        self.t = now


@dataclass
class Settings:
    """Meshing settings (fidget-mesh/src/lib.rs:84-110 analog).

    collapse enables topology-safe bottom-up cell merging (the
    reference's adaptive octree, octree.rs:248-440): fewer triangles in
    flat regions at the same surface accuracy. device is the evaluation
    device: None means CUDA, and raises when there is no card; pass
    "cpu" for the plain PyTorch versions of the kernels."""

    depth: int = 5
    world_to_model: np.ndarray | None = None
    vars: ShapeVars | dict | None = None
    collapse: bool = True
    device: object = None
    #: "interp" runs cell classify / corner signs / edge search through
    #: the tape interpreter kernels (zero per-shape builds). "unrolled"
    #: runs the device-resident fine stage (mesh/fused.py) on kernels
    #: generated for the tape (U1-P, U2-B; one nvcc build per shape,
    #: cached on disk); gradients at the intersections stay on K4.
    eval: str = "interp"
    #: optional CancelToken, polled between octree levels, eval
    #: stages, and collapse size-rounds (the reference polls per cell,
    #: fidget-mesh/src/octree.rs:527-529)
    cancel: object | None = None


@dataclass
class Mesh:
    """An indexed triangle mesh in world coordinates (host numpy)."""

    vertices: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.float32)
    )
    triangles: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 3), np.int32)
    )

    def write_stl(self, f) -> None:
        write_stl(self, f)

    def write_obj(self, f) -> None:
        write_obj(self, f)


def write_obj(mesh: Mesh, f) -> None:
    """Wavefront OBJ writer (indexed: shared vertices, unlike STL)."""
    own = isinstance(f, (str, bytes, os.PathLike))
    fh = open(f, "w") if own else f
    try:
        for v in np.asarray(mesh.vertices, np.float64):
            fh.write(f"v {v[0]:.9g} {v[1]:.9g} {v[2]:.9g}\n")
        for t in np.asarray(mesh.triangles, np.int64) + 1:  # 1-indexed
            fh.write(f"f {t[0]} {t[1]} {t[2]}\n")
    finally:
        if own:
            fh.close()


def write_stl(mesh: Mesh, f) -> None:
    """Binary STL writer (fidget-mesh/src/output.rs:7-40)."""
    own = isinstance(f, (str, bytes, os.PathLike))
    fh = open(f, "wb") if own else f
    try:
        fh.write(b"\x00" * 80)
        tris = mesh.triangles
        fh.write(struct.pack("<I", len(tris)))
        v = mesh.vertices
        a = v[tris[:, 0]]
        b = v[tris[:, 1]]
        c = v[tris[:, 2]]
        n = np.cross(b - a, c - a)
        ln = np.linalg.norm(n, axis=1, keepdims=True)
        n = np.where(ln > 0, n / np.maximum(ln, 1e-30), 0.0)
        rec = np.zeros((len(tris), 12), "<f4")
        rec[:, 0:3] = n
        rec[:, 3:6] = a
        rec[:, 6:9] = b
        rec[:, 9:12] = c
        buf = np.zeros(len(tris), dtype=[("d", "<f4", 12), ("attr", "<u2")])
        buf["d"] = rec
        fh.write(buf.tobytes())
    finally:
        if own:
            fh.close()


# ---------------------------------------------------------------------------


def _mat_and_vars(tape_or_shape, settings):
    shape_t = None
    if isinstance(tape_or_shape, Shape):
        shape_t = tape_or_shape.transform
        tape = tape_or_shape.tape()
    else:
        tape = tape_or_shape
    m = np.eye(4) if settings.world_to_model is None else np.asarray(
        settings.world_to_model, np.float64
    )
    if shape_t is not None:
        m = shape_t @ m
    if not np.allclose(m[3], [0, 0, 0, 1]):
        raise NotImplementedError("meshing requires an affine transform")
    vec = np.zeros(max(1, len(tape.var_map)), np.float32)
    vars = settings.vars
    missing = []
    for v, i in tape.var_map.items():
        if v.kind == "v":
            if vars is not None and v in vars:
                vec[i] = np.float32(vars[v])
            else:
                missing.append(v)
    if missing:
        raise ValueError(f"unbound shape variables: {missing}")
    return tape, m.astype(np.float64), vec[: len(tape.var_map)]


def _xform(m, pts):
    """Affine world -> model on host [N, 3] (float32)."""
    m = m.astype(np.float32)
    return pts.astype(np.float32) @ m[:3, :3].T + m[:3, 3]


def _affine(ev, m, w):
    """World [N, 3] f32 tensor -> model (x, y, z) [N] f32 tensors under
    the affine `m`, one product and sum at a time (no fused
    multiply-add, so the card and the CPU round alike)."""
    a = torch.as_tensor(m[:3].astype(np.float32), device=ev.device)
    return tuple(
        w[:, 0] * a[k, 0] + w[:, 1] * a[k, 1] + w[:, 2] * a[k, 2] + a[k, 3]
        for k in range(3)
    )


def _lattice_points(coords, h):
    """Integer lattice coordinates [N, 3] -> world points, k * h - 1 in
    f32."""
    return coords.to(torch.float32) * np.float32(h) - 1.0


def _classify_cells(ev, cells, h, m, var_vec):
    """np [N] bool: cells (lattice coords, edge h) not provably
    empty/full under world->model transform m. The cell box maps
    through the affine transform with the positive/negative coefficient
    split (exact box bounds), on the device; one K1 launch classifies
    every cell."""
    c = torch.from_numpy(np.asarray(cells, np.int32)).to(ev.device)
    wlo = _lattice_points(c, h)
    whi = wlo + np.float32(h)
    a = m[:3].astype(np.float32)
    pos, neg = np.maximum(a[:, :3], 0.0), np.minimum(a[:, :3], 0.0)
    box = []
    for k in range(3):
        p = torch.as_tensor(pos[k], device=ev.device)
        n = torch.as_tensor(neg[k], device=ev.device)
        lo = (wlo * p).sum(dim=1) + (whi * n).sum(dim=1) + float(a[k, 3])
        hi = (whi * p).sum(dim=1) + (wlo * n).sum(dim=1) + float(a[k, 3])
        box.append((lo, hi))
    act = ev.eval_interval(*box, var_vec, classify=True)[0]
    return act.cpu().numpy()


def _corner_signs(ev, uniq, G, h, m, var_vec):
    """np [U] bool inside-signs for unique corner-lattice keys
    key = (x*(G+1) + y)*(G+1) + z, decoded on the device (4 bytes a
    corner go up, 1 comes back)."""
    keys = torch.from_numpy(np.asarray(uniq, np.int32)).to(ev.device)
    stride = G + 1
    coords = torch.stack(
        [keys // (stride * stride), (keys // stride) % stride, keys % stride],
        dim=1,
    )
    mp = _affine(ev, m, _lattice_points(coords, h))
    return ev.eval(*mp, var_vec, signs=True)[0].cpu().numpy()


def offset_signs(ev, base, offsets, scale, h, m, var_vec):
    """np [C, K] bool inside-signs at base + offsets*scale (lattice
    units, cell edge h, world->model m), decoded on the device: 12
    bytes a base go up instead of 12 bytes a point (the collapse
    loop's 27-point sign lattice)."""
    C, K = len(base), len(offsets)
    if C == 0:
        return np.zeros((0, K), bool)
    b = torch.from_numpy(np.asarray(base, np.int32)).to(ev.device)
    o = torch.from_numpy(np.asarray(offsets, np.int32)).to(ev.device)
    coords = (b[:, None, :] + o[None, :, :] * int(scale)).reshape(-1, 3)
    mp = _affine(ev, m, _lattice_points(coords, h))
    return ev.eval(*mp, var_vec, signs=True)[0].reshape(C, K).cpu().numpy()


def _edge_search(ev, p_start, p_end, m, var_vec, rounds=_EDGE_ROUNDS,
                 samples=_EDGE_SAMPLES):
    """N-ary edge search (octree.rs:687-767): per round, `samples` points
    along each [ta, tb] bracket are evaluated in one K3 launch and the
    bracket tightens on the first inside->outside flip; the bracket
    stays (start inside, end outside). p_start / p_end: [E, 3] world
    endpoints (start inside, end outside). Returns t* np [E] f64."""
    dev = ev.device
    ps = torch.from_numpy(p_start.astype(np.float32)).to(dev)
    d = torch.from_numpy(p_end.astype(np.float32)).to(dev) - ps
    E = ps.shape[0]
    frac = (torch.arange(samples, dtype=torch.float32, device=dev) + 1.0) / (
        samples + 1.0
    )
    idx = torch.arange(samples, device=dev)
    ta = torch.zeros(E, dtype=torch.float32, device=dev)
    tb = torch.ones(E, dtype=torch.float32, device=dev)
    for _ in range(rounds):
        ts = ta[:, None] + (tb - ta)[:, None] * frac[None, :]  # [E, S]
        pts = ps[:, None, :] + d[:, None, :] * ts[..., None]
        mp = _affine(ev, m, pts.reshape(-1, 3))
        outside = ~ev.eval(*mp, var_vec, signs=True)[0].reshape(E, samples)
        any_out = outside.any(dim=1)
        # the first flip: the least index of an outside sample (an
        # exact rule on every device, unlike an argmax's tie order)
        F = torch.where(outside, idx, samples - 1).amin(dim=1)
        tbF = ts.gather(1, F[:, None])[:, 0]
        prev = (F - 1).clamp(min=0)
        taF = ts.gather(1, prev[:, None])[:, 0]
        new_tb = torch.where(any_out, tbF, tb)
        ta = torch.where(
            any_out & (F > 0), taF,
            torch.where(any_out, ta, ts[:, -1]),  # all inside: advance ta
        )
        tb = new_tb
    return (0.5 * (ta + tb)).cpu().numpy().astype(np.float64)


#: evaluator cache: repeat builds of the same tape (viewer reload,
#: parameter fitting, benchmarks) reuse one BulkEvaluator, its packed
#: arena and its per-instance-count tape copies. Values pin their tape,
#: keeping the id key stable.
_EV_CACHE: dict = {}
_EV_CACHE_CAP = 16


def _get_evaluator(tape, device, unrolled=False):
    """The cached evaluator of (tape, device, eval mode); an unrolled
    one also keeps the fine stage's kernels and capacities."""
    key = (id(tape), str(device), bool(unrolled))
    ev = _EV_CACHE.get(key)
    if ev is None:
        while len(_EV_CACHE) >= _EV_CACHE_CAP:
            _EV_CACHE.pop(next(iter(_EV_CACHE)))
        ev = BulkEvaluator(tape, device=device)
        _EV_CACHE[key] = ev
    return ev


def build_mesh(tape: Tape | Shape, settings: Settings | None = None, *,
               clock: _StageClock | None = None) -> Mesh:
    """Builds an MDC mesh of the surface inside the world ±1 cube.

    `clock`, if given, receives the time of each stage (`_StageClock`).

    >>> from fidget_tpu_torch import Shape, Tree
    >>> from fidget_tpu_torch.mesh import Settings, build_mesh
    >>> x, y, z = Tree.axes()
    >>> s = Shape.from_tree(
    ...     (x.square() + y.square() + z.square()).sqrt() - 0.6
    ... )
    >>> m = build_mesh(s, Settings(depth=3, device="cpu"))
    >>> len(m.triangles) > 0 and m.vertices.shape[1] == 3
    True
    """
    settings = settings or Settings()
    if settings.eval not in ("interp", "unrolled"):
        raise ValueError(
            f"Settings.eval must be 'interp' or 'unrolled', got "
            f"{settings.eval!r}"
        )
    if not 0 < settings.depth <= 10:
        # corner-lattice keys (x*(G+1)+y)*(G+1)+z ride int32 through
        # the device decode: depth 10 (G=1024) peaks at ~1.08e9 < 2^31;
        # depth 11 would silently wrap negative and corrupt the mesh
        raise ValueError(
            f"Settings.depth must be in 1..10 (int32 lattice keys), "
            f"got {settings.depth}"
        )
    device = cuda.resolve_device(settings.device)
    tape, m, var_vec = _mat_and_vars(tape, settings)
    ev = _get_evaluator(tape, device, settings.eval == "unrolled")
    if clock is None:
        clock = _StageClock(device=device)
    depth = settings.depth
    G = 1 << depth  # leaf grid resolution per axis
    h_leaf = 2.0 / G

    if settings.eval == "unrolled":
        return _build_mesh_fused(ev, m, var_vec, settings, clock)

    # ---- stage 1: level-synchronous interval build ----------------------
    # Start directly from the dense 16^3 grid at depth 4: levels 0-3
    # hold at most 585 cells, and interval proofs are per cell, so
    # pruning is unaffected.
    d_start = 4 if depth > 4 else 0
    if d_start:
        g0 = np.arange(1 << d_start, dtype=np.int64)
        cells = np.stack(
            np.meshgrid(g0, g0, g0, indexing="ij"), axis=-1
        ).reshape(-1, 3)
    else:
        cells = np.zeros((1, 3), np.int64)  # coords at current depth
    for d in range(d_start, depth):
        check_cancel(settings.cancel)
        h = 2.0 / (1 << d)
        active = _classify_cells(ev, cells, h, m, var_vec)
        cells = cells[active]
        clock.tick(f"classify d={d} ({len(cells)} active)")
        if len(cells) == 0:
            return Mesh()
        # subdivide x8
        off = np.array(
            [[i, j, k] for k in (0, 1) for j in (0, 1) for i in (0, 1)],
            np.int64,
        )
        cells = (cells[:, None, :] * 2 + off[None, :, :]).reshape(-1, 3)

    # final leaf-level cull
    check_cancel(settings.cancel)
    h = h_leaf
    active = _classify_cells(ev, cells, h, m, var_vec)
    cells = cells[active]
    clock.tick(f"classify leaf ({len(cells)} active)")
    if len(cells) == 0:
        return Mesh()
    N = len(cells)

    # ---- stage 2: deduplicated corner evaluation -------------------------
    corner_off = np.array(
        [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)],
        np.int64,
    )
    corners = cells[:, None, :] + corner_off[None, :, :]  # [N, 8, 3]
    ckeys = (
        corners[..., 0] * (G + 1) + corners[..., 1]
    ) * (G + 1) + corners[..., 2]
    uniq, inv = np.unique(ckeys.reshape(-1), return_inverse=True)
    usigns = _corner_signs(ev, uniq, G, h, m, var_vec)
    clock.tick(f"corner signs ({len(uniq)} unique)")
    csigns = usigns[inv].reshape(N, 8)
    mask = (csigns << np.arange(8)[None, :]).sum(axis=1).astype(np.int32)
    surf = (mask != 0) & (mask != 255)
    cells, mask = cells[surf], mask[surf]
    N = len(cells)
    if N == 0:
        return Mesh()

    # ---- stage 3: crossing-edge dedup + N-ary search ----------------------
    crossing = CELL_TO_EDGE_TO_VERT[mask] >= 0  # [N, 12]
    ci, ei = np.nonzero(crossing)
    # canonical edge key: (axis, lattice coords of the edge's lo corner)
    lo_corner = cells[ci] + corner_off[EDGE_LO[ei]]
    ekeys = (
        (EDGE_AXIS[ei].astype(np.int64) * (G + 1)
         + lo_corner[:, 0]) * (G + 1) + lo_corner[:, 1]
    ) * (G + 1) + lo_corner[:, 2]
    check_cancel(settings.cancel)
    ukeys, einv = np.unique(ekeys, return_inverse=True)
    first = np.full(len(ukeys), np.iinfo(np.int64).max, np.int64)
    np.minimum.at(first, einv, np.arange(len(einv)))
    rep_ci, rep_ei = ci[first], ei[first]
    E = len(ukeys)
    # directed endpoints: start inside (<0), end outside (>= 0)
    lo_c = EDGE_LO[rep_ei]
    hi_c = EDGE_HI[rep_ei]
    lo_in = (mask[rep_ci] >> lo_c) & 1
    start_c = np.where(lo_in == 1, lo_c, hi_c)
    end_c = np.where(lo_in == 1, hi_c, lo_c)
    p_start = (cells[rep_ci] + corner_off[start_c]) * h - 1.0
    p_end = (cells[rep_ci] + corner_off[end_c]) * h - 1.0
    t_star = _edge_search(ev, p_start, p_end, m, var_vec)
    ipts = p_start + (p_end - p_start) * t_star[:, None]  # world coords [E,3]
    clock.tick(f"edge search ({E} edges)")

    # ---- stage 4: gradients + per-vertex QEF ------------------------------
    mip = _xform(m, ipts)
    g = ev.eval_grad(mip[:, 0], mip[:, 1], mip[:, 2], var_vec)[0]
    g = g.cpu().numpy()
    clock.tick("gradients")
    grads_model = g[1:4].T  # [E, 3]
    grads = grads_model @ m[:3, :3]  # chain rule: d/d(world) = J^T g
    bad = ~np.isfinite(grads).all(axis=1)
    gn = np.linalg.norm(grads, axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        normals = np.where(
            bad[:, None] | (gn < 1e-20), 0.0, grads / np.maximum(gn, 1e-20)
        )

    # global vertex ids: per-cell offset + local MDC vertex index
    nvert = VERT_COUNT[mask]
    voff = np.concatenate([[0], np.cumsum(nvert)]).astype(np.int64)
    NV = int(voff[-1])
    vid = voff[ci] + CELL_TO_EDGE_TO_VERT[mask[ci], ei]  # per (cell, edge)
    e_of = einv  # unique-edge id per (cell, edge) instance

    pt = ipts[e_of]
    nm = normals[e_of]
    w = np.isfinite(nm).all(axis=1) & (np.linalg.norm(nm, axis=1) > 0)

    from .. import native

    acc = native.qef_accumulate_batch(vid, pt, nm, w, NV)
    msum = acc[:, 0:3]
    mcnt = acc[:, 3]
    AtA = np.empty((NV, 3, 3))
    AtA[:, 0, 0] = acc[:, 4]
    AtA[:, 0, 1] = AtA[:, 1, 0] = acc[:, 5]
    AtA[:, 0, 2] = AtA[:, 2, 0] = acc[:, 6]
    AtA[:, 1, 1] = acc[:, 7]
    AtA[:, 1, 2] = AtA[:, 2, 1] = acc[:, 8]
    AtA[:, 2, 2] = acc[:, 9]
    Atb = acc[:, 10:13]
    btb = acc[:, 13]
    mass = msum / np.maximum(mcnt, 1.0)[:, None]

    # batched truncated solve about the mass point (qef.rs:67-80); a
    # non-finite solution falls back to the (in-cell) mass point, so
    # clamping after is always well-defined
    from .collapse import _solve_qef

    vpos = _solve_qef(AtA, Atb, mass)
    # clamp to the owning cell's bounds (one leaf cell per vertex)
    cell_of_vert = np.repeat(np.arange(N), nvert)
    clo = cells[cell_of_vert] * h - 1.0
    vpos = np.clip(vpos, clo, clo + h)
    clock.tick(f"QEF accumulate+solve ({NV} verts)")

    return _assemble_mesh(
        ev, m, var_vec, settings, clock, G, h, cells, mask, nvert, voff,
        AtA, Atb, btb, msum, mcnt, vpos, crossing,
    )


def _build_mesh_fused(ev, m, var_vec, settings, clock):
    """build_mesh body for Settings(eval="unrolled"): the device-resident
    fine stage (mesh/fused.py) replaces the staged classify / corner /
    edge-search / gradient launches, and the collapse runs against the
    DeviceVertexStore, so per-vertex QEF data never leaves the device:
    only cell keys, masks and each round's candidate results do."""
    from .collapse import collapse_and_walk
    from .fused import DeviceVertexStore, fine_stage

    depth = settings.depth
    G = 1 << depth
    h = 2.0 / G
    r = fine_stage(
        ev, m, var_vec, depth, rounds=_EDGE_ROUNDS,
        samples=_EDGE_SAMPLES, cancel=settings.cancel, clock=clock,
    )
    if r is None:
        return Mesh()
    cells, mask, res, ns, cs_cap = r
    nvert = VERT_COUNT[mask]
    crossing = CELL_TO_EDGE_TO_VERT[mask] >= 0

    if settings.collapse:
        # flat vertex ids 4*cell + slot match the device store layout
        voff4 = np.arange(len(cells) + 1, dtype=np.int64) * 4
        store = DeviceVertexStore(ev, m, var_vec, h, res, cs_cap, depth)
        v_bits_all = (np.arange(12) % 4)[None, :]
        own_all = crossing & (v_bits_all == 0)
        oci_all, oei_all = np.nonzero(own_all)
        check_cancel(settings.cancel)
        verts, tris = collapse_and_walk(
            ev=ev, m=m, var_vec=var_vec, G=G, h=h,
            cells=cells, mask=mask, nvert=nvert, voff=voff4,
            oci=oci_all, oei=oei_all, store=store,
            cancel=settings.cancel, clock=clock,
        )
        clock.tick("dual walk")
        return Mesh(vertices=verts, triangles=tris.astype(np.int32))

    # uniform walk: only the vertex positions come down
    voff = np.concatenate([[0], np.cumsum(nvert)]).astype(np.int64)
    ci2, lv2 = np.nonzero(np.arange(4)[None, :] < nvert[:, None])
    vpos_d = (
        res["vpos"][: ns * 4].cpu().numpy()
        .reshape(ns, 4, 3)
        .astype(np.float64)[ci2, lv2]
    )
    clock.tick(f"vertex download ({len(vpos_d)} verts)")
    return _assemble_mesh(
        ev, m, var_vec, settings, clock, G, h, cells, mask, nvert, voff,
        None, None, None, None, None, vpos_d, crossing,
    )


def _assemble_mesh(
    ev, m, var_vec, settings, clock, G, h, cells, mask, nvert, voff,
    AtA, Atb, btb, msum, mcnt, vpos, crossing,
):
    """Shared tail of build_mesh: canonical crossing-edge enumeration,
    then the adaptive (collapse) or uniform dual walk."""
    # enumerate each crossing edge once, from its canonical owner cell
    # (the cell whose local edge has both fixed coords == 0) — shared by
    # the uniform and adaptive walks
    v_bits_all = (np.arange(12) % 4)[None, :]
    own_all = crossing & (v_bits_all == 0)
    oci_all, oei_all = np.nonzero(own_all)

    if settings.collapse:
        from .collapse import collapse_and_walk

        check_cancel(settings.cancel)
        verts, tris = collapse_and_walk(
            ev=ev, m=m, var_vec=var_vec, G=G, h=h,
            cells=cells, mask=mask, nvert=nvert, voff=voff,
            AtA=AtA, Atb=Atb, btb=btb, msum=msum, mcnt=mcnt, vpos=vpos,
            oci=oci_all, oei=oei_all, cancel=settings.cancel,
            clock=clock,
        )
        clock.tick("dual walk")
        return Mesh(vertices=verts, triangles=tris.astype(np.int32))

    # ---- stage 5: uniform dual triangulation ------------------------------
    # index lookup: leaf lattice key -> cell row
    cell_keys = (cells[:, 0] * G + cells[:, 1]) * G + cells[:, 2]
    order = np.argsort(cell_keys)
    sorted_keys = cell_keys[order]

    def cell_rows(coords):
        """[K, 3] lattice coords -> row ids (-1 if absent)."""
        keys = (coords[:, 0] * G + coords[:, 1]) * G + coords[:, 2]
        pos = np.searchsorted(sorted_keys, keys)
        pos = np.clip(pos, 0, len(sorted_keys) - 1)
        ok = (
            (sorted_keys[pos] == keys)
            & (coords >= 0).all(axis=1)
            & (coords < G).all(axis=1)
        )
        return np.where(ok, order[pos], -1)

    oci, oei = oci_all, oei_all
    if len(oci) == 0:
        tris = np.zeros((0, 3), np.int64)
    else:
        axis = EDGE_AXIS[oei]
        # traverse the 4 adjacent cells in right-handed cyclic order
        # around +axis so the quad loop is CCW seen from the edge tip
        u1 = (axis + 1) % 3
        u2 = (axis + 2) % 3
        base = cells[oci]
        rng = np.arange(len(oci))
        quads = []
        for d1, d2 in ((0, 0), (1, 0), (1, 1), (0, 1)):
            nb = base.copy()
            nb[rng, u1] -= d1
            nb[rng, u2] -= d2
            rows = cell_rows(nb)
            # local edge v-bits use the sorted (lo_ax, hi_ax) convention
            vbits = np.where(u1 < u2, d1 + 2 * d2, d2 + 2 * d1)
            local_e = axis * 4 + vbits
            lv = np.where(
                rows >= 0, CELL_TO_EDGE_TO_VERT[mask[rows], local_e], -1
            )
            quads.append(np.where(rows >= 0, voff[rows] + lv, -1))
        q = np.stack(quads, axis=1)  # [K, 4] vertex ids around the edge
        good = (q >= 0).all(axis=1)
        q = q[good]
        # winding: orient by the sign of the edge's lo corner
        lo_inside = ((mask[oci] >> EDGE_LO[oei]) & 1).astype(bool)[good]
        qq = np.where(lo_inside[:, None], q, q[:, ::-1])
        t1 = qq[:, [0, 1, 2]]
        t2 = qq[:, [0, 2, 3]]
        tris = np.concatenate([t1, t2], axis=0)
        # drop degenerate triangles (shared vertices after clustering)
        ok = (
            (tris[:, 0] != tris[:, 1])
            & (tris[:, 1] != tris[:, 2])
            & (tris[:, 0] != tris[:, 2])
        )
        tris = tris[ok]

    return Mesh(
        vertices=vpos.astype(np.float32),
        triangles=tris.astype(np.int32),
    )
