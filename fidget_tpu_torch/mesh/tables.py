"""Manifold Dual Contouring cell tables.

A from-scratch construction of the 256-entry MDC tables that the
reference generates at build time (fidget-mesh/build.rs:26-234,
"CELL_TO_VERT_TO_EDGES" / "CELL_TO_EDGE_TO_VERT", after Nielson's DMC
Fig. 5): for each 8-bit corner occupancy mask, the cell's crossing
edges are grouped into one vertex per connected component of *inside*
corners (corners adjacent along cell edges), which is exactly the
corner-region clustering the reference uses.

Conventions (ours, not the reference's — the meshes are equivalent):
- corner i sits at offset ((i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1)
- the 12 cell edges are indexed by (axis, v) where axis in {0, 1, 2}
  and v in 0..4 encodes the two fixed coordinates in bit order of the
  remaining axes: edge_index = axis * 4 + v
- a crossing edge is stored *directed* (inside corner, outside corner),
  matching the reference's sign convention (start < 0, end >= 0,
  fidget-mesh/src/octree.rs:687-700)
"""

from __future__ import annotations

import numpy as np

#: (axis, lo_corner, hi_corner) for each of the 12 edges
EDGES: list[tuple[int, int, int]] = []
for axis in range(3):
    a1, a2 = (axis + 1) % 3, (axis + 2) % 3
    # order the two fixed axes by index so edge numbering is canonical
    lo_ax, hi_ax = min(a1, a2), max(a1, a2)
    for v in range(4):
        c = ((v & 1) << lo_ax) | (((v >> 1) & 1) << hi_ax)
        EDGES.append((axis, c, c | (1 << axis)))

#: per corner-mask: list of vertices, each a list of *directed* crossing
#: edges (inside_corner, outside_corner, edge_index)
CELL_TO_VERT_TO_EDGES: list[list[list[tuple[int, int, int]]]] = []
#: per corner-mask: edge_index -> vertex index (or -1 if not crossing)
CELL_TO_EDGE_TO_VERT = np.full((256, 12), -1, np.int32)


def _build() -> None:
    adj = [[] for _ in range(8)]
    for a in range(3):
        for c in range(8):
            adj[c].append(c ^ (1 << a))
    for mask in range(256):
        inside = [c for c in range(8) if mask & (1 << c)]
        # connected components of inside corners
        comp = {}
        for c in inside:
            if c in comp:
                continue
            stack = [c]
            comp[c] = c
            while stack:
                u = stack.pop()
                for w in adj[u]:
                    if (mask >> w) & 1 and w not in comp:
                        comp[w] = c
                        stack.append(w)
        roots: list[int] = []
        verts: list[list[tuple[int, int, int]]] = []
        for e_idx, (_axis, lo, hi) in enumerate(EDGES):
            in_lo = (mask >> lo) & 1
            in_hi = (mask >> hi) & 1
            if in_lo == in_hi:
                continue
            ic, oc = (lo, hi) if in_lo else (hi, lo)
            r = comp[ic]
            if r not in roots:
                roots.append(r)
                verts.append([])
            vi = roots.index(r)
            verts[vi].append((ic, oc, e_idx))
            CELL_TO_EDGE_TO_VERT[mask, e_idx] = vi
        CELL_TO_VERT_TO_EDGES.append(verts)


_build()

#: max vertices any mask produces (4, e.g. mask 0b01101001)
MAX_VERTS = max(len(v) for v in CELL_TO_VERT_TO_EDGES)

#: dense [256] vertex counts
VERT_COUNT = np.array(
    [len(v) for v in CELL_TO_VERT_TO_EDGES], np.int32
)

#: for each of the 12 edges: its direction axis and the in-cell corner
EDGE_AXIS = np.array([e[0] for e in EDGES], np.int32)
EDGE_LO = np.array([e[1] for e in EDGES], np.int32)
EDGE_HI = np.array([e[2] for e in EDGES], np.int32)
