"""Block-union tape plans for the unrolled 2D leaf.

The counterpart of `fidget_tpu.compiler.unions`, plain numpy on the
host. A leaf that runs the whole tape on every active tile wastes most
of its arithmetic: a tape simplified for a tile's own choice trace is
several times shorter. A handful of programs recovers most of that:
the bitwise OR of the choice traces of every active tile in a spatial
block gives ONE tape that is exact for each of those tiles (Both is
always safe), and 256-px blocks at 1024^2 need 16 programs.

A `UnionPlan` is built once per (shape, camera neighbourhood): interval
evaluation of every cull tile with choice tracing, the traces OR-ed per
block, each union `simplify()`-ed into a program, and the packed union
words kept. Per frame the renderer (render/unrolled2d.py) re-captures
every tile's trace in the cull pass and routes an active tile to its
block's program only if its trace is a bitwise subset of the union
((tile | union) == union); the rest go to a full-tape fallback
worklist. A stale plan only moves tiles to the fallback.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..eval.arith import IntervalMode
from .simplify import simplify
from .tape import Tape


def pack_choices(choices: np.ndarray) -> np.ndarray:
    """[n_choice, T] uint8 codes -> [T, cw] uint32 packed words.

    Choice j lands in word j//16 at bit 2*(j%16) — the layout of the
    interval cull's captured words (eval/unrolled_fast.py,
    `unrolled_interval(epilogue="capture")`)."""
    n_choice, T = choices.shape
    cw = max(1, -(-n_choice // 16))
    words = np.zeros((T, cw), np.uint32)
    for j in range(n_choice):
        words[:, j // 16] |= choices[j].astype(np.uint32) << np.uint32(
            2 * (j % 16)
        )
    return words


@dataclass
class UnionPlan:
    """Static routing and programs of the union-tape unrolled leaf.

    programs: one simplified Tape per block that had active tiles.
    u_packed: [P, cw] uint32 packed union choice words per program.
    block_prog: [n0] int32 — program index per cull tile, -1 when the
      tile's block had no active tiles at plan time (such tiles route
      to the fallback worklist if they ever activate).
    caps: [P] per-program worklist capacities (slots, multiple of 32).
    act_counts: [P] active-tile counts at plan time (for stats).
    """

    T0: int
    block_tiles: int
    n0x: int
    n0y: int
    programs: list = field(default_factory=list)
    u_packed: np.ndarray = None
    block_prog: np.ndarray = None
    caps: np.ndarray = None
    act_counts: np.ndarray = None

    @property
    def total_ops(self) -> int:
        return sum(len(t) for t in self.programs)

    def stats(self) -> dict:
        w = self.act_counts.astype(np.float64)
        lens = np.array([len(t) for t in self.programs], np.float64)
        return {
            "programs": len(self.programs),
            "mean_len": float((lens * w).sum() / max(w.sum(), 1)),
            "total_ops": self.total_ops,
            "slots": int(self.caps.sum()),
            "active": int(w.sum()),
        }


def build_union_plan(
    tape: Tape,
    T0: int,
    n0x: int,
    n0y: int,
    mat: np.ndarray,
    z: float,
    var_vec: np.ndarray,
    axis_of: dict,
    *,
    block_px: int = 256,
    headroom: float = 1.08,
    headroom_slots: int = 8,
) -> UnionPlan:
    """Builds a UnionPlan by host interval evaluation at one camera
    (numpy `IntervalMode` + `eval_tape` with choice tracing over all
    n0x * n0y cull-tile boxes); block_px is the spatial block edge in
    pixels (block_px // T0 cull tiles per block edge)."""
    from ..eval.unrolled import eval_tape
    from ..render.transform import transform_intervals

    k = max(1, block_px // T0)
    n0 = n0x * n0y
    tx = np.arange(n0x, dtype=np.float32) * T0
    ty = np.arange(n0y, dtype=np.float32) * T0
    gx, gy = np.meshgrid(tx, ty)
    x0 = gx.reshape(-1)
    y0 = gy.reshape(-1)
    im = IntervalMode(np)
    zz = np.full_like(x0, np.float32(z))
    with np.errstate(all="ignore"):
        mxi, myi, mzi = transform_intervals(
            im, mat.astype(np.float32), (x0, x0 + T0), (y0, y0 + T0),
            (zz, zz),
        )
    V = max(1, len(tape.var_map))
    inputs = []
    for i in range(V):
        c = np.broadcast_to(np.float32(var_vec[i]), x0.shape)
        inputs.append((c, c))
    for kind, ivl in (("x", mxi), ("y", myi), ("z", mzi)):
        idx = axis_of.get(kind)
        if idx is not None:
            inputs[idx] = (
                np.broadcast_to(ivl[0], x0.shape).astype(np.float32),
                np.broadcast_to(ivl[1], x0.shape).astype(np.float32),
            )
    with np.errstate(all="ignore"):
        (outs, choices) = eval_tape(tape, im, inputs, trace=True)
    lo, hi = outs[0]
    active = ~((hi < 0.0) | (lo > 0.0))
    ch = (
        np.stack(choices)
        if choices
        else np.zeros((0, n0), np.uint8)
    )  # [n_choice, n0]

    # block id per tile (row-major tile grid, ceil block grid)
    bx = (np.arange(n0) % n0x) // k
    by = (np.arange(n0) // n0x) // k
    nbx = -(-n0x // k)
    block_id = (by * nbx + bx).astype(np.int64)

    # per-block union of ACTIVE tiles' choices
    n_blocks = int(block_id.max()) + 1 if n0 else 0
    programs: list[Tape] = []
    u_rows = []
    block_prog = np.full(n0, -1, np.int32)
    caps = []
    act_counts = []
    cw = max(1, -(-tape.choice_count // 16))
    for bid in range(n_blocks):
        in_block = block_id == bid
        sel = in_block & active
        cnt = int(sel.sum())
        if cnt == 0:
            continue
        u = np.bitwise_or.reduce(ch[:, sel], axis=1)
        p = len(programs)
        programs.append(simplify(tape, u))
        u_rows.append(pack_choices(u[:, None])[0])
        block_prog[in_block] = p
        # capacity: headroom over the plan-time active count, but never
        # more than the block's own tile count (both rounded to 32:
        # slot padding multiplies straight into leaf arithmetic)
        caps.append(
            min(
                -(-int(cnt * headroom + headroom_slots) // 32) * 32,
                -(-int(in_block.sum()) // 32) * 32,
            )
        )
        act_counts.append(cnt)
    u_packed = (
        np.stack(u_rows) if u_rows else np.zeros((0, cw), np.uint32)
    )
    return UnionPlan(
        T0=T0,
        block_tiles=k,
        n0x=n0x,
        n0y=n0y,
        programs=programs,
        u_packed=u_packed,
        block_prog=block_prog,
        caps=np.asarray(caps, np.int64),
        act_counts=np.asarray(act_counts, np.int64),
    )
