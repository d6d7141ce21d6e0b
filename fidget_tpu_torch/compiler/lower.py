"""Graph -> register tape lowering.

Replaces the reference's two-stage SSA + reverse-LRU pipeline
(fidget-core/src/compiler/{ssa_tape,alloc,reg_tape}.rs) with a single
forward linear-scan allocator: nodes are visited children-first, each
value's register is freed at its last use (enabling in-place reuse), and
when the register file is full the least-recently-used live register is
spilled to a memory slot (LOAD/STORE ops are materialized inline).

The resulting tape evaluates identically; only the register numbering
strategy differs (the canonical bytecode repacks registers by frequency
anyway, mirroring fidget-core/src/compiler/reg_tape.rs:46-61).
"""

from __future__ import annotations

import numpy as np

from ..core import context as C
from ..core.context import Context
from ..core.ops import BinaryOp, UnaryOp
from ..core.var import VarMap
from ..utils import span
from .tape import IMM, BINARY_TAPE_OPS, CHOICE_TAPE_OPS, Tape, TapeOp

_UNARY_TO_TAPE = {
    UnaryOp.NEG: TapeOp.NEG,
    UnaryOp.ABS: TapeOp.ABS,
    UnaryOp.RECIP: TapeOp.RECIP,
    UnaryOp.SQRT: TapeOp.SQRT,
    UnaryOp.SQUARE: TapeOp.SQUARE,
    UnaryOp.FLOOR: TapeOp.FLOOR,
    UnaryOp.CEIL: TapeOp.CEIL,
    UnaryOp.ROUND: TapeOp.ROUND,
    UnaryOp.SIN: TapeOp.SIN,
    UnaryOp.COS: TapeOp.COS,
    UnaryOp.TAN: TapeOp.TAN,
    UnaryOp.ASIN: TapeOp.ASIN,
    UnaryOp.ACOS: TapeOp.ACOS,
    UnaryOp.ATAN: TapeOp.ATAN,
    UnaryOp.EXP: TapeOp.EXP,
    UnaryOp.LN: TapeOp.LN,
    UnaryOp.NOT: TapeOp.NOT,
}

_BINARY_TO_TAPE = {
    BinaryOp.ADD: TapeOp.ADD,
    BinaryOp.SUB: TapeOp.SUB,
    BinaryOp.MUL: TapeOp.MUL,
    BinaryOp.DIV: TapeOp.DIV,
    BinaryOp.ATAN2: TapeOp.ATAN2,
    BinaryOp.MIN: TapeOp.MIN,
    BinaryOp.MAX: TapeOp.MAX,
    BinaryOp.COMPARE: TapeOp.COMPARE,
    BinaryOp.MOD: TapeOp.MOD,
    BinaryOp.AND: TapeOp.AND,
    BinaryOp.OR: TapeOp.OR,
}


class _Alloc:
    """Forward linear-scan register allocator with LRU spilling."""

    def __init__(self, reg_limit: int, remaining_uses: dict[int, int]):
        # Binary reg/reg ops need two live operand registers, so 2 is
        # the hard floor; 255 is reserved as the immediate marker.
        if not 2 <= reg_limit <= 255:
            raise ValueError(f"reg_limit must be in [2, 255], got {reg_limit}")
        self.reg_limit = reg_limit
        self.remaining = remaining_uses  # node -> uses not yet consumed
        self.reg_of: dict[int, int] = {}  # node -> register
        self.slot_of: dict[int, int] = {}  # node -> memory slot
        self.reg_node: dict[int, int] = {}  # register -> node
        self.free_regs: list[int] = list(range(reg_limit - 1, -1, -1))
        self.free_slots: list[int] = []
        self.mem_count = 0
        self.stamp = 0
        self.last_touch: dict[int, int] = {}  # register -> recency stamp
        self.rows: list[tuple] = []
        self.reg_high = 0

    def _touch(self, r: int) -> None:
        self.stamp += 1
        self.last_touch[r] = self.stamp

    def _alloc_slot(self) -> int:
        if self.free_slots:
            return self.free_slots.pop()
        s = self.mem_count
        self.mem_count += 1
        return s

    def _grab_reg(self, forbid: set[int]) -> int:
        """Returns a free register, spilling the LRU live one if needed."""
        if self.free_regs:
            r = self.free_regs.pop()
            self.reg_high = max(self.reg_high, r + 1)
            return r
        # Spill: pick the least-recently-touched register not in `forbid`
        victim = min(
            (r for r in self.reg_node if r not in forbid),
            key=lambda r: self.last_touch.get(r, -1),
        )
        node = self.reg_node.pop(victim)
        del self.reg_of[node]
        slot = self.slot_of.get(node)
        if slot is None:
            slot = self._alloc_slot()
            self.slot_of[node] = slot
            self.rows.append((TapeOp.STORE, victim, 0, 0, 0.0, slot))
        return victim

    def ensure_reg(self, node: int, forbid: set[int]) -> int:
        """Makes sure `node`'s value is in a register; emits LOAD if spilled."""
        r = self.reg_of.get(node)
        if r is not None:
            self._touch(r)
            return r
        slot = self.slot_of[node]
        r = self._grab_reg(forbid)
        self.rows.append((TapeOp.LOAD, r, 0, 0, 0.0, slot))
        self.reg_of[node] = r
        self.reg_node[r] = node
        self._touch(r)
        return r

    def consume(self, node: int) -> None:
        """Records one use of `node`; frees its register/slot when dead."""
        self.remaining[node] -= 1
        if self.remaining[node] == 0:
            r = self.reg_of.pop(node, None)
            if r is not None:
                del self.reg_node[r]
                self.free_regs.append(r)
            s = self.slot_of.pop(node, None)
            if s is not None:
                self.free_slots.append(s)

    def define(self, node: int) -> int:
        """Allocates an output register for `node`.

        Called after all operand reads; evicting a live operand here is
        safe because eviction STOREs its value before the op overwrites
        the register.
        """
        r = self._grab_reg(set())
        self.reg_of[node] = r
        self.reg_node[r] = node
        self._touch(r)
        return r


@span("fidget.lower")
def lower(
    ctx: Context, roots: list[int], reg_limit: int = 255
) -> Tape:
    """Lowers graph nodes into a register `Tape` (forward eval order).

    >>> from fidget_tpu_torch import Context, lower
    >>> ctx = Context()
    >>> root = ctx.add(ctx.x(), ctx.constant(1.0))
    >>> tape = lower(ctx, [root])
    >>> (tape.output_count, tape.reg_count, len(tape.var_map))
    (1, 1, 1)
    """
    order = ctx.topological_order(roots)
    # Uses per node (constants are immediates and never materialized,
    # except when a root is itself a constant)
    uses: dict[int, int] = {n: 0 for n in order}
    for n in order:
        for c in ctx.children(n):
            uses[c] += 1
    for r in roots:
        uses[r] += 1  # the OUTPUT op consumes the root

    var_map = VarMap()
    # Deterministic var ordering: graph traversal order (first use wins
    # an index), like the reference's traversal-order VarMap. X/Y/Z get
    # no special placement; every consumer binds through VarMap indices.
    for n in order:
        v = ctx.var_of(n)
        if v is not None:
            var_map.insert(v)

    alloc = _Alloc(reg_limit, uses)
    choice_count = 0

    for n in order:
        tag = ctx.tag(n)
        if tag == C.CONST:
            continue  # immediates, unless a root (handled below)
        if uses[n] == 0:
            continue  # unused subexpression (can't happen from topo order)
        if tag == C.INPUT:
            r = alloc.define(n)
            alloc.rows.append(
                (TapeOp.INPUT, r, 0, 0, 0.0, var_map[ctx.var_of(n)])
            )
        elif tag == C.UNARY:
            op, a = ctx.payload(n)
            ra = alloc.ensure_reg(a, set())
            alloc.consume(a)
            ro = alloc.define(n)
            alloc.rows.append((_UNARY_TO_TAPE[op], ro, ra, 0, 0.0, 0))
        else:
            op, a, b = ctx.payload(n)
            ca, cb = ctx.get_const(a), ctx.get_const(b)
            top = _BINARY_TO_TAPE[op]
            if top in CHOICE_TAPE_OPS:
                choice_count += 1
            if ca is not None:
                rb = alloc.ensure_reg(b, set())
                alloc.consume(b)
                ro = alloc.define(n)
                alloc.rows.append((top, ro, IMM, rb, np.float32(ca), 0))
            elif cb is not None:
                ra = alloc.ensure_reg(a, set())
                alloc.consume(a)
                ro = alloc.define(n)
                alloc.rows.append((top, ro, ra, IMM, np.float32(cb), 0))
            else:
                ra = alloc.ensure_reg(a, set())
                rb = alloc.ensure_reg(b, {ra})
                alloc.consume(a)
                alloc.consume(b)
                ro = alloc.define(n)
                alloc.rows.append((top, ro, ra, rb, 0.0, 0))

    # OUTPUT ops for each root, in order
    for i, root in enumerate(roots):
        c = ctx.get_const(root)
        if c is not None:
            r = alloc.define(root)
            alloc.rows.append((TapeOp.COPY, r, IMM, 0, np.float32(c), 0))
            alloc.rows.append((TapeOp.OUTPUT, r, 0, 0, 0.0, i))
            alloc.consume(root)
        else:
            r = alloc.ensure_reg(root, set())
            alloc.rows.append((TapeOp.OUTPUT, r, 0, 0, 0.0, i))
            alloc.consume(root)

    return Tape.from_rows(
        alloc.rows,
        reg_count=alloc.reg_high,
        mem_count=alloc.mem_count,
        choice_count=choice_count,
        output_count=len(roots),
        var_map=var_map,
    )
