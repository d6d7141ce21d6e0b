"""Deduplicating expression arena.

The `Context` is the L0 expression layer: a hash-consing arena of math
operations with constant folding, identity simplification, a `.vm`
flat-text parser/exporter, symbolic differentiation, and GraphViz export.

Behavioral parity notes (so downstream tape lengths match the reference):
- constant folding in op construction (fidget-core/src/context/mod.rs:188-213)
- commutative argument sorting (context/mod.rs:217-224)
- identity rules: add x+x -> 2x and +-0 elision (context/mod.rs:241-250),
  mul x*x -> square and *1/*0 (context/mod.rs:268-278), sub/div rules,
  min/max(a,a) -> a, and/or constant short circuits (context/mod.rs:330-400)
- symbolic derivatives including subgradient composites for
  abs/min/max/and/or via compare + short-circuit ops
  (context/mod.rs:1252-1464)
"""

from __future__ import annotations

import math
from typing import Iterable, TextIO

from .ops import (
    BINARY_NAMES,
    BINARY_TO_NAME,
    COMMUTATIVE,
    UNARY_NAMES,
    UNARY_TO_NAME,
    BinaryOp,
    UnaryOp,
    eval_binary,
    eval_unary,
)
from .var import Var

# Node payload tags
CONST = 0
INPUT = 1
UNARY = 2
BINARY = 3


def _const_key(value: float):
    # NaN constants must deduplicate against each other (OrderedFloat
    # semantics); +0.0 and -0.0 hash/compare equal in Python which matches
    # OrderedFloat's `==`-based equality.
    if math.isnan(value):
        return (CONST, "nan")
    return (CONST, value)


class ParseError(ValueError):
    pass


class Context:
    """Hash-consing arena of expression nodes.

    Node handles are plain integers indexing into the arena. Handles are
    only meaningful for the context that created them.

    Build a unit circle's signed distance and evaluate it at the
    origin through the lowered tape (the reference's doc example,
    fidget-core/src/context/mod.rs:227-233):

    >>> import numpy as np
    >>> from fidget_tpu_torch import Context, lower
    >>> from fidget_tpu_torch.eval.arith import FloatMode
    >>> from fidget_tpu_torch.eval.unrolled import eval_tape
    >>> ctx = Context()
    >>> r = ctx.sqrt(ctx.add(ctx.square(ctx.x()), ctx.square(ctx.y())))
    >>> circle = ctx.sub(r, ctx.constant(1.0))
    >>> tape = lower(ctx, [circle])
    >>> (out,), _ = eval_tape(
    ...     tape, FloatMode(np),
    ...     [np.float32(0.0), np.float32(0.0)],  # x, y
    ... )
    >>> float(out)
    -1.0

    Identical subtrees deduplicate and constants fold at build time:

    >>> ctx.add(ctx.x(), ctx.x()) == ctx.add(ctx.x(), ctx.x())
    True
    >>> ctx.get_const(ctx.mul(ctx.constant(2.0), ctx.constant(3.0)))
    6.0
    """

    def __init__(self) -> None:
        # Parallel arrays describing each node
        self._tag: list[int] = []
        self._payload: list[tuple] = []
        self._dedup: dict[tuple, int] = {}

    def __len__(self) -> int:
        return len(self._tag)

    # ------------------------------------------------------------------
    # Raw node accessors

    def tag(self, n: int) -> int:
        return self._tag[n]

    def payload(self, n: int) -> tuple:
        return self._payload[n]

    def get_const(self, n: int) -> float | None:
        """Returns the constant value of `n`, or None if not a constant."""
        if self._tag[n] == CONST:
            return self._payload[n][0]
        return None

    def var_of(self, n: int) -> Var | None:
        if self._tag[n] == INPUT:
            return self._payload[n][0]
        return None

    def children(self, n: int) -> tuple[int, ...]:
        t = self._tag[n]
        if t == UNARY:
            return (self._payload[n][1],)
        if t == BINARY:
            return (self._payload[n][1], self._payload[n][2])
        return ()

    # ------------------------------------------------------------------
    # Node construction

    def _intern(self, tag: int, key: tuple, payload: tuple) -> int:
        n = self._dedup.get(key)
        if n is not None:
            return n
        n = len(self._tag)
        self._tag.append(tag)
        self._payload.append(payload)
        self._dedup[key] = n
        return n

    def constant(self, value: float) -> int:
        value = float(value)
        return self._intern(CONST, _const_key(value), (value,))

    def input(self, v: Var) -> int:
        return self._intern(INPUT, (INPUT, v), (v,))

    def x(self) -> int:
        return self.input(Var.X)

    def y(self) -> int:
        return self.input(Var.Y)

    def z(self) -> int:
        return self.input(Var.Z)

    def _coerce(self, a) -> int:
        if isinstance(a, (int,)):
            return a
        if isinstance(a, float):
            return self.constant(a)
        raise TypeError(f"cannot coerce {a!r} to a node")

    def op_unary(self, op: UnaryOp, a) -> int:
        a = self._coerce(a)
        ca = self.get_const(a)
        if ca is not None:
            return self.constant(eval_unary(op, ca))
        return self._intern(UNARY, (UNARY, op, a), (op, a))

    def op_binary(self, op: BinaryOp, a, b) -> int:
        a = self._coerce(a)
        b = self._coerce(b)
        ca, cb = self.get_const(a), self.get_const(b)
        if ca is not None and cb is not None:
            return self.constant(eval_binary(op, ca, cb))
        if op in COMMUTATIVE and b < a:
            a, b = b, a
        return self._intern(BINARY, (BINARY, op, a, b), (op, a, b))

    # -- builders with identity simplification -------------------------

    def add(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        if a == b:
            return self.mul(a, self.constant(2.0))
        if self.get_const(a) == 0.0:
            return b
        if self.get_const(b) == 0.0:
            return a
        return self.op_binary(BinaryOp.ADD, a, b)

    def sub(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        if self.get_const(a) == 0.0:
            return self.neg(b)
        if self.get_const(b) == 0.0:
            return a
        return self.op_binary(BinaryOp.SUB, a, b)

    def mul(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        if a == b:
            return self.square(a)
        ca, cb = self.get_const(a), self.get_const(b)
        if ca == 1.0:
            return b
        if cb == 1.0:
            return a
        if ca == 0.0:
            return a
        if cb == 0.0:
            return b
        return self.op_binary(BinaryOp.MUL, a, b)

    def div(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        if self.get_const(a) == 0.0:
            return a
        if self.get_const(b) == 1.0:
            return a
        return self.op_binary(BinaryOp.DIV, a, b)

    def min(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        if a == b:
            return a
        return self.op_binary(BinaryOp.MIN, a, b)

    def max(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        if a == b:
            return a
        return self.op_binary(BinaryOp.MAX, a, b)

    def and_(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        ca = self.get_const(a)
        if ca is not None:
            return a if ca == 0.0 else b
        return self.op_binary(BinaryOp.AND, a, b)

    def or_(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        ca = self.get_const(a)
        if ca is not None:
            return a if ca != 0.0 else b
        cb = self.get_const(b)
        if cb == 0.0:
            return a
        return self.op_binary(BinaryOp.OR, a, b)

    def atan2(self, y, x) -> int:
        return self.op_binary(BinaryOp.ATAN2, y, x)

    def compare(self, a, b) -> int:
        return self.op_binary(BinaryOp.COMPARE, a, b)

    def modulo(self, a, b) -> int:
        return self.op_binary(BinaryOp.MOD, a, b)

    def neg(self, a) -> int:
        return self.op_unary(UnaryOp.NEG, a)

    def abs(self, a) -> int:
        return self.op_unary(UnaryOp.ABS, a)

    def recip(self, a) -> int:
        return self.op_unary(UnaryOp.RECIP, a)

    def sqrt(self, a) -> int:
        return self.op_unary(UnaryOp.SQRT, a)

    def square(self, a) -> int:
        return self.op_unary(UnaryOp.SQUARE, a)

    def floor(self, a) -> int:
        return self.op_unary(UnaryOp.FLOOR, a)

    def ceil(self, a) -> int:
        return self.op_unary(UnaryOp.CEIL, a)

    def round(self, a) -> int:
        return self.op_unary(UnaryOp.ROUND, a)

    def sin(self, a) -> int:
        return self.op_unary(UnaryOp.SIN, a)

    def cos(self, a) -> int:
        return self.op_unary(UnaryOp.COS, a)

    def tan(self, a) -> int:
        return self.op_unary(UnaryOp.TAN, a)

    def asin(self, a) -> int:
        return self.op_unary(UnaryOp.ASIN, a)

    def acos(self, a) -> int:
        return self.op_unary(UnaryOp.ACOS, a)

    def atan(self, a) -> int:
        return self.op_unary(UnaryOp.ATAN, a)

    def exp(self, a) -> int:
        return self.op_unary(UnaryOp.EXP, a)

    def ln(self, a) -> int:
        return self.op_unary(UnaryOp.LN, a)

    def not_(self, a) -> int:
        return self.op_unary(UnaryOp.NOT, a)

    # -- logical composites --------------------------------------------

    def less_than(self, a, b) -> int:
        """1 if a < b else 0 (NaN-propagating via Compare)."""
        a, b = self._coerce(a), self._coerce(b)
        cmp = self.op_binary(BinaryOp.COMPARE, b, a)
        return self.max(cmp, self.constant(0.0))

    def less_than_or_equal(self, a, b) -> int:
        a, b = self._coerce(a), self._coerce(b)
        cmp = self.op_binary(BinaryOp.COMPARE, b, a)
        shift = self.add(cmp, self.constant(1.0))
        return self.min(shift, self.constant(1.0))

    def if_nonzero_else(self, cond, a, b) -> int:
        """Selects `a` when `cond != 0`, else `b` (short-circuit style)."""
        cond, a, b = self._coerce(cond), self._coerce(a), self._coerce(b)
        lhs = self.and_(cond, a)
        ncond = self.not_(cond)
        rhs = self.and_(ncond, b)
        return self.or_(lhs, rhs)

    # ------------------------------------------------------------------
    # Evaluation (host-side, f64): ground truth for tests

    def eval(self, n: int, values: dict[Var, float]) -> float:
        """Evaluates node `n` given variable bindings (f64 semantics)."""
        cache: dict[int, float] = {}
        stack = [n]
        while stack:
            m = stack[-1]
            if m in cache:
                stack.pop()
                continue
            t = self._tag[m]
            if t == CONST:
                cache[m] = self._payload[m][0]
                stack.pop()
            elif t == INPUT:
                v = self._payload[m][0]
                if v not in values:
                    raise KeyError(f"missing binding for {v!r}")
                cache[m] = values[v]
                stack.pop()
            elif t == UNARY:
                op, a = self._payload[m]
                if a in cache:
                    cache[m] = eval_unary(op, cache[a])
                    stack.pop()
                else:
                    stack.append(a)
            else:
                op, a, b = self._payload[m]
                if a in cache and b in cache:
                    cache[m] = eval_binary(op, cache[a], cache[b])
                    stack.pop()
                else:
                    if a not in cache:
                        stack.append(a)
                    if b not in cache:
                        stack.append(b)
        return cache[n]

    def eval_xyz(self, n: int, x: float, y: float, z: float) -> float:
        return self.eval(n, {Var.X: x, Var.Y: y, Var.Z: z})

    # ------------------------------------------------------------------
    # Symbolic differentiation

    def deriv(self, n: int, v: Var) -> int:
        """Builds the symbolic derivative d(n)/d(v) as a new node.

        Discontinuous functions use subgradient composites built from
        compare/and/or/not ops, matching the reference's rules
        (context/mod.rs:1252-1464): abs picks ±1 by sign, min/max pick the
        strictly-smaller/greater side, floor/ceil/round/compare/not have
        zero derivative, and mod reconstructs the euclidean quotient.

        >>> from fidget_tpu_torch import Context, Var
        >>> ctx = Context()
        >>> ctx.get_const(ctx.deriv(ctx.constant(3.0), Var.X))
        0.0
        >>> d = ctx.deriv(ctx.square(ctx.x()), Var.X)  # 2*x
        >>> "mul" in ctx.export(d)
        True
        """
        zero = self.constant(0.0)
        memo: dict[int, int] = {}

        order = self.topological_order([n])
        for m in order:
            t = self._tag[m]
            if t == CONST:
                memo[m] = zero
            elif t == INPUT:
                memo[m] = self.constant(1.0) if self._payload[m][0] == v else zero
            elif t == UNARY:
                op, a = self._payload[m]
                da = memo[a]
                memo[m] = self._deriv_unary(op, m, a, da, zero)
            else:
                op, a, b = self._payload[m]
                memo[m] = self._deriv_binary(op, m, a, b, memo[a], memo[b], zero)
        return memo[n]

    def _deriv_unary(self, op: UnaryOp, n: int, a: int, da: int, zero: int) -> int:
        U = UnaryOp
        if op == U.NEG:
            return self.neg(da)
        if op == U.ABS:
            cond = self.less_than(a, zero)
            return self.if_nonzero_else(cond, self.neg(da), da)
        if op == U.RECIP:
            return self.div(self.neg(da), self.square(a))
        if op == U.SQRT:
            return self.div(da, self.mul(n, self.constant(2.0)))
        if op == U.SQUARE:
            return self.mul(self.constant(2.0), self.mul(da, a))
        if op in (U.FLOOR, U.CEIL, U.ROUND, U.NOT):
            return zero
        if op == U.SIN:
            return self.mul(self.cos(a), da)
        if op == U.COS:
            return self.mul(self.neg(self.sin(a)), da)
        if op == U.TAN:
            return self.div(da, self.square(self.cos(a)))
        if op == U.ASIN:
            r = self.sqrt(self.sub(self.constant(1.0), self.square(a)))
            return self.div(da, r)
        if op == U.ACOS:
            r = self.sqrt(self.sub(self.constant(1.0), self.square(a)))
            return self.div(da, self.neg(r))
        if op == U.ATAN:
            return self.div(da, self.add(self.constant(1.0), self.square(a)))
        if op == U.EXP:
            return self.mul(n, da)
        if op == U.LN:
            return self.div(da, a)
        raise ValueError(f"unknown unary op {op!r}")

    def _deriv_binary(
        self, op: BinaryOp, n: int, a: int, b: int, da: int, db: int, zero: int
    ) -> int:
        B = BinaryOp
        if op == B.ADD:
            return self.add(da, db)
        if op == B.SUB:
            return self.sub(da, db)
        if op == B.MUL:
            return self.add(self.mul(da, b), self.mul(a, db))
        if op == B.DIV:
            num = self.sub(self.mul(b, da), self.mul(a, db))
            return self.div(num, self.square(b))
        if op == B.ATAN2:
            d = self.add(self.square(a), self.square(b))
            num = self.sub(self.mul(b, da), self.mul(a, db))
            return self.div(num, d)
        if op == B.MIN:
            cond = self.less_than(a, b)
            return self.if_nonzero_else(cond, da, db)
        if op == B.MAX:
            cond = self.less_than(b, a)
            return self.if_nonzero_else(cond, da, db)
        if op == B.COMPARE:
            return zero
        if op == B.MOD:
            # d/dv rem_euclid(a, b) = da - db * div_euclid(a, b). The
            # euclidean quotient follows exactly from the remainder:
            # div_euclid(a, b) = (a - rem_euclid(a, b)) / b — no
            # branching on signs (a floor(a/b) reconstruction used here
            # before was off by ±1 for negative quotients / b < 0).
            q = self.div(self.sub(a, self.modulo(a, b)), b)
            return self.sub(da, self.mul(db, q))
        if op == B.AND:
            cond = self.compare(a, zero)
            return self.if_nonzero_else(cond, db, da)
        if op == B.OR:
            cond = self.compare(a, zero)
            return self.if_nonzero_else(cond, da, db)
        raise ValueError(f"unknown binary op {op!r}")

    # ------------------------------------------------------------------
    # Traversal helpers

    def topological_order(self, roots: Iterable[int]) -> list[int]:
        """Returns reachable nodes, children before parents."""
        seen: set[int] = set()
        order: list[int] = []
        stack: list[tuple[int, bool]] = [(r, False) for r in roots]
        while stack:
            m, processed = stack.pop()
            if processed:
                order.append(m)
                continue
            if m in seen:
                continue
            seen.add(m)
            stack.append((m, True))
            for c in self.children(m):
                if c not in seen:
                    stack.append((c, False))
        return order

    # ------------------------------------------------------------------
    # `.vm` flat-text model format (fidget-core/src/context/mod.rs:861-922)

    @staticmethod
    def from_text(text: str | TextIO) -> tuple["Context", int]:
        """Parses the `.vm` flat-text format.

        Each line is `name opcode [args...]`; `#` starts a comment. The
        last node defined is the root
        (grammar: fidget-core/src/context/mod.rs:861-922).

        >>> ctx, root = Context.from_text(
        ...     "a var-x\\nb const 2.0\\nc mul a b"
        ... )
        >>> print(ctx.export(root))  # doctest: +NORMALIZE_WHITESPACE
        n1 const 2.0
        n0 var-x
        n2 mul n0 n1
        """
        if not isinstance(text, str):
            text = text.read()
        ctx = Context()
        seen: dict[str, int] = {}
        last: int | None = None
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            name, opcode, args = parts[0], parts[1], parts[2:]

            def ref(tok: str) -> int:
                try:
                    return seen[tok]
                except KeyError:
                    raise ParseError(f"unknown variable {tok!r}") from None

            if opcode == "const":
                node = ctx.constant(float(args[0]))
            elif opcode == "var-x":
                node = ctx.x()
            elif opcode == "var-y":
                node = ctx.y()
            elif opcode == "var-z":
                node = ctx.z()
            elif opcode in UNARY_NAMES:
                node = ctx.op_unary(UNARY_NAMES[opcode], ref(args[0]))
            elif opcode in BINARY_NAMES:
                op = BINARY_NAMES[opcode]
                if op == BinaryOp.AND:
                    node = ctx.and_(ref(args[0]), ref(args[1]))
                elif op == BinaryOp.OR:
                    node = ctx.or_(ref(args[0]), ref(args[1]))
                else:
                    builder = {
                        BinaryOp.ADD: ctx.add,
                        BinaryOp.SUB: ctx.sub,
                        BinaryOp.MUL: ctx.mul,
                        BinaryOp.DIV: ctx.div,
                        BinaryOp.MIN: ctx.min,
                        BinaryOp.MAX: ctx.max,
                        BinaryOp.ATAN2: ctx.atan2,
                        BinaryOp.COMPARE: ctx.compare,
                        BinaryOp.MOD: ctx.modulo,
                    }[op]
                    node = builder(ref(args[0]), ref(args[1]))
            else:
                raise ParseError(f"unknown opcode {opcode!r}")
            seen[name] = node
            last = node
        if last is None:
            raise ParseError("empty file")
        return ctx, last

    def export(self, n: int) -> str:
        """Exports the subtree rooted at `n` in `.vm` text format."""
        lines = []
        for m in self.topological_order([n]):
            t = self._tag[m]
            if t == CONST:
                lines.append(f"n{m} const {self._payload[m][0]!r}")
            elif t == INPUT:
                v = self._payload[m][0]
                if v.kind not in ("x", "y", "z"):
                    raise ValueError("cannot export custom vars to .vm")
                lines.append(f"n{m} var-{v.kind}")
            elif t == UNARY:
                op, a = self._payload[m]
                lines.append(f"n{m} {UNARY_TO_NAME[op]} n{a}")
            else:
                op, a, b = self._payload[m]
                lines.append(f"n{m} {BINARY_TO_NAME[op]} n{a} n{b}")
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------------
    # GraphViz export

    def dot(self, roots: Iterable[int] | None = None) -> str:
        """Renders the context (or a subtree) as a GraphViz digraph."""
        nodes = (
            self.topological_order(roots)
            if roots is not None
            else range(len(self._tag))
        )
        out = ["digraph mygraph {"]
        for m in nodes:
            t = self._tag[m]
            if t == CONST:
                label, color = f"{self._payload[m][0]:g}", "green"
            elif t == INPUT:
                label, color = repr(self._payload[m][0]), "red"
            elif t == UNARY:
                label, color = UNARY_TO_NAME[self._payload[m][0]], "dodgerblue"
            else:
                op = self._payload[m][0]
                label = BINARY_TO_NAME[op]
                color = "goldenrod" if op in (BinaryOp.MIN, BinaryOp.MAX) else "dodgerblue"
            out.append(f'  n{m} [label="{label}", color="{color}"];')
            for c in self.children(m):
                out.append(f"  n{m} -> n{c};")
        out.append("}")
        return "\n".join(out) + "\n"
