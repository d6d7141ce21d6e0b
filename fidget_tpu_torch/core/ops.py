"""Operation vocabulary for the expression layer and the canonical tape.

The graph-level opcodes mirror the reference's op set
(fidget-core/src/context/op.rs:10-45 — 17 unary + 11 binary operations),
and the tape-level opcodes mirror the canonical bytecode vocabulary
(fidget-bytecode/src/lib.rs:69-102) so that tapes produced here are
interoperable with any evaluator that understands fidget's packed format.
"""

from __future__ import annotations

import enum
import math


class UnaryOp(enum.IntEnum):
    """One-argument math operations (graph level)."""

    NEG = 0
    ABS = 1
    RECIP = 2
    SQRT = 3
    SQUARE = 4
    FLOOR = 5
    CEIL = 6
    ROUND = 7
    SIN = 8
    COS = 9
    TAN = 10
    ASIN = 11
    ACOS = 12
    ATAN = 13
    EXP = 14
    LN = 15
    NOT = 16


class BinaryOp(enum.IntEnum):
    """Two-argument math operations (graph level)."""

    ADD = 0
    SUB = 1
    MUL = 2
    DIV = 3
    ATAN2 = 4
    MIN = 5
    MAX = 6
    COMPARE = 7
    MOD = 8
    AND = 9
    OR = 10


#: Binary ops whose arguments may be canonically sorted (commutative).
COMMUTATIVE = frozenset({BinaryOp.ADD, BinaryOp.MUL, BinaryOp.MIN, BinaryOp.MAX})

#: Binary ops that record a 2-bit Choice during interval (tracing) evaluation.
CHOICE_OPS = frozenset({BinaryOp.MIN, BinaryOp.MAX, BinaryOp.AND, BinaryOp.OR})


def _compare(a: float, b: float) -> float:
    if math.isnan(a) or math.isnan(b):
        return math.nan
    if a < b:
        return -1.0
    if a > b:
        return 1.0
    return 0.0


def _rem_euclid(a: float, b: float) -> float:
    # Least non-negative remainder, matching Rust's f64::rem_euclid
    # (fidget-core/src/context/op.rs:61).
    if b == 0.0 or math.isnan(a) or math.isnan(b) or math.isinf(a):
        return math.nan
    r = math.fmod(a, b)
    if r < 0.0:
        r += abs(b)
    return r


def eval_unary(op: UnaryOp, a: float) -> float:
    """Reference float semantics for constant folding (f64 precision)."""
    try:
        if op == UnaryOp.NEG:
            return -a
        if op == UnaryOp.ABS:
            return abs(a)
        if op == UnaryOp.RECIP:
            return math.copysign(math.inf, a) if a == 0.0 else 1.0 / a
        if op == UnaryOp.SQRT:
            return math.sqrt(a) if a >= 0.0 else math.nan
        if op == UnaryOp.SQUARE:
            return a * a
        if op == UnaryOp.FLOOR:
            return math.floor(a) if math.isfinite(a) else a
        if op == UnaryOp.CEIL:
            return math.ceil(a) if math.isfinite(a) else a
        if op == UnaryOp.ROUND:
            # Round half away from zero (Rust f64::round), unlike Python's
            # banker's rounding.
            if not math.isfinite(a):
                return a
            return math.floor(a + 0.5) if a >= 0.0 else math.ceil(a - 0.5)
        if op == UnaryOp.SIN:
            return math.sin(a)
        if op == UnaryOp.COS:
            return math.cos(a)
        if op == UnaryOp.TAN:
            return math.tan(a)
        if op == UnaryOp.ASIN:
            return math.asin(a) if -1.0 <= a <= 1.0 else math.nan
        if op == UnaryOp.ACOS:
            return math.acos(a) if -1.0 <= a <= 1.0 else math.nan
        if op == UnaryOp.ATAN:
            return math.atan(a)
        if op == UnaryOp.EXP:
            try:
                return math.exp(a)
            except OverflowError:
                return math.inf
        if op == UnaryOp.LN:
            if a > 0.0:
                return math.log(a)
            return -math.inf if a == 0.0 else math.nan
        if op == UnaryOp.NOT:
            return 1.0 if a == 0.0 else 0.0
    except ValueError:
        return math.nan
    raise ValueError(f"unknown unary op {op!r}")


def eval_binary(op: BinaryOp, a: float, b: float) -> float:
    """Reference float semantics for constant folding (f64 precision)."""
    if op == BinaryOp.ADD:
        return a + b
    if op == BinaryOp.SUB:
        return a - b
    if op == BinaryOp.MUL:
        if (a == 0.0 and math.isinf(b)) or (b == 0.0 and math.isinf(a)):
            return math.nan
        return a * b
    if op == BinaryOp.DIV:
        if b == 0.0:
            if a == 0.0 or math.isnan(a):
                return math.nan
            return math.copysign(math.inf, a) * math.copysign(1.0, b)
        if math.isinf(a) and math.isinf(b):
            return math.nan
        return a / b
    if op == BinaryOp.ATAN2:
        return math.atan2(a, b)
    if op == BinaryOp.MIN:
        # Tape semantics (fidget-core/src/vm/mod.rs:765-807): strict
        # comparison picks a side; NaN inputs produce NaN.
        if math.isnan(a) or math.isnan(b):
            return math.nan
        return min(a, b)
    if op == BinaryOp.MAX:
        if math.isnan(a) or math.isnan(b):
            return math.nan
        return max(a, b)
    if op == BinaryOp.COMPARE:
        return _compare(a, b)
    if op == BinaryOp.MOD:
        return _rem_euclid(a, b)
    if op == BinaryOp.AND:
        # Short-circuiting AND: zero lhs selects itself, else rhs
        # (fidget-core/src/context/op.rs:63-69).
        return a if a == 0.0 else b
    if op == BinaryOp.OR:
        return a if a != 0.0 else b
    raise ValueError(f"unknown binary op {op!r}")


#: `.vm`-format opcode names (fidget-core/src/context/mod.rs:884-915).
UNARY_NAMES = {
    "neg": UnaryOp.NEG,
    "abs": UnaryOp.ABS,
    "recip": UnaryOp.RECIP,
    "sqrt": UnaryOp.SQRT,
    "square": UnaryOp.SQUARE,
    "floor": UnaryOp.FLOOR,
    "ceil": UnaryOp.CEIL,
    "round": UnaryOp.ROUND,
    "sin": UnaryOp.SIN,
    "cos": UnaryOp.COS,
    "tan": UnaryOp.TAN,
    "asin": UnaryOp.ASIN,
    "acos": UnaryOp.ACOS,
    "atan": UnaryOp.ATAN,
    "exp": UnaryOp.EXP,
    "ln": UnaryOp.LN,
    "not": UnaryOp.NOT,
}

BINARY_NAMES = {
    "add": BinaryOp.ADD,
    "sub": BinaryOp.SUB,
    "mul": BinaryOp.MUL,
    "div": BinaryOp.DIV,
    "atan2": BinaryOp.ATAN2,
    "min": BinaryOp.MIN,
    "max": BinaryOp.MAX,
    "compare": BinaryOp.COMPARE,
    "mod": BinaryOp.MOD,
    "and": BinaryOp.AND,
    "or": BinaryOp.OR,
}

UNARY_TO_NAME = {v: k for k, v in UNARY_NAMES.items()}
BINARY_TO_NAME = {v: k for k, v in BINARY_NAMES.items()}
