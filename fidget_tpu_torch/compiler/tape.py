"""Register-allocated straight-line tapes.

A `Tape` is the unit of evaluation: a list of operations over a bounded
register file (<= 255 registers, register 255 reserved as the immediate
marker) plus unlimited spill ("memory") slots, stored in **forward
evaluation order** as structure-of-arrays — the layout consumed directly
by the interpreter kernels and packable into fidget's canonical
bytecode format (fidget-bytecode/src/lib.rs:10-42).

Internal opcode numbering is frequency-ordered for interpreter dispatch
(see `TapeOp`); the canonical `BytecodeOp` wire numbering
(fidget-bytecode/src/lib.rs:69-102) is restored by `compiler/bytecode`.
LOAD/STORE are split out of `Mem` internally (32/33) and re-merged when
packing.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..core.var import Var, VarMap

#: Register value marking "the operand is an immediate" (canonical 0xFF).
IMM = 0xFF


class TapeOp(enum.IntEnum):
    """Internal opcode numbering, ordered by evaluation frequency.

    The numbering is the reference package's, so packed words match
    it bit for bit; hot SDF ops (min/max/add/sub) sit first. This order
    is internal only — the canonical bytecode interchange format keeps the
    reference's opcode numbering via the mapping in
    `compiler/bytecode.py` (fidget-bytecode/src/lib.rs:69-102).
    """

    OUTPUT = 0
    INPUT = 1
    COPY = 2
    MAX = 3
    SUB = 4
    ADD = 5
    MIN = 6
    NEG = 7
    SQUARE = 8
    SQRT = 9
    MUL = 10
    DIV = 11
    ABS = 12
    EXP = 13
    LN = 14
    RECIP = 15
    FLOOR = 16
    CEIL = 17
    ROUND = 18
    NOT = 19
    AND = 20
    OR = 21
    MOD = 22
    COMPARE = 23
    ATAN2 = 24
    SIN = 25
    COS = 26
    TAN = 27
    ASIN = 28
    ACOS = 29
    ATAN = 30
    MEM = 31  # canonical packed form only
    LOAD = 32  # internal: register <- memory slot
    STORE = 33  # internal: memory slot <- register


#: Unary tape ops (out <- f(a)).
UNARY_TAPE_OPS = frozenset(
    {
        TapeOp.NEG,
        TapeOp.ABS,
        TapeOp.RECIP,
        TapeOp.SQRT,
        TapeOp.SQUARE,
        TapeOp.FLOOR,
        TapeOp.CEIL,
        TapeOp.ROUND,
        TapeOp.NOT,
        TapeOp.SIN,
        TapeOp.COS,
        TapeOp.TAN,
        TapeOp.ASIN,
        TapeOp.ACOS,
        TapeOp.ATAN,
        TapeOp.EXP,
        TapeOp.LN,
    }
)

#: Binary tape ops (out <- f(a, b); a or b may be IMM).
BINARY_TAPE_OPS = frozenset(
    {
        TapeOp.ADD,
        TapeOp.SUB,
        TapeOp.MUL,
        TapeOp.DIV,
        TapeOp.ATAN2,
        TapeOp.COMPARE,
        TapeOp.MOD,
        TapeOp.MIN,
        TapeOp.MAX,
        TapeOp.AND,
        TapeOp.OR,
    }
)

#: Tape ops that record a 2-bit Choice in interval (tracing) evaluation.
CHOICE_TAPE_OPS = frozenset({TapeOp.MIN, TapeOp.MAX, TapeOp.AND, TapeOp.OR})

#: Bitmask constants for branch-free opcode classification in kernels:
#: bit op is set if op belongs to the class (all ops fit in 31 bits).
CHOICE_MASK = 0
for _op in CHOICE_TAPE_OPS:
    CHOICE_MASK |= 1 << int(_op)
BINARY_MASK = 0
for _op in BINARY_TAPE_OPS:
    BINARY_MASK |= 1 << int(_op)
UNARY_MASK = 0
for _op in UNARY_TAPE_OPS:
    UNARY_MASK |= 1 << int(_op)

# 2-bit choice codes (fidget-core/src/vm/choice.rs:15-29)
CHOICE_NONE = 0
CHOICE_LEFT = 1
CHOICE_RIGHT = 2
CHOICE_BOTH = 3


@dataclass
class Tape:
    """A register tape in forward evaluation order (SoA layout).

    Fields `op/out/a/b` are int32 arrays of equal length; `imm` carries
    f32 immediates; `aux` carries integer payloads (input index for
    INPUT, output index for OUTPUT, memory slot for LOAD/STORE).
    """

    op: np.ndarray
    out: np.ndarray
    a: np.ndarray
    b: np.ndarray
    imm: np.ndarray
    aux: np.ndarray
    reg_count: int
    mem_count: int
    choice_count: int
    output_count: int
    var_map: VarMap = field(default_factory=VarMap)

    def __len__(self) -> int:
        return int(self.op.shape[0])

    @staticmethod
    def from_rows(rows: list[tuple], reg_count: int, mem_count: int,
                  choice_count: int, output_count: int, var_map: VarMap) -> "Tape":
        """Builds a Tape from (op, out, a, b, imm, aux) tuples."""
        n = len(rows)
        op = np.zeros(n, dtype=np.int32)
        out = np.zeros(n, dtype=np.int32)
        a = np.zeros(n, dtype=np.int32)
        b = np.zeros(n, dtype=np.int32)
        imm = np.zeros(n, dtype=np.float32)
        aux = np.zeros(n, dtype=np.int32)
        for i, r in enumerate(rows):
            op[i], out[i], a[i], b[i], imm[i], aux[i] = r
        return Tape(op, out, a, b, imm, aux, reg_count, mem_count,
                    choice_count, output_count, var_map)

    @staticmethod
    def from_arrays(op, out, a, b, imm, aux, reg_count: int, mem_count: int,
                    choice_count: int, output_count: int,
                    var_kinds) -> "Tape":
        """Builds a Tape from structure-of-arrays fields, e.g. those of a
        `fidget_tpu.compiler.tape.Tape` handed over as numpy arrays.

        `var_kinds` lists the tape's inputs in index order: "x"/"y"/"z"
        for the axes, or a `Var` for a custom variable.

        >>> import numpy as np
        >>> t = Tape.from_arrays(
        ...     op=[int(TapeOp.INPUT), int(TapeOp.OUTPUT)], out=[0, 0],
        ...     a=[0, 0], b=[0, 0], imm=[0.0, 0.0], aux=[0, 0],
        ...     reg_count=1, mem_count=0, choice_count=0, output_count=1,
        ...     var_kinds=["x"])
        >>> t.pretty()
        'r0 = INPUT[0]\\nOUTPUT[0] = r0'
        """
        var_map = VarMap()
        axes = {"x": Var.X, "y": Var.Y, "z": Var.Z}
        for k in var_kinds:
            var_map.insert(axes[k] if isinstance(k, str) else k)
        fields = [np.asarray(f, dtype=np.int32) for f in (op, out, a, b)]
        n = fields[0].shape[0]
        imm = np.asarray(imm, dtype=np.float32)
        aux = np.asarray(aux, dtype=np.int32)
        if any(f.shape != (n,) for f in fields + [imm, aux]):
            raise ValueError("tape fields must be 1-D arrays of one length")
        return Tape(*(f.copy() for f in fields), imm.copy(), aux.copy(),
                    int(reg_count), int(mem_count), int(choice_count),
                    int(output_count), var_map)

    def rows(self) -> list[tuple]:
        return [
            (
                TapeOp(int(self.op[i])),
                int(self.out[i]),
                int(self.a[i]),
                int(self.b[i]),
                float(self.imm[i]),
                int(self.aux[i]),
            )
            for i in range(len(self))
        ]

    def pretty(self) -> str:
        """Human-readable disassembly (for tests and debugging)."""
        lines = []
        for op, out, a, b, imm, aux in self.rows():
            name = op.name
            if op == TapeOp.INPUT:
                lines.append(f"r{out} = INPUT[{aux}]")
            elif op == TapeOp.OUTPUT:
                lines.append(f"OUTPUT[{aux}] = r{out}")
            elif op == TapeOp.LOAD:
                lines.append(f"r{out} = m{aux}")
            elif op == TapeOp.STORE:
                lines.append(f"m{aux} = r{out}")
            elif op == TapeOp.COPY:
                src = f"{imm}" if a == IMM else f"r{a}"
                lines.append(f"r{out} = {src}")
            elif op in UNARY_TAPE_OPS:
                lines.append(f"r{out} = {name}(r{a})")
            else:
                sa = f"{imm}" if a == IMM else f"r{a}"
                sb = f"{imm}" if b == IMM else f"r{b}"
                lines.append(f"r{out} = {name}({sa}, {sb})")
        return "\n".join(lines)

    @property
    def choice_positions(self) -> np.ndarray:
        """Indices of choice ops, in evaluation (= choice) order."""
        is_choice = np.isin(self.op, [int(o) for o in CHOICE_TAPE_OPS])
        return np.nonzero(is_choice)[0].astype(np.int32)
