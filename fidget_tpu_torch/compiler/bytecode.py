"""Canonical packed-u32 bytecode (interop format).

Implements fidget's canonical tape serialization
(fidget-bytecode/src/lib.rs:10-42): little-endian u32 pairs, where
word0 packs [opcode, out, lhs, rhs] bytes and word1 is the immediate.
A register byte of 0xFF marks "use the immediate"; LOAD/STORE share the
`Mem` opcode with the 0xFF flag indicating direction; the tape begins
with `0xFFFF_FFFF 0x0000_0000` and ends with `0xFFFF_FFFF 0xFFFF_FFFF`
(jump markers enabling forward+backward iteration). Registers are
repacked by frequency of use, most frequent first
(fidget-core/src/compiler/reg_tape.rs:46-61).
"""

from __future__ import annotations

from collections import Counter

import numpy as np

from ..core.var import VarMap
from .tape import (
    IMM,
    BINARY_TAPE_OPS,
    CHOICE_TAPE_OPS,
    UNARY_TAPE_OPS,
    Tape,
    TapeOp,
)

JUMP = 0xFFFF_FFFF
HEADER = (JUMP, 0x0000_0000)
TRAILER = (JUMP, JUMP)
_UNUSED_IMM = 0xFF00_0000


def iter_ops():
    """Yields (name, value) for each canonical opcode, mirroring
    `fidget_bytecode::iter_ops` (fidget-bytecode/src/lib.rs:328-335)."""
    names = [
        "Output", "Input", "Copy", "Neg", "Abs", "Recip", "Sqrt", "Square",
        "Floor", "Ceil", "Round", "Not", "Sin", "Cos", "Tan", "Asin",
        "Acos", "Atan", "Exp", "Ln", "Add", "Sub", "Mul", "Div", "Atan2",
        "Compare", "Mod", "Min", "Max", "And", "Or", "Mem",
    ]
    for i, n in enumerate(names):
        yield (n, i)


#: TapeOp <-> canonical wire opcode. The interchange format keeps the
#: reference's numbering (fidget-bytecode/src/lib.rs:69-102) while the
#: internal TapeOp order is tuned for interpreter dispatch.
_CANONICAL = {TapeOp[name.upper()]: val for name, val in iter_ops()}
_FROM_CANONICAL = {val: op for op, val in _CANONICAL.items()}


def _f32_bits(x: float) -> int:
    return int(np.float32(x).view(np.uint32))


def repack_map(tape: Tape) -> dict[int, int]:
    """Register renumbering by frequency of use (most frequent -> 0)."""
    counts: Counter[int] = Counter()
    first: dict[int, int] = {}
    for i in range(len(tape)):
        op = TapeOp(int(tape.op[i]))
        regs = []
        if op in (TapeOp.INPUT, TapeOp.OUTPUT, TapeOp.LOAD, TapeOp.STORE):
            regs = [int(tape.out[i])]
        elif op == TapeOp.COPY:
            regs = [int(tape.out[i])]
            if int(tape.a[i]) != IMM:
                regs.append(int(tape.a[i]))
        elif op in UNARY_TAPE_OPS:
            regs = [int(tape.out[i]), int(tape.a[i])]
        elif op in BINARY_TAPE_OPS:
            regs = [int(tape.out[i])]
            if int(tape.a[i]) != IMM:
                regs.append(int(tape.a[i]))
            if int(tape.b[i]) != IMM:
                regs.append(int(tape.b[i]))
        for r in regs:
            counts[r] += 1
            first.setdefault(r, i)
    ordered = sorted(counts, key=lambda r: (-counts[r], first[r]))
    return {r: i for i, r in enumerate(ordered)}


def encode(tape: Tape) -> np.ndarray:
    """Packs a `Tape` into canonical bytecode words (uint32 array).
    >>> from fidget_tpu_torch import Context, lower
    >>> from fidget_tpu_torch.compiler.bytecode import decode, encode
    >>> ctx = Context()
    >>> root = ctx.min(ctx.x(), ctx.add(ctx.y(), ctx.constant(0.5)))
    >>> tape = lower(ctx, [root])
    >>> rt = decode(encode(tape), tape.var_map)
    >>> (len(rt), rt.choice_count) == (len(tape), tape.choice_count)
    True
    """
    m = repack_map(tape)

    def reg(r: int) -> int:
        rr = m[r]
        if rr >= 0xFF:
            raise ValueError("register 255 is reserved")
        return rr

    words: list[int] = list(HEADER)
    for i in range(len(tape)):
        op = TapeOp(int(tape.op[i]))
        out, a, b = int(tape.out[i]), int(tape.a[i]), int(tape.b[i])
        imm_f, aux = float(tape.imm[i]), int(tape.aux[i])
        w = [0xFF, 0xFF, 0xFF, 0xFF]
        imm = _UNUSED_IMM
        if op in (TapeOp.INPUT, TapeOp.OUTPUT):
            w[0] = _CANONICAL[op]
            w[1] = reg(out)
            imm = aux
        elif op == TapeOp.LOAD:
            w[0] = _CANONICAL[TapeOp.MEM]
            w[1] = reg(out)
            w[2] = 0xFF
            imm = aux
        elif op == TapeOp.STORE:
            w[0] = _CANONICAL[TapeOp.MEM]
            w[1] = 0xFF
            w[2] = reg(out)
            imm = aux
        elif op == TapeOp.COPY:
            w[0] = _CANONICAL[op]
            w[1] = reg(out)
            if a == IMM:
                imm = _f32_bits(imm_f)
            else:
                w[2] = reg(a)
        elif op in UNARY_TAPE_OPS:
            w[0] = _CANONICAL[op]
            w[1] = reg(out)
            w[2] = reg(a)
        elif op in BINARY_TAPE_OPS:
            w[0] = _CANONICAL[op]
            w[1] = reg(out)
            if a == IMM:
                w[3] = reg(b)
                imm = _f32_bits(imm_f)
            elif b == IMM:
                w[2] = reg(a)
                imm = _f32_bits(imm_f)
            else:
                w[2] = reg(a)
                w[3] = reg(b)
        else:
            raise ValueError(f"cannot encode {op!r}")
        words.append(w[0] | (w[1] << 8) | (w[2] << 16) | (w[3] << 24))
        words.append(imm & 0xFFFF_FFFF)
    words.extend(TRAILER)
    return np.array(words, dtype=np.uint32)


def decode(words: np.ndarray, var_map: VarMap | None = None) -> Tape:
    """Unpacks canonical bytecode back into a `Tape` (round-trip tested)."""
    words = np.asarray(words, dtype=np.uint32)
    # explicit validation (asserts would vanish under python -O; this
    # is the untrusted interop surface)
    if len(words) < 4 or len(words) % 2:
        raise ValueError(
            f"malformed bytecode: {len(words)} words (need an even "
            "count >= 4 for header + trailer)"
        )
    if not (words[0] == JUMP and words[1] == 0):
        raise ValueError("missing bytecode header")
    if not (words[-2] == JUMP and words[-1] == JUMP):
        raise ValueError("missing bytecode trailer")
    rows: list[tuple] = []
    reg_count = 0
    mem_count = 0
    choice_count = 0
    output_count = 0
    for k in range(2, len(words) - 2, 2):
        w0 = int(words[k])
        imm_u = int(words[k + 1])
        opc = w0 & 0xFF
        o = (w0 >> 8) & 0xFF
        a = (w0 >> 16) & 0xFF
        b = (w0 >> 24) & 0xFF
        imm_f = float(np.uint32(imm_u).view(np.float32))
        if opc == _CANONICAL[TapeOp.MEM]:
            if a == 0xFF and o != 0xFF:  # Load
                rows.append((TapeOp.LOAD, o, 0, 0, 0.0, imm_u))
            else:  # Store
                rows.append((TapeOp.STORE, a, 0, 0, 0.0, imm_u))
                o = a
            mem_count = max(mem_count, imm_u + 1)
            reg_count = max(reg_count, o + 1)
            continue
        if opc not in _FROM_CANONICAL:
            raise ValueError(f"cannot decode opcode {opc}")
        op = _FROM_CANONICAL[opc]
        if op in (TapeOp.INPUT, TapeOp.OUTPUT):
            rows.append((op, o, 0, 0, 0.0, imm_u))
            if op == TapeOp.OUTPUT:
                output_count += 1
        elif op == TapeOp.COPY:
            if a == 0xFF:
                rows.append((op, o, IMM, 0, imm_f, 0))
            else:
                rows.append((op, o, a, 0, 0.0, 0))
                reg_count = max(reg_count, a + 1)
        elif op in UNARY_TAPE_OPS:
            rows.append((op, o, a, 0, 0.0, 0))
            reg_count = max(reg_count, a + 1)
        elif op in BINARY_TAPE_OPS:
            if op in CHOICE_TAPE_OPS:
                choice_count += 1
            if a == 0xFF:
                rows.append((op, o, IMM, b, imm_f, 0))
                reg_count = max(reg_count, b + 1)
            elif b == 0xFF:
                rows.append((op, o, a, IMM, imm_f, 0))
                reg_count = max(reg_count, a + 1)
            else:
                rows.append((op, o, a, b, 0.0, 0))
                reg_count = max(reg_count, a + 1, b + 1)
        else:
            raise ValueError(f"cannot decode opcode {opc}")
        reg_count = max(reg_count, o + 1)
    if var_map is None:
        # The wire format does not carry variable identities (the
        # reference keeps the VarMap alongside the Bytecode). Without
        # one, synthesize a fresh Var per input index so the decoded
        # tape sizes its input planes correctly and evaluates
        # positionally — previously an empty VarMap made every INPUT
        # bind to a zero plane, silently evaluating f(0,0,0).
        n_inputs = 1 + max(
            (int(r[5]) for r in rows if r[0] == TapeOp.INPUT), default=-1
        )
        var_map = VarMap()
        from ..core.var import Var

        for _ in range(n_inputs):
            var_map.insert(Var.new())
    elif len(var_map):
        n_inputs = 1 + max(
            (int(r[5]) for r in rows if r[0] == TapeOp.INPUT), default=-1
        )
        if len(var_map) < n_inputs:
            raise ValueError(
                f"var_map has {len(var_map)} entries but the bytecode "
                f"references input index {n_inputs - 1}"
            )
    return Tape.from_rows(
        rows,
        reg_count=reg_count,
        mem_count=mem_count,
        choice_count=choice_count,
        output_count=output_count,
        var_map=var_map,
    )


def as_bytes(tape: Tape) -> bytes:
    """Serializes to little-endian bytes (the stable interop surface)."""
    return encode(tape).astype("<u4").tobytes()


# ---------------------------------------------------------------------
# self-contained tape container: bytecode + variable identities
#
# The wire bytecode deliberately carries no variable identities (the
# reference keeps the VarMap alongside the Bytecode buffer, and its
# web editor ships a bincoded VmData between workers instead —
# fidget-core/src/vm/data.rs:64, demos/web-editor/crate/src/lib.rs:30-45).
# This container is that VmData-serde analog: a decoded tape binds the
# SAME Var identities, so ShapeVars written against the original shape
# keep working across save/load (and across processes).

_FTPT_MAGIC = 0x46545054  # "FTPT"
_FTPT_VERSION = 1
_VAR_KINDS = ("x", "y", "z", "v")


def save_tape(tape: Tape) -> bytes:
    """Serializes tape + VarMap into one self-contained buffer.

    Layout (all little-endian): u32 magic 'FTPT', u32 version,
    u32 n_vars, u32 reserved; per var (in argument-index order)
    u32 kind (0=x 1=y 2=z 3=custom) + u64 ident; then the canonical
    bytecode words (`as_bytes`)."""
    vars_in_order = [
        v for v, _ in sorted(tape.var_map.items(), key=lambda kv: kv[1])
    ]
    head = np.array(
        [_FTPT_MAGIC, _FTPT_VERSION, len(vars_in_order), 0], "<u4"
    ).tobytes()
    body = b"".join(
        np.array([_VAR_KINDS.index(v.kind)], "<u4").tobytes()
        + np.array([v.ident], "<u8").tobytes()
        for v in vars_in_order
    )
    return head + body + as_bytes(tape)


def load_tape(data: bytes) -> Tape:
    """Decodes a `save_tape` buffer, restoring Var identities."""
    from ..core.var import Var

    head = np.frombuffer(data[:16], "<u4")
    if len(head) < 4 or int(head[0]) != _FTPT_MAGIC:
        raise ValueError("not an FTPT tape container (bad magic)")
    if int(head[1]) != _FTPT_VERSION:
        raise ValueError(f"unsupported tape container version {head[1]}")
    n_vars = int(head[2])
    off = 16
    var_map = VarMap()
    for _ in range(n_vars):
        kind = int(np.frombuffer(data[off:off + 4], "<u4")[0])
        ident = int(np.frombuffer(data[off + 4:off + 12], "<u8")[0])
        if not 0 <= kind < len(_VAR_KINDS):
            raise ValueError(f"bad var kind {kind}")
        k = _VAR_KINDS[kind]
        var_map.insert(
            getattr(Var, k.upper()) if k != "v" else Var("v", ident)
        )
        off += 12
    words = np.frombuffer(data[off:], "<u4")
    return decode(words, var_map)
