"""Device tape packing.

Packs `Tape`s into the fixed-width SoA layout consumed by the
interpreter kernels (eval/interp.py, csrc/*.cu). The words are
bit-identical to `fidget_tpu.compiler.pack`:

- ``w1 = op | out << 7 | a << 19``  (op 7 bits, out/a 12 bits each)
- ``w2 = b | aux << 12``            (b 12 bits, aux 19 bits)
- ``imm``: f32 immediate

Registers and spill slots are unified into one file: memory slot `s`
becomes register `reg_count + s`, which turns LOAD/STORE into plain
COPY ops (the kernel never needs a separate memory space). OUTPUT rows
get ``a := out`` so the kernel's uniform "read va, write regs[out]"
dataflow is a no-op for them. The operand value 0xFFF marks "use the
immediate" (the 12-bit analog of the canonical format's 0xFF,
fidget-bytecode/src/lib.rs:36-38).

Multiple tapes pack into a padded arena [T, Lcap] for grid dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tape import IMM, Tape, TapeOp

#: 12-bit immediate marker in the packed operand fields.
IMM12 = 0xFFF

#: Field limits
MAX_UNIFIED_REGS = 0xFFE  # 12-bit operand space minus the IMM marker
MAX_AUX = (1 << 19) - 1


@dataclass
class PackedTapes:
    """A padded arena of packed tapes ready for device dispatch."""

    w1: np.ndarray  # int32 [T, Lcap]
    w2: np.ndarray  # int32 [T, Lcap]
    imm: np.ndarray  # float32 [T, Lcap]
    lengths: np.ndarray  # int32 [T]
    nf: int  # unified register-file size (regs + mem slots)
    n_inputs: int
    n_outputs: int
    n_choices: np.ndarray  # int32 [T] choice ops per tape

    @property
    def capacity(self) -> int:
        return int(self.w1.shape[1])


#: kernel-dispatchable opcode count (matches interp.N_OPS)
N_KERNEL_OPS = 31


def frequency_op_order(tape: Tape) -> tuple[int, ...]:
    """Permutation position -> canonical TapeOp, hottest ops first.

    An interpreter whose dispatch is a linear branch scan pays per
    untaken position, so renumbering a shape's opcodes by ITS OWN
    execution frequency cuts the mean scan depth. Spill LOAD/STOREs
    count toward COPY, matching the packed encoding."""
    op = tape.op.astype(np.int64)
    op = np.where(
        (op == int(TapeOp.LOAD)) | (op == int(TapeOp.STORE)),
        int(TapeOp.COPY), op,
    )
    counts = np.bincount(op, minlength=N_KERNEL_OPS)[:N_KERNEL_OPS]
    # simplified child tapes rewrite resolved choice ops into COPY, so
    # the runtime COPY frequency is the static count PLUS a large share
    # of the choice ops — weight it accordingly or COPY lands in the
    # scan tail and the leaf pass pays extra on every rewrite
    n_choice = sum(
        int(counts[int(o)])
        for o in (TapeOp.MIN, TapeOp.MAX, TapeOp.AND, TapeOp.OR)
    )
    counts = counts.astype(np.float64)
    counts[int(TapeOp.COPY)] += n_choice
    # stable sort: ties keep canonical (already globally frequency
    # ordered) positions
    order = np.argsort(-counts, kind="stable")
    return tuple(int(o) for o in order)


def _op_rank(op_order) -> np.ndarray:
    rank = np.zeros(N_KERNEL_OPS, np.int64)
    for pos, canon in enumerate(op_order):
        rank[canon] = pos
    return rank


def pack_rows(
    tape: Tape, op_order: tuple[int, ...] | None = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Packs one tape into (w1, w2, imm) int32/int32/f32 arrays.

    op_order renumbers opcodes (position -> canonical op); the kernels
    must then be built with the same order."""
    L = len(tape)
    nr = tape.reg_count
    op = tape.op.astype(np.int64)
    out = tape.out.astype(np.int64)
    a = tape.a.astype(np.int64)
    b = tape.b.astype(np.int64)
    aux = tape.aux.astype(np.int64)
    imm = tape.imm.astype(np.float32).copy()

    is_load = op == int(TapeOp.LOAD)
    is_store = op == int(TapeOp.STORE)
    is_output = op == int(TapeOp.OUTPUT)
    is_input = op == int(TapeOp.INPUT)

    # Remap the 8-bit IMM marker to the 12-bit one FIRST: after the
    # LOAD/STORE unification below, operand values >= 255 are legitimate
    # unified register indices (mem slot 0 with a full register file is
    # exactly 255) and must not be confused with the marker.
    a = np.where(a == IMM, IMM12, a)
    b = np.where(b == IMM, IMM12, b)

    # LOAD r <- m[aux]  ==>  COPY r <- reg[nr+aux]
    a = np.where(is_load, nr + aux, a)
    # STORE m[aux] <- r  ==>  COPY reg[nr+aux] <- r
    a = np.where(is_store, out, a)
    out = np.where(is_store, nr + aux, out)
    op = np.where(is_load | is_store, int(TapeOp.COPY), op)
    aux = np.where(is_load | is_store, 0, aux)
    # OUTPUT: uniform dataflow no-op (read regs[out], write it back)
    a = np.where(is_output, out, a)

    # Choice ops carry their choice index (tape evaluation order) in aux,
    # so interval kernels can scatter 2-bit codes without a counter.
    is_choice = (
        (op == int(TapeOp.MIN)) | (op == int(TapeOp.MAX))
        | (op == int(TapeOp.AND)) | (op == int(TapeOp.OR))
    )
    aux = np.where(is_choice, np.cumsum(is_choice) - 1, aux)

    # Unary/copy rows have don't-care b; INPUT/OUTPUT have don't-care a/b
    b = np.where(is_input | is_output, out, b)

    nf = nr + tape.mem_count
    if nf > MAX_UNIFIED_REGS:
        raise ValueError(f"unified register file too large: {nf}")
    if aux.max(initial=0) > MAX_AUX:
        raise ValueError("aux field overflow")

    if op_order is not None:
        op = _op_rank(op_order)[op]

    w1 = (op | (out << 7) | (a << 19)).astype(np.int32)
    w2 = (b | (aux << 12)).astype(np.int32)
    return w1, w2, imm


def pack_tapes(
    tapes: list[Tape], capacity: int | None = None,
    op_order: tuple[int, ...] | None = None,
) -> PackedTapes:
    """Packs tapes into a padded [T, Lcap] arena.

    Padding rows are OUTPUT no-ops, but the per-tape `lengths` mean the
    kernel never reads them.
    """
    assert tapes, "need at least one tape"
    lengths = np.array([len(t) for t in tapes], dtype=np.int32)
    Lcap = int(capacity if capacity is not None else lengths.max())
    if lengths.max(initial=0) > Lcap:
        raise ValueError("tape longer than arena capacity")
    T = len(tapes)
    w1 = np.zeros((T, Lcap), dtype=np.int32)
    w2 = np.zeros((T, Lcap), dtype=np.int32)
    imm = np.zeros((T, Lcap), dtype=np.float32)
    nf = 0
    n_inputs = 0
    n_outputs = 0
    n_choices = np.zeros(T, dtype=np.int32)
    for t_i, tape in enumerate(tapes):
        a1, a2, ai = pack_rows(tape, op_order)
        L = len(tape)
        w1[t_i, :L] = a1
        w2[t_i, :L] = a2
        imm[t_i, :L] = ai
        nf = max(nf, tape.reg_count + tape.mem_count)
        n_inputs = max(n_inputs, len(tape.var_map))
        n_outputs = max(n_outputs, tape.output_count)
        n_choices[t_i] = tape.choice_count
    return PackedTapes(w1, w2, imm, lengths, nf, n_inputs, n_outputs, n_choices)
