"""Tape simplification from interval-evaluation traces, on the host.

The counterpart of `fidget_tpu.compiler.simplify`: plain numpy, one tape
and one choice trace at a time. It is the oracle that the batched
device simplifier (eval/simplify_device.py) is held against.

Given the 2-bit choice array captured by an interval evaluation, this
rewrites a tape into a shorter one specialized for that region: choice
ops whose trace is Left/Right collapse into copies (elided entirely when
source and destination registers coincide), and dead code is dropped via
a reverse liveness walk over registers and memory slots.

This follows the GPU pipeline's in-place strategy
(fidget-wgpu/src/voxel/shaders/tape_simplify.wgsl:56-179): register
assignments are *kept* rather than re-allocated, so a simplified tape
always runs on the same register file as its parent — which is what lets
the batched on-device simplifier (eval/simplify_device.py) be a pure
data-parallel scan. The reference's CPU path re-allocates registers
(fidget-core/src/vm/data.rs:123-314); semantics are identical.
"""

from __future__ import annotations

import numpy as np

from .tape import (
    CHOICE_LEFT,
    CHOICE_RIGHT,
    IMM,
    BINARY_TAPE_OPS,
    CHOICE_TAPE_OPS,
    UNARY_TAPE_OPS,
    Tape,
    TapeOp,
)


def simplify(tape: Tape, choices: np.ndarray) -> Tape:
    """Returns a specialized copy of `tape` for the given choice trace.

    `choices` is a uint8 array of length `tape.choice_count` holding
    2-bit codes (1=Left, 2=Right, 3=Both) in evaluation order.
    """
    choices = np.asarray(choices)
    if choices.shape != (tape.choice_count,):
        raise ValueError(
            f"expected {tape.choice_count} choice codes, got {choices.shape}"
        )

    n = len(tape)
    live_reg = np.zeros(tape.reg_count, dtype=bool)
    live_mem = np.zeros(max(tape.mem_count, 1), dtype=bool)
    kept_rows: list[tuple] = []  # built in reverse order
    choice_idx = tape.choice_count
    new_choice_count = 0

    for i in range(n - 1, -1, -1):
        op = TapeOp(int(tape.op[i]))
        out = int(tape.out[i])
        a = int(tape.a[i])
        b = int(tape.b[i])
        imm = float(tape.imm[i])
        aux = int(tape.aux[i])

        if op in CHOICE_TAPE_OPS:
            choice_idx -= 1

        if op == TapeOp.OUTPUT:
            live_reg[out] = True
            kept_rows.append((op, out, 0, 0, 0.0, aux))
            continue
        if op == TapeOp.STORE:
            if live_mem[aux]:
                live_mem[aux] = False
                live_reg[out] = True
                kept_rows.append((op, out, 0, 0, 0.0, aux))
            continue
        if op == TapeOp.LOAD:
            if live_reg[out]:
                live_reg[out] = False
                live_mem[aux] = True
                kept_rows.append((op, out, 0, 0, 0.0, aux))
            continue

        if not live_reg[out]:
            continue  # dead code

        if op == TapeOp.INPUT:
            live_reg[out] = False
            kept_rows.append((op, out, 0, 0, 0.0, aux))
        elif op == TapeOp.COPY:
            live_reg[out] = False
            if a != IMM:
                live_reg[a] = True
            kept_rows.append((op, out, a, 0, imm, 0))
        elif op in UNARY_TAPE_OPS:
            live_reg[out] = False
            live_reg[a] = True
            kept_rows.append((op, out, a, 0, 0.0, 0))
        elif op in CHOICE_TAPE_OPS:
            c = int(choices[choice_idx])
            if c == CHOICE_LEFT:
                src = a
            elif c == CHOICE_RIGHT:
                src = b
            else:
                live_reg[out] = False
                if a != IMM:
                    live_reg[a] = True
                if b != IMM:
                    live_reg[b] = True
                kept_rows.append((op, out, a, b, imm, 0))
                new_choice_count += 1
                continue
            # Specialize to a copy (or elide when it's a self-copy)
            if src == IMM:
                live_reg[out] = False
                kept_rows.append((TapeOp.COPY, out, IMM, 0, imm, 0))
            elif src == out:
                pass  # value already lives in the right register
            else:
                live_reg[out] = False
                live_reg[src] = True
                kept_rows.append((TapeOp.COPY, out, src, 0, 0.0, 0))
        elif op in BINARY_TAPE_OPS:
            live_reg[out] = False
            if a != IMM:
                live_reg[a] = True
            if b != IMM:
                live_reg[b] = True
            kept_rows.append((op, out, a, b, imm, 0))
        else:
            raise ValueError(f"unexpected op {op!r}")

    kept_rows.reverse()
    return Tape.from_rows(
        kept_rows,
        reg_count=tape.reg_count,
        mem_count=tape.mem_count,
        choice_count=new_choice_count,
        output_count=tape.output_count,
        var_map=tape.var_map,
    )
