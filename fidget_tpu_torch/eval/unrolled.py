"""Host tape evaluation, one array operation per tape op.

The ground-truth oracle of the port (`PixelRenderer.render_brute`
runs it under numpy), and the counterpart of
`fidget_tpu.eval.unrolled.eval_tape`.
"""

from __future__ import annotations

from ..compiler.tape import (
    BINARY_TAPE_OPS,
    CHOICE_TAPE_OPS,
    IMM,
    UNARY_TAPE_OPS,
    Tape,
    TapeOp,
)
from .arith import FloatMode, GradMode, IntervalMode

MODES = {"float": FloatMode, "interval": IntervalMode, "grad": GradMode}


def eval_tape(tape: Tape, mode, inputs: list, *, trace: bool = False):
    """Evaluates `tape` with the given value mode.

    Args:
      tape: the register tape.
      mode: a FloatMode / IntervalMode / GradMode instance.
      inputs: one mode-value per tape input index (float mode: array;
        interval mode: (lo, hi); grad mode: (v, dx, dy, dz)). All
        arrays must share a common shape.
      trace: when True, also capture per-lane 2-bit choice codes for
        every choice op (min/max/and/or), in evaluation order.

    Returns:
      (outputs, choices): `outputs` is a list of mode-values, one per
      tape output; `choices` is a list of int32 arrays (length =
      tape.choice_count) when `trace` else None.

    >>> import numpy as np
    >>> from fidget_tpu_torch.core.context import Context
    >>> from fidget_tpu_torch.compiler.lower import lower
    >>> ctx = Context()
    >>> r = ctx.sqrt(ctx.add(ctx.square(ctx.x()), ctx.square(ctx.y())))
    >>> tape = lower(ctx, [ctx.sub(r, ctx.constant(1.0))])
    >>> (out,), _ = eval_tape(tape, FloatMode(np),
    ...                       [np.float32(0.0), np.float32(0.0)])
    >>> float(out)
    -1.0
    """
    if not inputs:
        raise ValueError("eval_tape requires at least one input binding")
    like = inputs[0]

    regs: dict[int, object] = {}
    mem: dict[int, object] = {}
    outputs: list = [None] * tape.output_count
    choices: list = []

    for i in range(len(tape)):
        op = TapeOp(int(tape.op[i]))
        out = int(tape.out[i])
        a = int(tape.a[i])
        b = int(tape.b[i])
        imm = float(tape.imm[i])
        aux = int(tape.aux[i])

        if op == TapeOp.INPUT:
            regs[out] = inputs[aux]
        elif op == TapeOp.OUTPUT:
            outputs[aux] = regs[out]
        elif op == TapeOp.LOAD:
            regs[out] = mem[aux]
        elif op == TapeOp.STORE:
            mem[aux] = regs[out]
        elif op == TapeOp.COPY:
            regs[out] = mode.const(imm, like) if a == IMM else regs[a]
        elif op in UNARY_TAPE_OPS:
            regs[out] = mode.unary(op, regs[a])
        elif op in BINARY_TAPE_OPS:
            va = mode.const(imm, like) if a == IMM else regs[a]
            vb = mode.const(imm, like) if b == IMM else regs[b]
            if op in CHOICE_TAPE_OPS:
                value, choice = mode.choice_binary(op, va, vb)
                regs[out] = value
                if trace:
                    choices.append(choice)
            else:
                regs[out] = mode.binary(op, va, vb)
        else:
            raise ValueError(f"cannot evaluate {op!r}")

    return outputs, (choices if trace else None)
