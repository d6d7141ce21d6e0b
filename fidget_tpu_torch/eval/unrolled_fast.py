"""Whole-tape evaluation with the per-shape compiled path's semantics.

The counterpart of `fidget_tpu.eval.unrolled_fast`, and the plain
PyTorch versions of the two kernels generated per tape
(eval/unrolled_cuda.py): `eval_tape_float_fast` is `unrolled_float`'s
arithmetic (U1), `eval_tape_interval_fast` is `unrolled_interval`'s
(U2). Both walk the tape once over tensors of any shape.

Their rules are not the interpreter's (eval/arith.py), and are copied
from the reference exactly:

- MIN/MAX are NaN-propagating `minimum` / `maximum`, in float and in
  interval mode; an interval MIN chooses Left when `au < bl`, Right
  when `bu < al`, else Both (MAX mirrors it), and poisons nothing;
- interval DIV poisons to NaN only when the denominator spans zero (an
  immediate denominator only when it is 0); NaN operands flow through
  the NaN-propagating corner folds;
- AND/OR go through `IntervalMode.choice_binary` (and the float mode's
  select);
- every other op is `IntervalMode` / `FloatMode`.

Anywhere these differ from the interpreter the fast bounds are NaN, and
a NaN bound fails both cull proofs, so the tile stays active: proofs
are sound, and equal to the interpreter's on NaN-free paths.

Choice j lands in word j // 16 at bit 2 * (j % 16) of a uint32 (held
in int32 tensors, as the interpreter's choice words are), the layout of
`compiler.unions.pack_choices`.
"""

from __future__ import annotations

import math

import torch

from ..compiler.tape import (
    BINARY_TAPE_OPS,
    CHOICE_TAPE_OPS,
    IMM,
    UNARY_TAPE_OPS,
    Tape,
    TapeOp,
)
from .arith import FloatMode, IntervalMode

_MIN, _MAX = int(TapeOp.MIN), int(TapeOp.MAX)
_AND, _OR = int(TapeOp.AND), int(TapeOp.OR)
_DIV = int(TapeOp.DIV)
_INPUT, _OUTPUT = int(TapeOp.INPUT), int(TapeOp.OUTPUT)
_LOAD, _STORE, _COPY = int(TapeOp.LOAD), int(TapeOp.STORE), int(TapeOp.COPY)
_UNARY = frozenset(int(o) for o in UNARY_TAPE_OPS)
_PLAIN_BIN = frozenset(
    int(o) for o in BINARY_TAPE_OPS if o not in CHOICE_TAPE_OPS
)


def _word_bits(code_left, code_right, shift):
    """int32 contribution of one choice: 1, 2 or 3 at bit `shift`."""
    c = torch.where(
        code_left, 1, torch.where(code_right, 2, 3)
    ).to(torch.int64)
    return c << shift


def _to_i32(w):
    """uint32 bit patterns held in int64 -> int32 tensor."""
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


def interval_row(im, op: int, va, vb, imm: float, b_is_imm: bool):
    """One computing row of `eval_tape_interval_fast`: (value, choice),
    choice the (left, right) masks of a choice op, else None. `va` /
    `vb` are (lo, hi) pairs (`vb` None for a unary op); `imm` and
    `b_is_imm` are the row's immediate and whether b is that immediate
    (an immediate denominator of 0 poisons the whole result)."""
    if op == _MIN or op == _MAX:
        (al, au), (bl, bu) = va, vb
        if op == _MIN:
            return ((torch.minimum(al, bl), torch.minimum(au, bu)),
                    (au < bl, bu < al))
        return ((torch.maximum(al, bl), torch.maximum(au, bu)),
                (al > bu, bl > au))
    if op == _DIV:
        (al, au), (bl, bu) = va, vb
        q0, q1, q2, q3 = al / bl, al / bu, au / bl, au / bu
        lo = torch.minimum(torch.minimum(q0, q1), torch.minimum(q2, q3))
        hi = torch.maximum(torch.maximum(q0, q1), torch.maximum(q2, q3))
        n = torch.full_like(lo, math.nan)
        if b_is_imm:
            return ((n, n) if imm == 0.0 else (lo, hi)), None
        bad = ~((bl > 0.0) | (bu < 0.0))
        return (torch.where(bad, n, lo), torch.where(bad, n, hi)), None
    if op in _PLAIN_BIN:
        return im.binary(TapeOp(op), va, vb), None
    if op in _UNARY:
        return im.unary(TapeOp(op), va), None
    if op == _AND or op == _OR:
        val, ch = im.choice_binary(TapeOp(op), va, vb)
        return val, (ch == 1, ch == 2)
    raise ValueError(f"cannot evaluate op {op}")


def eval_tape_interval_fast(tape: Tape, inputs: list, *, capture=False,
                            u_words=None):
    """Interval evaluation of `tape` with the fast rules (module doc).

    Args:
      tape: the register tape.
      inputs: one (lo, hi) pair of f32 tensors per tape input index,
        all of one shape.
      capture: also return the packed choice words, a list of
        ceil(choice_count / 16) int32 tensors of the inputs' shape.
      u_words: violation mode (exclusive with `capture`): a [cw, lanes]
        int32 tensor of reference codes per lane, word-major, in the
        same packing; returns viol[lane], True iff some captured code
        has a bit outside the reference code.

    Returns:
      (los, his), (los, his, words) with `capture`, or
      (los, his, viol) with `u_words`; `los` / `his` one tensor per
      tape output.
    """
    if capture and u_words is not None:
        raise ValueError("capture and u_words are exclusive")
    im = IntervalMode(torch)
    like = inputs[0][0]
    regs: dict[int, tuple] = {}
    mem: dict[int, tuple] = {}
    n_out = tape.output_count
    los: list = [None] * n_out
    his: list = [None] * n_out
    words: list = []
    viol = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
    acc = None
    n_choice = 0

    def full(v):
        return torch.full_like(like, v)

    def operand(sel, imm):
        if sel == IMM:
            c = full(imm)
            return (c, c)
        return regs[sel]

    def emit(left, right):
        nonlocal n_choice, acc, viol
        j = n_choice
        n_choice += 1
        if u_words is None and not capture:
            return
        s = 2 * (j % 16)
        contrib = _word_bits(left, right, s)
        acc = contrib if s == 0 else (acc | contrib)
        if j % 16 == 15 or j == tape.choice_count - 1:
            if capture:
                words.append(_to_i32(acc))
            else:
                u = u_words[j // 16].to(torch.int64) & 0xFFFFFFFF
                viol = viol | ((acc | u) != u)

    ops = tape.op.tolist()
    outs_ = tape.out.tolist()
    aas = tape.a.tolist()
    bbs = tape.b.tolist()
    imms = tape.imm.tolist()
    auxs = tape.aux.tolist()
    for i in range(len(ops)):
        op, out, a, b = ops[i], outs_[i], aas[i], bbs[i]
        if op == _INPUT:
            regs[out] = inputs[auxs[i]]
        elif op == _OUTPUT:
            los[auxs[i]], his[auxs[i]] = regs[out]
        elif op == _COPY:
            regs[out] = operand(a, imms[i])
        elif op == _LOAD:
            regs[out] = mem[auxs[i]]
        elif op == _STORE:
            mem[auxs[i]] = regs[out]
        else:
            va = operand(a, imms[i])
            vb = operand(b, imms[i]) if op not in _UNARY else None
            regs[out], choice = interval_row(im, op, va, vb, imms[i],
                                             b == IMM)
            if choice is not None:
                emit(*choice)

    if n_choice != tape.choice_count:
        raise ValueError("tape.choice_count does not match its choice ops")
    if u_words is not None:
        return los, his, viol
    if capture:
        return los, his, words
    return los, his


def eval_tape_float_fast(tape: Tape, inputs: list):
    """Float evaluation of `tape` with the fast rules (module doc).

    Args:
      tape: the register tape.
      inputs: one f32 tensor per tape input index, all of one shape.
    Returns:
      one tensor per tape output.
    """
    fm = FloatMode(torch)
    like = inputs[0]
    regs: dict[int, torch.Tensor] = {}
    mem: dict[int, torch.Tensor] = {}
    outputs: list = [None] * tape.output_count

    def operand(sel, imm):
        return torch.full_like(like, imm) if sel == IMM else regs[sel]

    ops = tape.op.tolist()
    outs_ = tape.out.tolist()
    aas = tape.a.tolist()
    bbs = tape.b.tolist()
    imms = tape.imm.tolist()
    auxs = tape.aux.tolist()
    for i in range(len(ops)):
        op, out, a, b = ops[i], outs_[i], aas[i], bbs[i]
        if op == _MIN or op == _MAX:
            va, vb = operand(a, imms[i]), operand(b, imms[i])
            regs[out] = (
                torch.minimum(va, vb) if op == _MIN else torch.maximum(va, vb)
            )
        elif op in _PLAIN_BIN:
            regs[out] = fm.binary(
                TapeOp(op), operand(a, imms[i]), operand(b, imms[i])
            )
        elif op in _UNARY:
            regs[out] = fm.unary(TapeOp(op), regs[a])
        elif op == _INPUT:
            regs[out] = inputs[auxs[i]]
        elif op == _OUTPUT:
            outputs[auxs[i]] = regs[out]
        elif op == _AND or op == _OR:
            va, vb = operand(a, imms[i]), operand(b, imms[i])
            left = (va == 0.0) if op == _AND else (va != 0.0)
            regs[out] = torch.where(left, va, vb)
        elif op == _COPY:
            regs[out] = operand(a, imms[i])
        elif op == _LOAD:
            regs[out] = mem[auxs[i]]
        elif op == _STORE:
            mem[auxs[i]] = regs[out]
        else:
            raise ValueError(f"cannot evaluate op {op}")
    return outputs
