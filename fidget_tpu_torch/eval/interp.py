"""Tape-interpreter kernels: float mode (K3) and interval mode with
2-bit choice capture (K1).

The counterparts of `fidget_tpu.eval.pallas_interp.interp_float` and
`interp_interval`, with the same packed arenas (compiler/pack.py) and
the same lane layout: inputs and outputs are `[T, V, S0, 128]` planes,
one packed tape per instance t.

Each public function dispatches on the device of its tensors alone:
on CUDA it launches the hand-written kernel (csrc/interp_float.cu,
csrc/interp_interval.cu); on the CPU it runs the plain PyTorch version
beside it (`*_plain`), which walks the same tape with the arithmetic
of eval/arith.py. The plain versions take tensors on any device, so
the kernels can be held against them on the card.

The TPU kernels truncate their opcode switch to a tape's vocabulary
(`tape_n_ops`) and must never let an out-of-vocabulary op fall onto a
live branch (fidget_tpu/eval/pallas_interp.py:105-111). The CUDA
kernels dispatch through a full `switch` over the canonical op order,
so that hazard cannot arise; `tape_n_ops` is kept for callers that
size such a vocabulary.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.pack import IMM12
from ..compiler.tape import CHOICE_TAPE_OPS, TapeOp
from . import cuda
from .arith import FloatMode, IntervalMode

#: ops 0..30 are kernel-dispatchable (MEM/LOAD/STORE are packed away)
N_OPS = 31


def _decode(w1: int, w2: int):
    """(op, out, a, b, aux) of one packed row (compiler/pack.py)."""
    op = w1 & 127
    out = (w1 >> 7) & 0xFFF
    a = (w1 >> 19) & 0xFFF
    b = w2 & 0xFFF
    aux = w2 >> 12
    return op, out, a, b, aux


def tape_n_ops(tape, op_order=None, *, floor: int = 8) -> int:
    """Dispatch-vocabulary size for a tape: 1 + the highest opcode
    position it uses (canonical numbering or a pack renumbering),
    rounded up to a multiple of 4 (>= floor).

    OUTPUT/INPUT/COPY are ALWAYS counted even when the tape has no
    such ops: min/max/and/or SIMPLIFY to COPY, so per-region child
    tapes introduce opcodes the parent lacks."""
    ops = set(int(o) for o in np.asarray(tape.op))
    ops.discard(int(TapeOp.LOAD))
    ops.discard(int(TapeOp.STORE))
    ops.discard(int(TapeOp.MEM))
    ops |= {int(TapeOp.OUTPUT), int(TapeOp.INPUT), int(TapeOp.COPY)}
    if op_order is not None:
        pos_of = {int(c): p for p, c in enumerate(op_order)}
        hi = max(pos_of[o] for o in ops)
    else:
        hi = max(ops)
    return min(N_OPS, max(floor, -(-(hi + 1) // 4) * 4))


def _host_tape(w1, w2, imm, lengths):
    """Tape words as host numpy arrays (the plain versions walk them
    step by step on the host)."""
    return (
        w1.detach().cpu().numpy(), w2.detach().cpu().numpy(),
        imm.detach().cpu().numpy(), lengths.detach().cpu().numpy(),
    )


def _check_arena(w1, w2, imm, lengths):
    T, L = w1.shape
    if w2.shape != (T, L) or imm.shape != (T, L) or lengths.shape != (T,):
        raise ValueError("arena shapes must be w1/w2/imm [T, L], lengths [T]")
    for t, dt in ((w1, torch.int32), (w2, torch.int32), (lengths, torch.int32),
                  (imm, torch.float32)):
        if t.dtype != dt:
            raise ValueError(f"arena dtype {t.dtype}, expected {dt}")
    return T, L


def _check_planes(x, T, V, s0):
    if x.shape != (T, V, s0, 128) or x.dtype != torch.float32:
        raise ValueError(
            f"planes must be f32 [{T}, {V}, {s0}, 128], got "
            f"{x.dtype} {tuple(x.shape)}"
        )


# ======================================================================
# float mode (K3)


def interp_float(
    w1, w2, imm, lengths, vars_, *, nf: int, n_inputs: int, n_outputs: int,
    s0: int,
):
    """Evaluates packed tapes in bulk float mode.

    Args:
      w1/w2/imm: [T, L] packed arena (compiler/pack.py).
      lengths: [T] ops per tape (0 = skip the instance).
      vars_: [T, V, S0, 128] f32 input planes (V = n_inputs).
    Returns:
      [T, O, S0, 128] f32 outputs; 0 where the tape wrote none.
    """
    T, L = _check_arena(w1, w2, imm, lengths)
    _check_planes(vars_, T, n_inputs, s0)
    if vars_.device.type == "cpu":
        return interp_float_plain(
            w1, w2, imm, lengths, vars_, nf=nf, n_inputs=n_inputs,
            n_outputs=n_outputs, s0=s0,
        )
    cuda.check_cuda(w1, w2, imm, lengths, vars_)
    lanes = s0 * 128
    out = torch.empty(
        (T, n_outputs, s0, 128), dtype=torch.float32, device=vars_.device
    )
    scratch = None
    if nf * cuda.BLOCK * 4 > cuda.SMEM_LIMIT:
        scratch = torch.empty(
            (T, nf, lanes), dtype=torch.float32, device=vars_.device
        )
    cuda.launch(
        "interp_float", w1, w2, imm, lengths, vars_, out, scratch,
        T, L, nf, n_inputs, n_outputs, lanes,
    )
    return out


def interp_float_plain(
    w1, w2, imm, lengths, vars_, *, nf: int, n_inputs: int, n_outputs: int,
    s0: int,
):
    """Plain PyTorch version of `interp_float` (same contract)."""
    T, L = w1.shape
    dev = vars_.device
    fm = FloatMode(torch)
    out = torch.zeros((T, n_outputs, s0, 128), dtype=torch.float32, device=dev)
    w1h, w2h, immh, lensh = _host_tape(w1, w2, imm, lengths)
    for t in range(T):
        regs = torch.zeros((nf, s0, 128), dtype=torch.float32, device=dev)
        for j in range(min(int(lensh[t]), L)):
            op, o, a, b, aux = _decode(int(w1h[t, j]), int(w2h[t, j]))
            iv = float(immh[t, j])
            va = fm.const(iv, regs[0]) if a == IMM12 else regs[min(a, nf - 1)]
            vb = fm.const(iv, regs[0]) if b == IMM12 else regs[min(b, nf - 1)]
            op = TapeOp(op)
            if op == TapeOp.OUTPUT:
                out[t, min(aux, n_outputs - 1)] = va
                r = va
            elif op == TapeOp.INPUT:
                r = vars_[t, min(aux, n_inputs - 1)]
            elif op == TapeOp.COPY:
                r = va
            elif op in CHOICE_TAPE_OPS:
                r = fm.choice_binary(op, va, vb)[0]
            elif op in _UNARY:
                r = fm.unary(op, va)
            else:
                r = fm.binary(op, va, vb)
            regs[min(o, nf - 1)] = r
    return out


_UNARY = frozenset({
    TapeOp.NEG, TapeOp.ABS, TapeOp.RECIP, TapeOp.SQRT, TapeOp.SQUARE,
    TapeOp.FLOOR, TapeOp.CEIL, TapeOp.ROUND, TapeOp.NOT, TapeOp.SIN,
    TapeOp.COS, TapeOp.TAN, TapeOp.ASIN, TapeOp.ACOS, TapeOp.ATAN,
    TapeOp.EXP, TapeOp.LN,
})


# ======================================================================
# interval mode with packed 2-bit choice capture (K1)


def interp_interval(
    w1, w2, imm, lengths, var_lo, var_hi, *, nf: int, n_inputs: int,
    n_outputs: int, s0: int, c_words: int,
):
    """Evaluates packed tapes in interval mode, capturing choices.

    Args:
      var_lo/var_hi: [T, V, S0, 128] f32 interval bounds per input.
      c_words: choice words per lane (16 two-bit choices per int32).
        Choice ops carry their choice index in `aux`; indices
        >= 16*c_words fold into the last word OR-wise.
    Returns:
      (out_lo [T,O,S0,128], out_hi [T,O,S0,128], choices [T,CW,S0,128]
      int32)
    """
    T, L = _check_arena(w1, w2, imm, lengths)
    _check_planes(var_lo, T, n_inputs, s0)
    _check_planes(var_hi, T, n_inputs, s0)
    if var_lo.device.type == "cpu":
        return interp_interval_plain(
            w1, w2, imm, lengths, var_lo, var_hi, nf=nf, n_inputs=n_inputs,
            n_outputs=n_outputs, s0=s0, c_words=c_words,
        )
    cuda.check_cuda(w1, w2, imm, lengths, var_lo, var_hi)
    dev = var_lo.device
    lanes = s0 * 128
    olo = torch.empty((T, n_outputs, s0, 128), dtype=torch.float32, device=dev)
    ohi = torch.empty_like(olo)
    ch = torch.empty((T, c_words, s0, 128), dtype=torch.int32, device=dev)
    scratch = None
    if 2 * nf * cuda.BLOCK * 4 > cuda.SMEM_LIMIT:
        scratch = torch.empty(
            (2, T, nf, lanes), dtype=torch.float32, device=dev
        )
    cuda.launch(
        "interp_interval", w1, w2, imm, lengths, var_lo, var_hi, olo, ohi,
        ch, scratch, T, L, nf, n_inputs, n_outputs, c_words, lanes,
    )
    return olo, ohi, ch


def interp_interval_plain(
    w1, w2, imm, lengths, var_lo, var_hi, *, nf: int, n_inputs: int,
    n_outputs: int, s0: int, c_words: int,
):
    """Plain PyTorch version of `interp_interval` (same contract)."""
    T, L = w1.shape
    dev = var_lo.device
    im = IntervalMode(torch)
    olo = torch.zeros((T, n_outputs, s0, 128), dtype=torch.float32, device=dev)
    ohi = torch.zeros_like(olo)
    ch = torch.zeros((T, c_words, s0, 128), dtype=torch.int32, device=dev)
    w1h, w2h, immh, lensh = _host_tape(w1, w2, imm, lengths)
    for t in range(T):
        rlo = torch.zeros((nf, s0, 128), dtype=torch.float32, device=dev)
        rhi = torch.zeros_like(rlo)
        for j in range(min(int(lensh[t]), L)):
            op, o, a, b, aux = _decode(int(w1h[t, j]), int(w2h[t, j]))
            iv = float(immh[t, j])
            if a == IMM12:
                va = im.const(iv, (rlo[0],))
            else:
                va = (rlo[min(a, nf - 1)], rhi[min(a, nf - 1)])
            if b == IMM12:
                vb = im.const(iv, (rlo[0],))
            else:
                vb = (rlo[min(b, nf - 1)], rhi[min(b, nf - 1)])
            op = TapeOp(op)
            if op == TapeOp.OUTPUT:
                olo[t, min(aux, n_outputs - 1)] = va[0]
                ohi[t, min(aux, n_outputs - 1)] = va[1]
                r = va
            elif op == TapeOp.INPUT:
                i = min(aux, n_inputs - 1)
                r = (var_lo[t, i], var_hi[t, i])
            elif op == TapeOp.COPY:
                r = va
            elif op in CHOICE_TAPE_OPS:
                r, code = im.choice_binary(op, va, vb)
                word = min(aux // 16, c_words - 1)
                ch[t, word] |= code << ((aux % 16) * 2)
            elif op in _UNARY:
                r = im.unary(op, va)
            else:
                r = im.binary(op, va, vb)
            rlo[min(o, nf - 1)] = r[0]
            rhi[min(o, nf - 1)] = r[1]
    return olo, ohi, ch
