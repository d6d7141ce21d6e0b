"""Tape-interpreter kernels: float mode (K3), interval mode with 2-bit
choice capture (K1), grad mode (K4), float mode fused with the voxel
depth reduction (K5) and float mode over one shared tape specialized
per tile by action codes (K6).

The counterparts of `fidget_tpu.eval.pallas_interp.interp_float`,
`interp_interval`, `interp_grad`, `interp_voxel_depth` and
`interp_float_coded`, with the same packed arenas (compiler/pack.py)
and the same lane layout: inputs and outputs are `[T, V, S0, 128]`
planes (`[T, V, P, S0, 128]` dual planes in grad mode, P = 2 to 4),
one packed tape per instance t (K6: one tape for all).

Each public function dispatches on the device of its tensors alone:
on CUDA it launches the hand-written kernel (csrc/interp_float.cu,
csrc/interp_interval.cu, csrc/interp_grad.cu,
csrc/interp_voxel_depth.cu, csrc/interp_float_coded.cu); on the CPU it
runs the plain PyTorch
version beside it (`*_plain`), which walks the same tape with the
arithmetic of eval/arith.py. The plain versions take tensors on any
device, so the kernels can be held against them on the card.

The TPU kernels truncate their opcode switch to a tape's vocabulary
(`tape_n_ops`) and must never let an out-of-vocabulary op fall onto a
live branch (fidget_tpu/eval/pallas_interp.py:105-111). The CUDA
kernels dispatch through a full `switch` over the canonical op order,
so that hazard cannot arise; `tape_n_ops` is kept for callers that
size such a vocabulary. An arena packed under a per-shape opcode
renumbering (`pack_tapes(op_order=...)`) is evaluated by passing the
same `op_order` to every kernel and the simplifier: the kernels map the
op field back to canonical opcodes through a 31-entry table instead of
being compiled per order. Results are silently wrong if the orders
differ. The TPU wrappers of K1 and K4 split the lane
axis to fit their VMEM budget; lanes are independent on the card, so
the port has no split. K5 drops the TPU's `tiles_per_step`, which
amortized a per-grid-step cost the card does not have (the bucketed 3D
path ran it at 1).

Every kernel stages its tape through shared memory and K3-K6 give a
thread up to four lanes (K4 up to `cuda.GRAD_LANES`); how a launch is
laid out (lanes per thread, shared-memory bytes, tape chunk, register
file and choice words in shared or in device memory) is decided by
`cuda.launch_geometry` from (nf, lanes, c_words, T, sub), so `nf`
should be the registers the tapes can name, not a padded bucket: a
small file is what lets K3-K6 run several lanes a thread from shared
memory.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..compiler.pack import IMM12
from ..compiler.tape import CHOICE_TAPE_OPS, TapeOp
from ..utils import count
from . import cuda
from .arith import FloatMode, GradMode, IntervalMode

#: ops 0..30 are kernel-dispatchable (MEM/LOAD/STORE are packed away)
N_OPS = 31


def _decode(w1: int, w2: int, op_order=None):
    """(op, out, a, b, aux) of one packed row (compiler/pack.py); the
    op is canonical, mapped back through `op_order` (position ->
    canonical opcode) when the arena was packed under one."""
    op = w1 & 127
    if op_order is not None and op < N_OPS:
        op = int(op_order[op])
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


def _carries_gradient(t) -> bool:
    """Whether `t` takes part in reverse mode (it requires grad while
    grad mode is on) or in forward mode (it is a dual tensor)."""
    if t.requires_grad and torch.is_grad_enabled():
        return True
    return fwAD.unpack_dual(t).tangent is not None


# ======================================================================
# float mode (K3)


def interp_float(
    w1, w2, imm, lengths, vars_, *, nf: int, n_inputs: int, n_outputs: int,
    s0: int, op_order: tuple | None = None,
):
    """Evaluates packed tapes in bulk float mode.

    Differentiable in `vars_`, in reverse mode (`backward`,
    `torch.func.grad`) and forward mode (`torch.autograd.forward_ad`,
    `torch.func.jvp` / `jacfwd`), through `_FloatDiff` on both devices:
    the Jacobian comes from the dual-number pass (`interp_grad`), as the
    reference's custom JVP (fidget_tpu/eval/pallas_interp.py:239-298)
    builds it. The tape words, immediates and lengths get no gradient:
    parameters enter as `Var` input planes.

    Args:
      w1/w2/imm: [T, L] packed arena (compiler/pack.py).
      lengths: [T] ops per tape (0 = skip the instance).
      vars_: [T, V, S0, 128] f32 input planes (V = n_inputs).
      op_order: the opcode renumbering the arena was packed with
        (pack.frequency_op_order); None for the canonical order.
    Returns:
      [T, O, S0, 128] f32 outputs; 0 where the tape wrote none.
    """
    T, L = _check_arena(w1, w2, imm, lengths)
    _check_planes(vars_, T, n_inputs, s0)
    order = None if op_order is None else tuple(int(o) for o in op_order)
    return _FloatDiff.apply(
        w1, w2, imm, lengths, vars_, (nf, n_inputs, n_outputs, s0, order)
    )


class _FloatDiff(torch.autograd.Function):
    """`interp_float` with its derivative in `vars_`.

    The primal is K3 (the plain version on the CPU). The Jacobian
    J[t, o, i] comes from `_FloatJacobian` in every input: ceil(V/3)
    passes of the dual-number kernel K4 (`interp_grad_plain` on the
    CPU), each seeding one-hot tangents on up to three inputs, with the
    same `op_order`; partials that are not finite (sqrt, abs and recip
    at their kinks) read as 0, so that a kink cannot poison every
    parameter through a zero tangent.
    `backward` contracts the incoming gradient with J, `jvp` contracts
    J with the tangent. The CPU takes the same route, never autograd
    of the plain version's own ops, so both devices differentiate
    alike. The Jacobian is built only when a derivative is asked for:
    a plain forward costs one K3 launch."""

    generate_vmap_rule = True

    @staticmethod
    def forward(w1, w2, imm, lengths, vars_, cfg):
        nf, n_inputs, n_outputs, s0, order = cfg
        return _interp_float_value(
            w1, w2, imm, lengths, vars_, nf=nf, n_inputs=n_inputs,
            n_outputs=n_outputs, s0=s0, op_order=order,
        )

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cfg = inputs[5]
        ctx.save_for_backward(*inputs[:5])
        ctx.save_for_forward(*inputs[:5])

    @staticmethod
    def backward(ctx, grad_out):
        J = _FloatJacobian.apply(*ctx.saved_tensors, ctx.cfg)
        grad_vars = (grad_out[:, :, None] * J).sum(dim=1)
        return None, None, None, None, grad_vars, None

    @staticmethod
    def jvp(ctx, dw1, dw2, dimm, dlengths, dvars, dcfg):
        if dvars is None:  # a tangent on the immediates only
            _, n_inputs, n_outputs, s0, _ = ctx.cfg
            vars_ = ctx.saved_tensors[4]
            return vars_.new_zeros((vars_.shape[0], n_outputs, s0, 128))
        J = _FloatJacobian.apply(*ctx.saved_tensors, ctx.cfg)
        return (J * dvars[:, None]).sum(dim=2)


class _FloatJacobian(torch.autograd.Function):
    """J [T, O, V, S0, 128] of `interp_float` in `vars_`, non-finite
    partials set to 0 (see `_FloatDiff`); a constant of the derivative
    rules. A Function of its own, so that under `torch.func` transforms
    the kernels get the plain tensors the transform wraps.

    `cfg` is (nf, n_inputs, n_outputs, s0, op_order[, wanted]): `wanted`
    names the inputs to differentiate in, every input by default. They
    are seeded three to a pass, in the order given, and each K4 pass
    carries only the tangents it seeds (duals of 1 + seeds planes); the
    columns of the other inputs are 0, not computed. Counts the tangent
    planes its passes evaluate, the seeded ones over every lane, padding
    included (`jacobian.tangents_computed`)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(w1, w2, imm, lengths, vars_, cfg):
        nf, n_inputs, n_outputs, s0, order = cfg[:5]
        wanted = tuple(cfg[5]) if len(cfg) > 5 else tuple(range(n_inputs))
        T = vars_.shape[0]
        count("jacobian.tangents_computed", len(wanted) * T * s0 * 128)
        # columns by input, stacked at the end: an index tensor would
        # copy from the host and wait for the card
        cols = [None] * n_inputs
        for i0 in range(0, len(wanted), 3):
            seeds = wanted[i0:i0 + 3]
            duals = vars_.new_zeros((T, n_inputs, 1 + len(seeds), s0, 128))
            duals[:, :, 0] = vars_
            for c, i in enumerate(seeds):
                duals[:, i, 1 + c] = 1.0
            g = interp_grad(
                w1, w2, imm, lengths, duals, nf=nf, n_inputs=n_inputs,
                n_outputs=n_outputs, s0=s0, op_order=order,
            )
            for c, i in enumerate(seeds):
                cols[i] = g[:, :, 1 + c]
        if any(c is None for c in cols):
            zero = vars_.new_zeros((T, n_outputs, s0, 128))
            cols = [zero if c is None else c for c in cols]
        J = torch.stack(cols, dim=2)
        return torch.where(torch.isfinite(J), J, torch.zeros_like(J))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad_J):
        return None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, *tangents):
        return None


def untracked(fn, *args):
    """`fn(*args)` as a constant of differentiation: its outputs (a tuple
    of tensors and Nones) carry no gradient in reverse or forward mode,
    and under `torch.func` transforms `fn` sees plain tensors, which the
    kernels and the host-side tape walks need (a transform's wrapped
    tensors have no storage)."""
    return _Untracked.apply(fn, *args)


class _Untracked(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, *args):
        return fn(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n_inputs = len(inputs)
        ctx.mark_non_differentiable(
            *[o for o in output if isinstance(o, torch.Tensor)]
        )

    @staticmethod
    def backward(ctx, *grads):
        return (None,) * ctx.n_inputs

    @staticmethod
    def jvp(ctx, *tangents):
        return None


def _interp_float_value(
    w1, w2, imm, lengths, vars_, *, nf, n_inputs, n_outputs, s0, op_order,
):
    """The value of `interp_float`: K3 on CUDA, the plain version on the
    CPU."""
    T, L = w1.shape
    if vars_.device.type == "cpu":
        return interp_float_plain(
            w1, w2, imm, lengths, vars_, nf=nf, n_inputs=n_inputs,
            n_outputs=n_outputs, s0=s0, op_order=op_order,
        )
    cuda.check_cuda(w1, w2, imm, lengths, vars_)
    lanes = s0 * 128
    out = torch.empty(
        (T, n_outputs, s0, 128), dtype=torch.float32, device=vars_.device
    )
    g = cuda.launch_geometry("interp_float", nf=nf, lanes=lanes, T=T)
    scratch = None
    if not g.regs_shared:
        scratch = _scratch((T, nf, lanes), vars_.device)
    cuda.launch(
        "interp_float", w1, w2, imm, lengths, vars_, out, scratch,
        cuda.order_table(op_order, vars_.device),
        T, L, nf, n_inputs, n_outputs, lanes, g.r, g.chunk, g.smem,
    )
    return out


def _scratch(shape, device):
    """A global-memory register file for a kernel whose file no shared
    memory holds; the kernels address one instance's part of it with
    32-bit byte offsets."""
    if 8 * int(np.prod(shape[1:])) >= 2**31:
        raise ValueError(f"register file {shape} is too large to address")
    return torch.empty(shape, dtype=torch.float32, device=device)


def interp_float_plain(
    w1, w2, imm, lengths, vars_, *, nf: int, n_inputs: int, n_outputs: int,
    s0: int, op_order: tuple | None = None,
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
            op, o, a, b, aux = _decode(
                int(w1h[t, j]), int(w2h[t, j]), op_order
            )
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
    n_outputs: int, s0: int, c_words: int, op_order: tuple | None = None,
):
    """Evaluates packed tapes in interval mode, capturing choices.

    Args:
      var_lo/var_hi: [T, V, S0, 128] f32 interval bounds per input.
      c_words: choice words per lane (16 two-bit choices per int32).
        Choice ops carry their choice index in `aux`; indices
        >= 16*c_words fold into the last word OR-wise.
      op_order: the opcode renumbering the arena was packed with; None
        for the canonical order.
    Returns:
      (out_lo [T,O,S0,128], out_hi [T,O,S0,128], choices [T,CW,S0,128]
      int32)
    """
    T, L = _check_arena(w1, w2, imm, lengths)
    _check_planes(var_lo, T, n_inputs, s0)
    _check_planes(var_hi, T, n_inputs, s0)
    # no gradient flows through an interval proof (the reference's zero
    # JVP, pallas_interp.py:746-758)
    var_lo, var_hi = var_lo.detach(), var_hi.detach()
    if var_lo.device.type == "cpu":
        return interp_interval_plain(
            w1, w2, imm, lengths, var_lo, var_hi, nf=nf, n_inputs=n_inputs,
            n_outputs=n_outputs, s0=s0, c_words=c_words, op_order=op_order,
        )
    cuda.check_cuda(w1, w2, imm, lengths, var_lo, var_hi)
    dev = var_lo.device
    lanes = s0 * 128
    olo = torch.empty((T, n_outputs, s0, 128), dtype=torch.float32, device=dev)
    ohi = torch.empty_like(olo)
    g = cuda.launch_geometry(
        "interp_interval", nf=nf, lanes=lanes, T=T, cw=c_words
    )
    # the kernel writes every choice word from shared memory, or ORs
    # into zeroed device memory where the words do not fit there
    alloc = torch.empty if g.choices_shared else torch.zeros
    ch = alloc((T, c_words, s0, 128), dtype=torch.int32, device=dev)
    scratch = None
    if not g.regs_shared:
        scratch = _scratch((2 * T, nf, lanes), dev)
    cuda.launch(
        "interp_interval", w1, w2, imm, lengths, var_lo, var_hi, olo, ohi,
        ch, scratch, cuda.order_table(op_order, dev),
        T, L, nf, n_inputs, n_outputs, c_words, lanes, g.chunk,
        g.choices_shared, g.smem,
    )
    return olo, ohi, ch


def interp_interval_plain(
    w1, w2, imm, lengths, var_lo, var_hi, *, nf: int, n_inputs: int,
    n_outputs: int, s0: int, c_words: int, op_order: tuple | None = None,
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
            op, o, a, b, aux = _decode(
                int(w1h[t, j]), int(w2h[t, j]), op_order
            )
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


# ======================================================================
# grad mode (K4)


def interp_grad(
    w1, w2, imm, lengths, vars_, *, nf: int, n_inputs: int, n_outputs: int,
    s0: int, op_order: tuple | None = None,
):
    """Evaluates packed tapes with forward-mode duals.

    Args:
      vars_: [T, V, P, S0, 128] f32 dual planes: the value v and the
        first P - 1 (1 to 3) of the tangents dx, dy, dz. Each plane is
        computed as in the four-plane run, so the planes of a narrower
        run equal that run's first P planes bit for bit.
      op_order: the opcode renumbering the arena was packed with; None
        for the canonical order.
    Returns:
      [T, O, P, S0, 128] f32 dual outputs; 0 where the tape wrote none.
    """
    T, L = _check_arena(w1, w2, imm, lengths)
    P = vars_.shape[2] if vars_.dim() == 5 else 0
    if (not 2 <= P <= 4 or vars_.shape != (T, n_inputs, P, s0, 128)
            or vars_.dtype != torch.float32):
        raise ValueError(
            f"dual planes must be f32 [{T}, {n_inputs}, 2 to 4, {s0}, 128], "
            f"got {vars_.dtype} {tuple(vars_.shape)}"
        )
    if vars_.device.type == "cpu":
        return interp_grad_plain(
            w1, w2, imm, lengths, vars_, nf=nf, n_inputs=n_inputs,
            n_outputs=n_outputs, s0=s0, op_order=op_order,
        )
    cuda.check_cuda(w1, w2, imm, lengths, vars_)
    dev = vars_.device
    lanes = s0 * 128
    g = cuda.launch_geometry("interp_grad", nf=nf, lanes=lanes, T=T,
                             tangents=P - 1)
    scratch = None
    if not g.regs_shared:
        if P < 4:  # the global scratch is built for four planes alone
            return _as_four_planes(
                interp_grad, w1, w2, imm, lengths, vars_, nf=nf,
                n_inputs=n_inputs, n_outputs=n_outputs, s0=s0,
                op_order=op_order,
            )
        scratch = _scratch((T, P, nf, lanes), dev)
    out = torch.empty((T, n_outputs, P, s0, 128), dtype=torch.float32, device=dev)
    cuda.launch(
        "interp_grad", w1, w2, imm, lengths, vars_, out, scratch,
        cuda.order_table(op_order, dev),
        T, L, nf, n_inputs, n_outputs, lanes, g.r, P, g.chunk, g.smem,
    )
    return out


def _as_four_planes(fn, w1, w2, imm, lengths, vars_, **kw):
    """`fn` (`interp_grad` or its plain version) on duals of P < 4
    planes, run as four with the missing tangents 0: the first P planes
    of that run are the narrow run's, float for float."""
    P = vars_.shape[2]
    pad = vars_.new_zeros(vars_.shape[:2] + (4 - P,) + vars_.shape[3:])
    return fn(w1, w2, imm, lengths, torch.cat([vars_, pad], dim=2),
              **kw)[:, :, :P].contiguous()


def interp_grad_plain(
    w1, w2, imm, lengths, vars_, *, nf: int, n_inputs: int, n_outputs: int,
    s0: int, op_order: tuple | None = None,
):
    """Plain PyTorch version of `interp_grad` (same contract): GradMode
    walks four planes, the missing tangents 0, and the first P are
    returned."""
    if vars_.shape[2] < 4:
        return _as_four_planes(
            interp_grad_plain, w1, w2, imm, lengths, vars_, nf=nf,
            n_inputs=n_inputs, n_outputs=n_outputs, s0=s0, op_order=op_order,
        )
    T, L = w1.shape
    dev = vars_.device
    gm = GradMode(torch)
    out = torch.zeros(
        (T, n_outputs, 4, s0, 128), dtype=torch.float32, device=dev
    )
    w1h, w2h, immh, lensh = _host_tape(w1, w2, imm, lengths)
    for t in range(T):
        regs = torch.zeros((4, nf, s0, 128), dtype=torch.float32, device=dev)
        for j in range(min(int(lensh[t]), L)):
            op, o, a, b, aux = _decode(
                int(w1h[t, j]), int(w2h[t, j]), op_order
            )
            iv = float(immh[t, j])
            va = gm.const(iv, regs[:, 0]) if a == IMM12 else regs[:, min(a, nf - 1)]
            vb = gm.const(iv, regs[:, 0]) if b == IMM12 else regs[:, min(b, nf - 1)]
            op = TapeOp(op)
            if op == TapeOp.OUTPUT:
                out[t, min(aux, n_outputs - 1)] = torch.stack(tuple(va))
                r = va
            elif op == TapeOp.INPUT:
                r = vars_[t, min(aux, n_inputs - 1)]
            elif op == TapeOp.COPY:
                r = va
            elif op in CHOICE_TAPE_OPS:
                r = gm.choice_binary(op, tuple(va), tuple(vb))[0]
            elif op in _UNARY:
                r = gm.unary(op, tuple(va))
            else:
                r = gm.binary(op, tuple(va), tuple(vb))
            regs[:, min(o, nf - 1)] = torch.stack(tuple(r))
    return out


# ======================================================================
# float mode fused with the per-column voxel depth reduction (K5)


def interp_voxel_depth(
    w1, w2, imm, lengths, vars_, *, nf: int, n_inputs: int, s0: int,
    sub: int, op_order: tuple | None = None,
):
    """Float-evaluates packed tapes over one subtile's voxels and
    reduces to per-column local surface depths.

    Lanes are the subtile's voxels in (vz, vy, vx) row-major order
    (sub**3 == s0 * 128; sub**2 % 128 == 0). Returns int32
    [T, max(8, sub**2 / 128), 128]: column c = vy * sub + vx holds
    max over vz of (dist < 0 ? vz + 1 : 0), where dist is the tape's
    output (+1.0 if the tape writes none, so a length-0 instance is
    empty; a NaN distance is not inside). Padding planes are 0.
    `op_order` is the opcode renumbering the arena was packed with; None
    for the canonical order.
    """
    T, L = _check_arena(w1, w2, imm, lengths)
    _check_planes(vars_, T, n_inputs, s0)
    if (sub * sub) % 128 or sub**3 != s0 * 128:
        raise ValueError(f"sub={sub} needs sub^2 % 128 == 0 and sub^3 == s0*128")
    # integer depths carry no gradient (pallas_interp.py:482-490)
    vars_ = vars_.detach()
    if vars_.device.type == "cpu":
        return interp_voxel_depth_plain(
            w1, w2, imm, lengths, vars_, nf=nf, n_inputs=n_inputs, s0=s0,
            sub=sub, op_order=op_order,
        )
    cuda.check_cuda(w1, w2, imm, lengths, vars_)
    dev = vars_.device
    pp_out = max(8, (sub * sub) // 128)
    out = torch.empty((T, pp_out, 128), dtype=torch.int32, device=dev)
    g = cuda.launch_geometry(
        "interp_voxel_depth", nf=nf, lanes=s0 * 128, T=T, sub=sub
    )
    scratch = None
    if not g.regs_shared:  # one [nf][BLOCK * r] file a block
        scratch = _scratch((g.blocks, nf, cuda.BLOCK * g.r), dev)
    cuda.launch(
        "interp_voxel_depth", w1, w2, imm, lengths, vars_, out, scratch,
        cuda.order_table(op_order, dev),
        T, L, nf, n_inputs, sub, pp_out, g.r, g.cols, g.chunk, g.smem,
    )
    return out


def interp_voxel_depth_plain(
    w1, w2, imm, lengths, vars_, *, nf: int, n_inputs: int, s0: int,
    sub: int, op_order: tuple | None = None,
):
    """Plain PyTorch version of `interp_voxel_depth` (same contract)."""
    T, L = w1.shape
    dev = vars_.device
    pp = (sub * sub) // 128
    fm = FloatMode(torch)
    out = torch.zeros((T, max(8, pp), 128), dtype=torch.int32, device=dev)
    vz = torch.arange(1, sub + 1, dtype=torch.int32, device=dev)[:, None, None]
    w1h, w2h, immh, lensh = _host_tape(w1, w2, imm, lengths)
    for t in range(T):
        n = min(int(lensh[t]), L)
        if n <= 0:
            continue
        regs = torch.zeros((nf, s0, 128), dtype=torch.float32, device=dev)
        dist = torch.ones((s0, 128), dtype=torch.float32, device=dev)
        for j in range(n):
            op, o, a, b, aux = _decode(
                int(w1h[t, j]), int(w2h[t, j]), op_order
            )
            iv = float(immh[t, j])
            va = fm.const(iv, regs[0]) if a == IMM12 else regs[min(a, nf - 1)]
            vb = fm.const(iv, regs[0]) if b == IMM12 else regs[min(b, nf - 1)]
            op = TapeOp(op)
            if op == TapeOp.OUTPUT:
                dist = va.clone()
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
        inside = (dist < 0).reshape(sub, pp, 128)
        out[t, :pp] = torch.where(inside, vz, 0).amax(dim=0).to(torch.int32)
    return out


# ======================================================================
# float mode over one shared tape with per-tile action codes (K6)


def interp_float_coded(
    w1, w2, imm, lengths, codes, vars_, *, nf: int, n_inputs: int,
    n_outputs: int, s0: int,
):
    """Bulk float evaluation of ONE shared tape, specialized per tile by
    packed action codes instead of materialized child tapes.

    The 2-bit codes of the liveness pass (simplify_device.py) annotate
    every parent row per tile: 0 = skip, 1 = execute, 2/3 = execute as
    COPY from operand a/b, whatever the row's op. A skipped row costs
    the kernel no turn of its row loop. Registers start at 0, so the
    result is defined for any codes, not only for those of a liveness
    pass.

    Args:
      w1/w2/imm: [1, L] packed parent tape (canonical op order).
      lengths: [T] rows of the tape a tile walks; 0 disables a tile
        entirely (culled).
      codes: [T, LW] int32, 16 two-bit codes per word (LW >= L / 16).
      vars_: [T, V, S0, 128] f32 input planes.
    Returns:
      [T, O, S0, 128] f32 outputs; 0 where a tile wrote none.
    """
    T = vars_.shape[0]
    L = w1.shape[1]
    if w1.shape != (1, L) or w2.shape != (1, L) or imm.shape != (1, L):
        raise ValueError("the coded leaf takes one shared tape [1, L]")
    if lengths.shape != (T,) or codes.ndim != 2 or codes.shape[0] != T:
        raise ValueError("lengths must be [T] and codes [T, LW]")
    LW = codes.shape[1]
    if LW * 16 < L:
        raise ValueError(f"{LW} code words do not cover {L} tape rows")
    for t, dt in ((w1, torch.int32), (w2, torch.int32), (lengths, torch.int32),
                  (codes, torch.int32), (imm, torch.float32)):
        if t.dtype != dt:
            raise ValueError(f"arena dtype {t.dtype}, expected {dt}")
    _check_planes(vars_, T, n_inputs, s0)
    if _carries_gradient(vars_):
        raise ValueError(
            "interp_float_coded has no derivative (nor has the reference's "
            "K6): differentiate a frame without leaf_coded"
        )
    if vars_.device.type == "cpu":
        return interp_float_coded_plain(
            w1, w2, imm, lengths, codes, vars_, nf=nf, n_inputs=n_inputs,
            n_outputs=n_outputs, s0=s0,
        )
    cuda.check_cuda(w1, w2, imm, lengths, codes, vars_)
    lanes = s0 * 128
    out = torch.empty(
        (T, n_outputs, s0, 128), dtype=torch.float32, device=vars_.device
    )
    g = cuda.launch_geometry("interp_float_coded", nf=nf, lanes=lanes, T=T)
    scratch = None
    if not g.regs_shared:
        scratch = _scratch((T, nf, lanes), vars_.device)
    cuda.launch(
        "interp_float_coded", w1, w2, imm, lengths, codes, vars_, out,
        scratch, T, L, LW, nf, n_inputs, n_outputs, lanes, g.r, g.chunk,
        g.smem,
    )
    return out


def interp_float_coded_plain(
    w1, w2, imm, lengths, codes, vars_, *, nf: int, n_inputs: int,
    n_outputs: int, s0: int,
):
    """Plain PyTorch version of `interp_float_coded` (same contract):
    walks the shared tape on the host and applies each row only to the
    tiles whose code for it is non-zero."""
    T = vars_.shape[0]
    L = w1.shape[1]
    dev = vars_.device
    fm = FloatMode(torch)
    out = torch.zeros((T, n_outputs, s0, 128), dtype=torch.float32, device=dev)
    regs = torch.zeros((T, nf, s0, 128), dtype=torch.float32, device=dev)
    w1h, w2h, immh, lensh = _host_tape(w1, w2, imm, lengths)
    words = codes.detach().cpu().numpy()
    idx = np.arange(L)
    codes_h = (words[:, idx // 16] >> ((idx % 16) * 2)) & 3  # [T, L]
    codes_h = np.where(idx[None, :] < lensh[:, None], codes_h, 0)
    for j in np.nonzero(codes_h.any(axis=0))[0]:
        op, o, a, b, aux = _decode(int(w1h[0, j]), int(w2h[0, j]))
        iv = float(immh[0, j])
        oc = min(o, nf - 1)
        for code in (1, 2, 3):
            tiles = np.nonzero(codes_h[:, j] == code)[0]
            if tiles.size == 0:
                continue
            ti = torch.from_numpy(tiles).to(dev)
            # codes 2/3: the row runs as COPY from operand a/b
            src = b if code == 3 else a
            if src == IMM12:
                va = fm.const(iv, regs[ti, 0])
            else:
                va = regs[ti, min(src, nf - 1)]
            top = TapeOp.COPY if code > 1 else TapeOp(op)
            if top == TapeOp.OUTPUT:
                out[ti, min(aux, n_outputs - 1)] = va
                r = va
            elif top == TapeOp.INPUT:
                r = vars_[ti, min(aux, n_inputs - 1)]
            elif top == TapeOp.COPY:
                r = va
            elif top in _UNARY:
                r = fm.unary(top, va)
            else:
                if b == IMM12:
                    vb = fm.const(iv, regs[ti, 0])
                else:
                    vb = regs[ti, min(b, nf - 1)]
                if top in CHOICE_TAPE_OPS:
                    r = fm.choice_binary(top, va, vb)[0]
                else:
                    r = fm.binary(top, va, vb)
            regs[ti, oc] = r
    return out
