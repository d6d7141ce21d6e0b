"""Does interleaving two independent tape streams in one instance hide
the interpreter's serial row latency? The port of the Pallas probe
demos/exp_interleave.py (P2).

Variant A: `interp_float` (K3), one tape an instance, on T instances.
Variant B: `interp_float2` (csrc/interleave.cu), two tapes and two
register files an instance, on T / 2 instances: on the card each
stream of an instance is a block of its own, and rows of the classes in
`ROW_CLASSES` take one branch and no opcode switch. Same total work: T
x L rows each. If a row's cost is the latency of its dependent chain, B
approaches 2x; if it is fetch, decode and dispatch, B stays near 1x.

Run on a CUDA card from the repository root:

    python -m fidget_tpu_torch.demos.exp_interleave
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..compiler.pack import IMM12
from ..compiler.tape import CHOICE_TAPE_OPS, TapeOp
from ..eval import cuda
from ..eval.arith import FloatMode
from ..eval.interp import N_OPS, _UNARY, _scratch, interp_float

#: the reference's arguments (demos/exp_interleave.py `main`)
T_REF, L_REF, NF_REF, S0_REF, V_REF = 256, 1024, 32, 32, 1

#: flags of a decoded row's control word (csrc/interleave.cu): the row
#: goes to the opcode switch, or takes one branch to the compare/select
#: of MIN (of MAX) or to the arithmetic, the product or the sum, with
#: b's operand read from a's (COPY, OUTPUT) or its sign flipped (SUB)
C_SWITCH, C_MUL, C_MINMAX, C_MAX, C_ALIAS = 1, 2, 4, 8, 16
C_SIGN = -(2**31)
#: the control word of each opcode 0-30, which the kernel's decode step
#: reads; COPY and OUTPUT (which writes no plane here) are MIN of a with
#: itself
ROW_CLASSES = tuple(
    {
        TapeOp.ADD: 0,
        TapeOp.SUB: C_SIGN,
        TapeOp.MUL: C_MUL,
        TapeOp.MIN: C_MINMAX,
        TapeOp.MAX: C_MINMAX | C_MAX,
        TapeOp.COPY: C_MINMAX | C_ALIAS,
        TapeOp.OUTPUT: C_MINMAX | C_ALIAS,
    }.get(TapeOp(op), C_SWITCH)
    for op in range(N_OPS)
)
_CLASS_TABLES: dict = {}


def class_table(device) -> torch.Tensor:
    """`ROW_CLASSES` as an int32 tensor on `device`, made once."""
    key = str(device)
    if key not in _CLASS_TABLES:
        _CLASS_TABLES[key] = torch.tensor(ROW_CLASSES, dtype=torch.int32,
                                          device=device)
    return _CLASS_TABLES[key]


def random_tape(L, nf, rng):
    """Random arithmetic tape over nf registers (no outputs needed):
    the reference's `random_tape`, the same words for the same
    generator state."""
    ops = rng.choice(
        [int(TapeOp.ADD), int(TapeOp.SUB), int(TapeOp.MUL),
         int(TapeOp.MAX), int(TapeOp.MIN)],
        size=L,
    )
    out = rng.integers(0, nf, L)
    a = rng.integers(0, nf, L)
    b = rng.integers(0, nf, L)
    aux = np.zeros(L, np.int64)
    w1 = ops | (out << 7) | (a << 19)
    w2 = b | (aux << 12)
    return w1.astype(np.int32), w2.astype(np.int32)


def _check(w1a, w2a, imma, w1b, w2b, immb, lens, vars_, s0):
    T, L = w1a.shape
    for t, dt in ((w1a, torch.int32), (w2a, torch.int32),
                  (imma, torch.float32), (w1b, torch.int32),
                  (w2b, torch.int32), (immb, torch.float32)):
        if t.shape != (T, L) or t.dtype != dt:
            raise ValueError("tapes must be w1/w2 int32 and imm float32, "
                             "all [T, Lcap]")
    if lens.shape != (T,) or lens.dtype != torch.int32:
        raise ValueError("lens must be int32 [T]")
    if (vars_.dim() != 4 or vars_.shape[0] != T or vars_.shape[1] < 1
            or vars_.shape[2:] != (s0, 128) or vars_.dtype != torch.float32):
        raise ValueError(f"vars_ must be float32 [T, V >= 1, {s0}, 128]")
    return T, L


def interp_float2(w1a, w2a, imma, w1b, w2b, immb, lens, vars_, *, nf, s0,
                  lanes_per_thread=0):
    """Two-stream interpreter: instance i runs tapes a[i] and b[i], each
    with its own register file, over the lanes of vars_[i].

    Every instance walks all Lcap rows of both tapes: `lens` is taken
    and not read, as the reference's kernel is handed lengths of Lcap
    whatever its caller passes. Operands read the row's immediate where
    they are IMM12, else register min(r, nf - 1); INPUT reads
    vars_[i, min(aux, V - 1)] in both streams; OUTPUT and COPY write
    `a` to the row's register; an opcode past 30 acts as ATAN. Both
    register files start at 0 and writes clamp to nf - 1.

    Args:
      w1a/w2a/imma, w1b/w2b/immb: [T, Lcap] packed tapes of the two
        streams (compiler/pack.py words).
      lens: [T] int32, unused.
      vars_: [T, V, S0, 128] f32 input planes.
      lanes_per_thread: the kernel's lanes a thread (4, 2 or 1); 0 lets
        `cuda.launch_geometry` choose. The plain version ignores it.
    Returns:
      [T, 2, S0, 128] f32: register 0 of each stream after the walk.
    On CUDA tensors it launches csrc/interleave.cu; on CPU tensors it
    runs `interp_float2_plain`.
    """
    T, L = _check(w1a, w2a, imma, w1b, w2b, immb, lens, vars_, s0)
    if vars_.device.type == "cpu":
        return interp_float2_plain(w1a, w2a, imma, w1b, w2b, immb, lens,
                                   vars_, nf=nf, s0=s0)
    cuda.check_cuda(w1a, w2a, imma, w1b, w2b, immb, vars_)
    lanes = s0 * 128
    g = cuda.launch_geometry("interp_float2", nf=nf, lanes=lanes, T=T,
                             r=lanes_per_thread)
    out = torch.empty((T, 2, s0, 128), dtype=torch.float32,
                      device=vars_.device)
    scratch = None
    if not g.regs_shared:
        scratch = _scratch((T, 2 * nf, lanes), vars_.device)
    cuda.launch("interp_float2", w1a, w2a, imma, w1b, w2b, immb,
                class_table(vars_.device), vars_, out, scratch, T, L, nf,
                vars_.shape[1], lanes, g.r, g.chunk, g.smem)
    return out


def interp_float2_plain(w1a, w2a, imma, w1b, w2b, immb, lens, vars_, *, nf,
                        s0):
    """Plain PyTorch version of `interp_float2` (same contract), on any
    device: each stream walks its rows over all instances at once, one
    row a step, with the arithmetic of eval/arith.py."""
    _check(w1a, w2a, imma, w1b, w2b, immb, lens, vars_, s0)
    fm = FloatMode(torch)
    return torch.stack([_stream_plain(w1a, w2a, imma, vars_, nf, fm),
                        _stream_plain(w1b, w2b, immb, vars_, nf, fm)], dim=1)


def _stream_plain(w1, w2, imm, vars_, nf, fm):
    """Register 0 after one stream's walk, [T, S0, 128]."""
    T, L = w1.shape
    dev = vars_.device
    V = vars_.shape[1]
    w1h = w1.detach().cpu().numpy().astype(np.int64)
    w2h = w2.detach().cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    op = w1h & 127
    op = np.where(op >= N_OPS, int(TapeOp.ATAN), op)
    a, b = (w1h >> 19) & 0xFFF, w2h & 0xFFF
    on = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    op_d = on(op)
    a_reg, b_reg = on(np.minimum(a, nf - 1)), on(np.minimum(b, nf - 1))
    a_imm, b_imm = on(a == IMM12), on(b == IMM12)
    out_reg = on(np.minimum((w1h >> 7) & 0xFFF, nf - 1))
    aux = on(np.minimum(w2h >> 12, V - 1))
    idx = torch.arange(T, device=dev)
    regs = torch.zeros((T, nf) + tuple(vars_.shape[2:]), dtype=torch.float32,
                       device=dev)
    for j in range(L):
        iv = imm[:, j, None, None]
        va = torch.where(a_imm[:, j, None, None], iv, regs[idx, a_reg[:, j]])
        vb = torch.where(b_imm[:, j, None, None], iv, regs[idx, b_reg[:, j]])
        r = None
        for u in np.unique(op[:, j]):
            v = _row_value(fm, TapeOp(int(u)), va, vb,
                           lambda: vars_[idx, aux[:, j]])
            r = v if r is None else torch.where(
                (op_d[:, j] == int(u))[:, None, None], v, r)
        regs[idx, out_reg[:, j]] = r
    return regs[:, 0]


def _row_value(fm, op, va, vb, read_input):
    if op in (TapeOp.OUTPUT, TapeOp.COPY):
        return va
    if op == TapeOp.INPUT:
        return read_input()
    if op in CHOICE_TAPE_OPS:
        return fm.choice_binary(op, va, vb)[0]
    if op in _UNARY:
        return fm.unary(op, va)
    return fm.binary(op, va, vb)


def reference_inputs(device, T=T_REF, L=L_REF, nf=NF_REF, s0=S0_REF,
                     V=V_REF, seed=0):
    """The reference's inputs: T `random_tape`s drawn in turn from one
    generator, zero immediates, lengths L and normal input planes, as
    tensors on `device` ((w1, w2, imm, lens, vars_))."""
    rng = np.random.default_rng(seed)
    w1 = np.zeros((T, L), np.int32)
    w2 = np.zeros((T, L), np.int32)
    for i in range(T):
        w1[i], w2[i] = random_tape(L, nf, rng)
    imm = np.zeros((T, L), np.float32)
    lens = np.full(T, L, np.int32)
    vars_ = rng.normal(size=(T, V, s0, 128)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (w1, w2, imm, lens, vars_))


def split_streams(w1, w2, imm, lens, vars_):
    """Variant B's arguments from variant A's: the first half of the
    tapes as stream a, the second as stream b, on the first half's
    instances."""
    h = w1.shape[0] // 2
    return ((w1[:h], w2[:h], imm[:h], w1[h:2 * h], w2[h:2 * h],
             imm[h:2 * h], lens[:h], vars_[:h]))


def best_ms(fn, dev, reps=3):
    """The fastest of `reps` calls of fn after a warm one, in ms: by CUDA
    events on a card, by the host clock on the CPU (the reference's
    `bench` takes the fastest of 3 too)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            best = min(best, t0.elapsed_time(t1))
        else:
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def main(device=None, T=T_REF, L=L_REF, nf=NF_REF, s0=S0_REF, V=V_REF,
         reps=3, seed=0):
    """Times variant A (K3 on T instances) against variant B (P2 on
    T / 2) on the reference's inputs and prints the reference's two
    lines, B at the lanes a thread `cuda.launch_geometry` gives it; then
    B at A's lanes a thread where that differs (fewer blocks an SM, the
    same lanes per row a thread). Returns {"ms_a", "ms_b", "ns_a",
    "ns_b", "speedup", "geometry_a", "geometry_b", "b_at_a_lanes"} (ns
    per row of the T x L; "b_at_a_lanes" None or {"ms", "ns",
    "speedup", "geometry"})."""
    dev = cuda.resolve_device(device)
    w1, w2, imm, lens, vars_ = reference_inputs(dev, T, L, nf, s0, V, seed)
    args_b = split_streams(w1, w2, imm, lens, vars_)
    lanes = s0 * 128
    geo_a = cuda.launch_geometry("interp_float", nf=nf, lanes=lanes, T=T)
    geo_b = cuda.launch_geometry("interp_float2", nf=nf, lanes=lanes,
                                 T=T // 2)
    ms_a = best_ms(lambda: interp_float(
        w1, w2, imm, lens, vars_, nf=nf, n_inputs=V, n_outputs=1, s0=s0),
        dev, reps)
    ms_b = best_ms(lambda: interp_float2(*args_b, nf=nf, s0=s0), dev, reps)
    steps = T * L
    res = {
        "ms_a": ms_a, "ms_b": ms_b, "ns_a": ms_a / steps * 1e6,
        "ns_b": ms_b / steps * 1e6, "speedup": ms_a / ms_b,
        "geometry_a": geo_a, "geometry_b": geo_b, "b_at_a_lanes": None,
    }
    print(f"A (1 stream/inst): {ms_a:7.4f} ms  {res['ns_a']:6.3f} ns/step",
          flush=True)
    print(f"B (2 streams/inst): {ms_b:7.4f} ms  {res['ns_b']:6.3f} "
          f"ns/step-equiv  speedup x{res['speedup']:.2f}", flush=True)
    if geo_b.r != geo_a.r:
        geo = cuda.launch_geometry("interp_float2", nf=nf, lanes=lanes,
                                   T=T // 2, r=geo_a.r)
        ms = best_ms(lambda: interp_float2(
            *args_b, nf=nf, s0=s0, lanes_per_thread=geo_a.r), dev, reps)
        res["b_at_a_lanes"] = {"ms": ms, "ns": ms / steps * 1e6,
                               "speedup": ms_a / ms, "geometry": geo}
        print(f"B at A's {geo_a.r} lanes a thread: {ms:7.4f} ms  "
              f"{ms / steps * 1e6:6.3f} ns/step-equiv  speedup "
              f"x{ms_a / ms:.2f}", flush=True)
    for label, g in (("A", geo_a), ("B", geo_b)):
        print(f"{label}: {g.r} lanes a thread, {g.blocks} blocks of "
              f"{g.smem} shared bytes", flush=True)
    return res


if __name__ == "__main__":
    main()
