"""The ports of the Pallas probes P2 (`fidget_tpu_torch.demos.
exp_interleave`, two tape streams an instance) and P3
(`fidget_tpu_torch.demos.exp_grid_overhead`, the fixed cost of a grid
step) against the reference's, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions to the reference: P2 to
`demos/exp_interleave.py`'s `interp_float2`, loaded from its file and
run with `pallas_call(interpret=True)` (patched for the test's duration
only; nothing in `demos/` changes), P3 to the kernel body of
`demos/exp_grid_overhead.py`'s `build`, restated here because `build`
is local to that file's `main()`. The CUDA kernels are held to the same
plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import functools
import importlib.util
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from fidget_tpu.eval.arith import FloatMode as RefFloatMode

from fidget_tpu_torch.compiler.pack import IMM12
from fidget_tpu_torch.compiler.tape import TapeOp
from fidget_tpu_torch.demos import exp_grid_overhead as p3
from fidget_tpu_torch.demos import exp_interleave as p2
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.scenes import (
    SPICY,
    interleave_op_arena,
    mixed_class_tapes,
    prefixed_random_tapes,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: ops IEEE f32 rounds correctly on both sides: equal bit for bit
EXACT = {
    "OUTPUT", "INPUT", "COPY", "NEG", "ABS", "SQUARE", "SQRT", "RECIP",
    "FLOOR", "CEIL", "ROUND", "NOT", "ADD", "SUB", "MUL", "DIV", "MIN",
    "MAX", "AND", "OR", "MOD", "COMPARE",
}
#: ops whose reference kernel uses the polynomials of
#: fidget_tpu/eval/softmath.py, which lose the sign of zero (MOD of -0,
#: ATAN2 of a signed zero): the port, which uses native ones, is held
#: to the reference's host arithmetic over numpy instead, as
#: tests/test_torch_kernels.py holds its op matrix
HOST_HELD = {"MOD", "ATAN2"}


@pytest.fixture(scope="module")
def ref_p2():
    spec = importlib.util.spec_from_file_location(
        "ref_exp_interleave", ROOT / "demos" / "exp_interleave.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpret(monkeypatch):
    """Every `pallas_call` of the test in interpret mode."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ref_float2(ref_p2, w1a, w2a, imma, w1b, w2b, immb, lens, vars_, nf, s0):
    out = ref_p2.interp_float2(
        *(jnp.asarray(a) for a in (w1a, w2a, imma, w1b, w2b, immb, lens,
                                   vars_)), nf=nf, s0=s0)
    return np.asarray(out)


def _port_float2(w1a, w2a, imma, w1b, w2b, immb, lens, vars_, nf, s0):
    return p2.interp_float2(
        *_tensors(w1a, w2a, imma, w1b, w2b, immb, lens, vars_), nf=nf,
        s0=s0).numpy()


def _bit_equal(got, want):
    return (got.view(np.int32) == want.view(np.int32)) | (
        np.isnan(got) & np.isnan(want))


# ----------------------------------------------------------------------
# P2: two interleaved tape streams


@pytest.mark.parametrize("L,nf,seed", [(1024, 32, 0), (37, 5, 3), (1, 1, 9)])
def test_random_tape_matches_reference_word_for_word(ref_p2, L, nf, seed):
    """Three tapes in turn from one generator: the same words, and the
    generators left in the same state."""
    mine, theirs = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        a, b = p2.random_tape(L, nf, mine), ref_p2.random_tape(L, nf, theirs)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype == np.int32
            np.testing.assert_array_equal(x, y)
    assert mine.integers(0, 2**31) == theirs.integers(0, 2**31)


@pytest.mark.parametrize("seed", [0, 1])
def test_interleave_random_tapes_match_reference(ref_p2, interpret, seed):
    """`random_tape`s behind INPUT rows (`prefixed_random_tapes`: no row
    reads a register the walk has not written, as the reference's files
    start unset) through both streams: bit-equal."""
    T, L, nf, V, s0 = 6, 40, 6, 2, 1
    w1, w2, imm, rng = prefixed_random_tapes(2 * T, L, nf, V, seed)
    vars_ = rng.normal(size=(T, V, s0, 128)).astype(np.float32)
    lens = np.full(T, nf + L, np.int32)
    args = (w1[:T], w2[:T], imm[:T], w1[T:], w2[T:], imm[T:], lens, vars_)
    got = _port_float2(*args, nf, s0)
    want = _ref_float2(ref_p2, *args, nf, s0)
    assert got.shape == want.shape == (T, 2, s0, 128)
    assert np.isfinite(want).any()
    assert _bit_equal(got, want).all()


def _tolerance(name):
    if name in EXACT:
        return 0.0
    return 2e-4 if name in ("EXP", "LN") else 2e-5


def test_interleave_op_tapes_match_reference(ref_p2, interpret):
    """One op row per opcode 0-30 and 31, 40, 127 over INPUT-loaded
    registers, as register and immediate operands, with INPUT's aux past
    V: the ops IEEE rounds correctly bit-equal, the others within
    tests/test_torch_kernels.py's tolerances (2e-5, EXP and LN 2e-4),
    MOD and ATAN2 held to the reference's numpy arithmetic (HOST_HELD);
    an opcode past 30 gives ATAN's result bit for bit."""
    s0, nf, V = 8, 8, 3
    w1a, w2a, imma, w1b, w2b, immb, vars_, labels = interleave_op_arena(
        s0, nf, V)
    T, L = w1a.shape
    lens = np.full(T, L, np.int32)
    args = (w1a, w2a, imma, w1b, w2b, immb, lens, vars_)
    got = _port_float2(*args, nf, s0)
    want = _ref_float2(ref_p2, *args, nf, s0)
    n = len(SPICY) ** 2
    regs = np.zeros((nf, s0 * 128), np.float32)
    for k in range(nf):
        regs[k] = vars_[0, min(k, V - 1)].reshape(-1)
    fm = RefFloatMode(np)
    atan = {}
    for (t, s), (op, variant) in sorted(labels.items()):
        name = TapeOp(min(op, 30)).name
        g = got[t, s].reshape(-1)[:n]
        w = want[t, s].reshape(-1)[:n]
        if name in HOST_HELD and op < 31:
            w1 = w1a if s == 0 else w1b
            w2 = w2a if s == 0 else w2b
            a, b = (int(w1[t, nf]) >> 19) & 0xFFF, int(w2[t, nf]) & 0xFFF
            iv = (imma if s == 0 else immb)[t, nf]
            va = np.full(n, iv, np.float32) if a == IMM12 else regs[a][:n]
            vb = np.full(n, iv, np.float32) if b == IMM12 else regs[b][:n]
            with np.errstate(all="ignore"):
                w = fm.binary(TapeOp(op), va, vb).astype(np.float32)
        tol = _tolerance(name)
        ok = _bit_equal(g, w)
        if tol:
            with np.errstate(invalid="ignore"):
                ok |= np.abs(g - w) <= tol + tol * np.abs(w)
        bad = np.nonzero(~ok)[0]
        assert bad.size == 0, (op, name, variant, bad[:5], g[bad[:5]],
                               w[bad[:5]])
        if name == "ATAN":
            atan.setdefault(variant, g)
            assert _bit_equal(g, atan[variant]).all(), (op, variant)
    assert len(atan) == 4


#: the opcodes the kernel computes with no switch, named independently of
#: `p2.ROW_CLASSES`
CLASSED = {"ADD", "SUB", "MUL", "MIN", "MAX", "COPY", "OUTPUT"}
#: operand values of the signed-zero and NaN cases: both zeros, NaNs of
#: both signs, infinities and ones (no denormals: XLA on the CPU flushes
#: them to zero, where the port and the card keep them)
SIGNED = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.0, -1.0],
                  np.float32)
DENORMALS = np.array([1e-40, -1e-40, 1.4e-45], np.float32)


def _classed_mirror(c, a, b):
    """A classed row of csrc/interleave.cu (`run_row2`) over numpy f32
    arrays: the compare/select of MIN (MAX: b < a), or the product, or
    the sum with b's sign flipped by C_SIGN, as the control word's flags
    say."""
    flip = np.uint32(c & 0xFFFFFFFF) & np.uint32(0x80000000)
    with np.errstate(all="ignore"):
        total = a + (b.view(np.uint32) ^ flip).view(np.float32)
        prod = a * b
        left = (b < a) if c & p2.C_MAX else (a < b)
    pick = np.where(left | np.isnan(a), a, b)
    if c & p2.C_MINMAX:
        return pick
    return prod if c & p2.C_MUL else total


def _decoded_class(w1):
    """The decode step's control words of packed rows: the opcode (past
    30: ATAN) looked up in `ROW_CLASSES`."""
    op = np.asarray(w1).astype(np.int64) & 127
    op = np.where(op >= len(p2.ROW_CLASSES), int(TapeOp.ATAN), op)
    return op, np.asarray(p2.ROW_CLASSES, np.int64)[op]


def _op_value(op, a, b):
    """The reference's host arithmetic of one classed opcode."""
    fm = RefFloatMode(np)
    with np.errstate(all="ignore"):
        if op in (TapeOp.COPY, TapeOp.OUTPUT):
            return a
        if op in (TapeOp.MIN, TapeOp.MAX):
            return fm.choice_binary(op, a, b)[0].astype(np.float32)
        return fm.binary(op, a, b).astype(np.float32)


def _tapes_of(source):
    if source == "random_tape":
        w1, _, _, _, _ = p2.reference_inputs("cpu", T=8, L=1024, nf=32, s0=1)
        return w1.numpy()
    w1a, _, _, w1b, _, _, _, _ = interleave_op_arena(8, past_nf=True)
    return np.concatenate([w1a, w1b])


@pytest.mark.parametrize("source", ["random_tape", "op_arena"])
def test_row_classes_match_each_opcode(source):
    """The class table the decode step reads (`ROW_CLASSES`) against the
    opcode of every row of the reference's `random_tape`s and of the op
    arena: a row is classed exactly when its opcode is one of CLASSED,
    every other row goes to the switch with no other flag, and the
    classed body (`_classed_mirror`, b read from a's operand where the
    word says C_ALIAS) gives the opcode's value bit for bit on every
    pair of SPICY, SIGNED and DENORMALS values. Every row of a
    `random_tape` is classed."""
    op, c = _decoded_class(_tapes_of(source))
    vals = np.concatenate([SPICY, SIGNED, DENORMALS])
    a, b = np.repeat(vals, len(vals)), np.tile(vals, len(vals))
    for o in np.unique(op):
        name = TapeOp(int(o)).name
        cls = int(c[op == o][0])
        assert (c[op == o] == cls).all()
        if name not in CLASSED:
            assert cls == p2.C_SWITCH, name
            continue
        assert not cls & p2.C_SWITCH, name
        bb = a if cls & p2.C_ALIAS else b
        got = _classed_mirror(cls, a, bb)
        want = _op_value(TapeOp(int(o)), a, b)
        assert _bit_equal(got, want).all(), (name, a[~_bit_equal(got, want)])
    if source == "random_tape":
        assert not (c & p2.C_SWITCH).any()
    else:
        assert {TapeOp(int(o)).name for o in np.unique(op)} >= CLASSED


def _signed_arena(op):
    """Two-stream tapes of one classed op over SIGNED pairs: register k
    loads input k, then the op runs into register 5 on (reg 1, reg 2),
    (reg 2, reg 1), (reg 1, reg 1) and against immediates -0.0, +0.0 and
    NaN on either side, one variant a stream, and COPY moves register 5
    to register 0. Returns (args as numpy, nf, s0, variants)."""
    nf, V, s0 = 6, 3, 1
    n = len(SIGNED)
    variants = [(1, 2, 0.0), (2, 1, 0.0), (1, 1, 0.0), (1, None, -0.0),
                (None, 2, -0.0), (1, None, 0.0), (None, 1, 0.0),
                (1, None, np.nan)]
    word = lambda o, out, a, b, aux=0: (int(o) | (out << 7) | (a << 19),
                                        b | (aux << 12))
    rows = []
    for a, b, _ in variants:
        pre = [word(TapeOp.INPUT, k, 0, 0, k) for k in range(nf)]
        rows.append(pre + [word(op, 5, IMM12 if a is None else a,
                                IMM12 if b is None else b),
                           word(TapeOp.COPY, 0, 5, 0)])
    w1 = np.array([[r[0] for r in t] for t in rows], np.int32)
    w2 = np.array([[r[1] for r in t] for t in rows], np.int32)
    imm = np.zeros(w1.shape, np.float32)
    imm[:, nf] = [iv for _, _, iv in variants]
    T = len(variants) // 2
    vars_ = np.zeros((T, V, s0 * 128), np.float32)
    vars_[:, 0] = np.linspace(-1.0, 1.0, s0 * 128, dtype=np.float32)
    vars_[:, 1, :n * n] = np.repeat(SIGNED, n)
    vars_[:, 2, :n * n] = np.tile(SIGNED, n)
    lens = np.full(T, w1.shape[1], np.int32)
    args = (w1[0::2], w2[0::2], imm[0::2], w1[1::2], w2[1::2], imm[1::2],
            lens, vars_.reshape(T, V, s0, 128))
    return args, nf, s0, variants


@pytest.mark.parametrize("op", ["ADD", "SUB", "MIN", "MAX"])
def test_interleave_signed_zeros_and_nan_match_reference(ref_p2, interpret,
                                                         op):
    """The classed ops with both zeros, NaNs of both signs, infinities
    and ones as register operands, and -0.0, +0.0 and NaN as
    immediates on either side: the port bit for bit to the reference's
    `interp_float2` in interpret mode (any NaN for any NaN), and to the
    classed body's mirror on the same operands."""
    args, nf, s0, variants = _signed_arena(TapeOp[op])
    got = _port_float2(*args, nf, s0)
    want = _ref_float2(ref_p2, *args, nf, s0)
    n = len(SIGNED)
    assert _bit_equal(got, want).all()
    cls = p2.ROW_CLASSES[int(TapeOp[op])]
    regs = np.stack([np.repeat(SIGNED, n), np.tile(SIGNED, n)])
    for i, (a, b, iv) in enumerate(variants):
        va = np.full(n * n, iv, np.float32) if a is None else regs[a - 1]
        vb = np.full(n * n, iv, np.float32) if b is None else regs[b - 1]
        mirror = _classed_mirror(cls, va, vb)
        out = got[i // 2, i % 2].reshape(-1)[:n * n]
        assert _bit_equal(out, mirror).all(), (op, a, b, iv)


def test_mixed_class_tapes_mix_classes_in_every_chunk():
    """`mixed_class_tapes` puts classed and switch rows in every whole
    chunk of the kernel's ring, reads immediates and registers past nf, and
    leaves most lanes finite after a walk of the plain version."""
    T, L, nf, V = 4, 3 * cuda.INTERLEAVE_CHUNK + 1, 8, 3
    w1, w2, imm, rng = mixed_class_tapes(2 * T, L, nf, V, 3)
    _, c = _decoded_class(w1)
    switch = (c & p2.C_SWITCH) != 0
    chunk = cuda.INTERLEAVE_CHUNK
    for j0 in range(0, w1.shape[1] - chunk + 1, chunk):
        part = switch[:, j0:j0 + chunk]
        assert part.any(axis=1).all() and (~part).any(axis=1).all()
    assert ((w1 >> 19) & 0xFFF == IMM12).any()
    assert ((w1 >> 7) & 0xFFF >= nf).any()
    vars_ = rng.normal(size=(T, V, 1, 128)).astype(np.float32)
    out = _port_float2(w1[:T], w2[:T], imm[:T], w1[T:], w2[T:], imm[T:],
                       np.full(T, nf + L, np.int32), vars_, nf, 1)
    assert np.isfinite(out).mean() > 0.2


def test_interleave_ignores_lens(ref_p2, interpret):
    """Every instance walks all Lcap rows whatever `lens` says, in the
    reference and in the port."""
    T, L, nf, V, s0 = 4, 24, 4, 2, 1
    w1, w2, imm, rng = prefixed_random_tapes(2 * T, L, nf, V, 5)
    vars_ = rng.normal(size=(T, V, s0, 128)).astype(np.float32)
    full = np.full(T, nf + L, np.int32)
    short = np.array([0, 1, nf, nf + L - 1], np.int32)
    args = (w1[:T], w2[:T], imm[:T], w1[T:], w2[T:], imm[T:])
    got_full = _port_float2(*args, full, vars_, nf, s0)
    got_short = _port_float2(*args, short, vars_, nf, s0)
    want_short = _ref_float2(ref_p2, *args, short, vars_, nf, s0)
    assert _bit_equal(got_short, got_full).all()
    assert _bit_equal(got_short, want_short).all()


def test_interleave_registers_start_at_zero():
    """The reference's own tapes read registers before writing them and
    start from unset files; the port's files start at 0, so the
    reference's arguments give 0 everywhere (kernel and plain version
    alike; tests/test_torch_cuda.py)."""
    args = p2.split_streams(*p2.reference_inputs("cpu", T=4, L=64, nf=8,
                                                 s0=1, V=1))
    out = p2.interp_float2(*args, nf=8, s0=1)
    assert out.shape == (2, 2, 1, 128)
    assert torch.equal(out, torch.zeros_like(out))


def test_interleave_clamps_registers_past_nf():
    """Register reads and writes past nf - 1 land on register nf - 1 (the
    reference writes out of bounds; the arena's last instance)."""
    s0, nf, V = 8, 8, 3
    w1a, w2a, imma, w1b, w2b, immb, vars_, labels = interleave_op_arena(
        s0, nf, V, past_nf=True)
    T, L = w1a.shape
    out = _port_float2(w1a, w2a, imma, w1b, w2b, immb,
                       np.full(T, L, np.int32), vars_, nf, s0)[T - 1]
    x1 = vars_[T - 1, 1].reshape(-1)
    x2 = vars_[T - 1, 2].reshape(-1)
    last = vars_[T - 1, V - 1].reshape(-1)  # register nf - 1 after the loads
    with np.errstate(all="ignore"):
        assert _bit_equal(out[0].reshape(-1), x1 + last).all()
        assert _bit_equal(out[1].reshape(-1), (x1 + x2) * (x1 + x2)).all()


def test_interleave_rejects_bad_arguments():
    args = list(p2.split_streams(*p2.reference_inputs(
        "cpu", T=4, L=8, nf=4, s0=1, V=1)))
    args[2] = args[2].double()
    with pytest.raises(ValueError):
        p2.interp_float2(*args, nf=4, s0=1)
    args = list(p2.split_streams(*p2.reference_inputs(
        "cpu", T=4, L=8, nf=4, s0=1, V=1)))
    with pytest.raises(ValueError):
        p2.interp_float2(*args, nf=4, s0=2)


def test_interleave_launch_geometry():
    """A block a stream, laid out as K3 lays out an instance but with an
    INTERLEAVE_CHUNK-row ring: at the reference's shapes (T / 2 = 128
    instances, nf 32, S0 32) four lanes a thread, variant A's lanes and
    blocks on twice the instances, three blocks an SM where A holds two;
    a file no block holds goes to the global scratch."""
    g = cuda.launch_geometry("interp_float2", nf=32, lanes=32 * 128, T=128)
    ring = cuda.tape_ring_bytes(cuda.INTERLEAVE_CHUNK)
    assert (g.r, g.chunk, g.regs_shared, g.blocks) == (
        4, cuda.INTERLEAVE_CHUNK, True, 2048)
    assert g.smem == ring + 32 * cuda.BLOCK * 4 * 4
    assert 3 * (g.smem + cuda.SMEM_BLOCK_RESERVED) <= cuda.SMEM_SM
    a = cuda.launch_geometry("interp_float", nf=32, lanes=32 * 128, T=256)
    assert (a.r, a.blocks) == (g.r, g.blocks)
    assert 3 * (a.smem + cuda.SMEM_BLOCK_RESERVED) > cuda.SMEM_SM
    g = cuda.launch_geometry("interp_float2", nf=512, lanes=1024, T=4)
    assert (g.r, g.regs_shared, g.smem) == (4, False, ring)
    g = cuda.launch_geometry("interp_float2", nf=32, lanes=128, T=4)
    assert (g.r, g.blocks) == (1, 8)
    # two lanes a thread on request: twice the blocks, half the file
    g = cuda.launch_geometry("interp_float2", nf=32, lanes=32 * 128, T=128,
                             r=2)
    assert (g.r, g.regs_shared, g.blocks) == (2, True, 4096)
    assert g.smem == ring + 32 * cuda.BLOCK * 2 * 4
    with pytest.raises(ValueError):
        cuda.launch_geometry("interp_float2", nf=32, lanes=256, T=4, r=4)


# ----------------------------------------------------------------------
# P3: the fixed cost of a grid step


def _ref_grid_step(x, G, s0=8, reps=8):
    """demos/exp_grid_overhead.py:30-42 (`build`'s kernel and call),
    with interpret=True."""

    def kernel(x_ref, o_ref):
        v = x_ref[...]
        for _ in range(reps):
            v = v * 1.0001 + 0.5
        o_ref[...] = v

    T = x.shape[0]
    return pl.pallas_call(
        kernel,
        grid=(T // G,),
        in_specs=[pl.BlockSpec((G, s0, 128), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((G, s0, 128), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((T, s0, 128), jnp.float32),
        interpret=True,
    )(x)


def _ref_many(x, G, K):
    """demos/exp_grid_overhead.py:46-51 (`many`) over the restated
    kernel."""

    def body(k, acc):
        y = _ref_grid_step(x * (1.0 + 1e-7 * k.astype(jnp.float32)), G)
        return acc + y[0, 0, 0]

    return lax.fori_loop(0, K, body, jnp.float32(0.0))


@pytest.mark.parametrize("T,G", [(16, 1), (16, 4), (32, 16)])
def test_grid_step_matches_reference_body(T, G):
    """rtol 1e-6, atol 0: XLA on the CPU may contract each v * 1.0001 +
    0.5 into one FMA, which rounds once where the port (built with
    --fmad=false, and its plain version) rounds the product and the sum
    apart, so elements may differ by an ulp or so after the 8 steps."""
    x = (np.random.default_rng(T + G).normal(size=(T, 8, 128)) * 1000
         ).astype(np.float32)
    want = np.asarray(_ref_grid_step(jnp.asarray(x), G))
    plain = p3.grid_step_plain(torch.from_numpy(x), G)
    got = p3.grid_step(torch.from_numpy(x), G)
    assert torch.equal(got, plain)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-6, atol=0)


def test_grid_step_plain_rounds_each_product_and_sum():
    """The plain version's body is a multiply and an add, each rounded
    to f32, as the kernel computes it (float64 arithmetic rounded after
    every operation)."""
    x = (np.random.default_rng(0).normal(size=(4, 8, 128)) * 1000
         ).astype(np.float32)
    v = x.copy()
    for _ in range(p3.REPS):
        v = (v.astype(np.float64) * np.float64(np.float32(1.0001))
             ).astype(np.float32)
        v = (v.astype(np.float64) + 0.5).astype(np.float32)
    got = p3.grid_step_plain(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, v)


def test_many_matches_reference_driver():
    """`many`'s acc over K calls against the reference's `many`, at the
    same rtol 1e-6 for the same reason."""
    T, G, K = 16, 4, 5
    x = np.linspace(-2.0, 2.0, T * 8 * 128, dtype=np.float32).reshape(
        T, 8, 128)
    want = float(_ref_many(jnp.asarray(x), G, K))
    got = float(p3.many(torch.from_numpy(x), K, G))
    assert got == pytest.approx(want, rel=1e-6, abs=0)
    assert [p3.step_scale(k) for k in (0, 1, 63)] == [
        float(np.float32(1.0) + np.float32(1e-7) * np.float32(k))
        for k in (0, 1, 63)]


def test_grid_step_rejects_bad_arguments():
    with pytest.raises(ValueError):
        p3.grid_step(torch.zeros((16, 8, 128)), 3)
    with pytest.raises(ValueError):
        p3.grid_step(torch.zeros((16, 4, 128)), 1)
    with pytest.raises(ValueError):
        p3.grid_step(torch.zeros((16, 8, 128), dtype=torch.float64), 1)


# ----------------------------------------------------------------------
# the probes' entry points


@pytest.mark.parametrize("probe", [p2, p3], ids=["interleave", "grid"])
def test_probe_raises_without_card(monkeypatch, probe):
    """With no card and no device the probe raises; it never falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main()


def test_interleave_main_on_cpu(capsys):
    res = p2.main(device="cpu", T=4, L=16, nf=4, s0=1, V=1, reps=1)
    assert {"ms_a", "ms_b", "ns_a", "ns_b", "speedup"} <= set(res)
    # two instances, a block a stream
    assert res["geometry_b"].blocks == 4
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("A (1 stream/inst)")
    assert out[1].startswith("B (2 streams/inst)")


def test_grid_overhead_main_on_cpu(capsys):
    """On the CPU only the eager mode runs (a CUDA graph needs a card);
    one line per (T, G) and the fits."""
    res = p3.main(device="cpu", Ts=(16, 32), Gs=(1, 4), K=2, reps=1)
    assert res["graph"] == [] and len(res["eager"]) == 4
    assert [r["ctas"] for r in res["eager"]] == [16, 4, 32, 8]
    f = res["fit"]["eager"]
    assert {"slope_us", "intercept_us", "per_cta_us", "per_tile_us",
            "per_call_us"} <= set(f)
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.startswith("T=") for line in lines) == 4


def test_probes_import_no_jax():
    code = (
        "import sys, fidget_tpu_torch.demos.exp_interleave, "
        "fidget_tpu_torch.demos.exp_grid_overhead\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fidget_tpu' or m.startswith('fidget_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)
