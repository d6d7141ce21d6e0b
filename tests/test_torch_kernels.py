"""The port's interpreter kernels (K1 interval, K2 liveness, K3 float)
against fidget_tpu's, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions to the reference: the Pallas
kernels in interpret mode on the same packed arenas at S0 = 8 (values
allclose at the tolerance of tests/test_pallas_interp.py, choices and
action codes exact), and the per-op matrix of tests/test_kernel_ops.py
against the reference's host evaluator with numpy's own
transcendentals. The CUDA kernels are held to the same plain versions
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.compiler.pack import pack_tapes as ref_pack_tapes
from fidget_tpu.core.ops import BinaryOp, UnaryOp
from fidget_tpu.eval import pallas_interp as ref_interp
from fidget_tpu.eval.arith import FloatMode as RefFloatMode
from fidget_tpu.eval.arith import IntervalMode as RefIntervalMode
from fidget_tpu.eval.simplify_device import (
    DeviceSimplifier,
    DynamicSimplifier,
    _liveness_codes,
)
from fidget_tpu.eval.unrolled import eval_tape as ref_eval_tape

from fidget_tpu_torch.compiler.pack import pack_tapes
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval.interp import (
    interp_float,
    interp_interval,
    tape_n_ops,
)
from fidget_tpu_torch.eval.simplify_device import (
    liveness_codes,
    per_lane_to_rows,
    reconstruct,
    unpack_codes,
)
from test_torch_compiler import SHAPES, port_tape_from_ref

S0 = 8
LANES = S0 * 128

SPICY = np.array(
    [
        0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 100.0, -100.0,
        math.pi, -math.pi, math.pi / 2, -math.pi / 2, 2 * math.pi,
        0.1, -0.1, 1e6, -1e6, math.nan, math.inf, -math.inf,
    ],
    dtype=np.float32,
)
NS = len(SPICY)
NPAIR = NS * NS


def _pad(a):
    return np.pad(a.astype(np.float32), (0, LANES - len(a)))


A_PTS = _pad(np.repeat(SPICY, NS))
B_PTS = _pad(np.tile(SPICY, NS))
A_LO = _pad(np.minimum(np.repeat(SPICY, NS), np.tile(SPICY, NS)))
A_HI = _pad(np.maximum(np.repeat(SPICY, NS), np.tile(SPICY, NS)))


def _matrix_cases():
    """(label, reference tape) for every op x operand-position variant
    that survives constant folding, plus a spill-forcing tape: the
    cases of tests/test_kernel_ops.py."""
    cases = []
    for op in UnaryOp:
        ctx = ref.Context()
        cases.append((f"u:{op.name}", ref.lower(ctx, [ctx.op_unary(op, ctx.x())])))
    for op in BinaryOp:
        for variant, imm in (
            ("reg_reg", None), ("reg_imm", 0.5), ("reg_imm", -2.0),
            ("imm_reg", 0.5), ("imm_reg", -2.0),
        ):
            ctx = ref.Context()
            x, y = ctx.x(), ctx.y()
            if variant == "reg_reg":
                node = ctx.op_binary(op, x, y)
            elif variant == "reg_imm":
                node = ctx.op_binary(op, x, ctx.constant(imm))
            else:
                node = ctx.op_binary(op, ctx.constant(imm), y)
            if ctx.get_const(node) is not None or ctx.tag(node) != 3:
                continue
            cases.append((f"b:{op.name}:{variant}:{imm}", ref.lower(ctx, [node])))
    ctx = ref.Context()
    x, y = ctx.x(), ctx.y()
    f = ctx.min(
        ctx.add(ctx.sin(x), ctx.cos(y)),
        ctx.sub(ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y))), 1.0),
    )
    cases.append(("spill", ref.lower(ctx, [f], reg_limit=2)))
    return cases


CASES = _matrix_cases()


def _assert_matches(got, want, label, rtol=2e-5, atol=2e-5):
    """NaN-aware comparison over the meaningful lanes, as in
    tests/test_kernel_ops.py (f32 overflow to the same-signed infinity
    counts as agreement)."""
    got = np.asarray(got).reshape(-1)[:NPAIR]
    want = np.asarray(want).reshape(-1)[:NPAIR]
    both_nan = np.isnan(got) & np.isnan(want)
    exact = got == want
    finite = np.isfinite(got) & np.isfinite(want)
    with np.errstate(invalid="ignore"):
        close = finite & (np.abs(got - want) <= atol + rtol * np.abs(want))
    huge = (np.abs(got) > 1e30) | np.isinf(got)
    huge &= (np.abs(want) > 1e30) | np.isinf(want)
    huge &= np.sign(np.where(np.isfinite(got), got, np.copysign(1, got))) == (
        np.sign(np.where(np.isfinite(want), want, np.copysign(1, want)))
    )
    bad = np.nonzero(~(both_nan | exact | close | huge))[0]
    assert bad.size == 0, (
        label, bad[:5], A_PTS[bad[:5]], B_PTS[bad[:5]], got[bad[:5]],
        want[bad[:5]],
    )


def _arena(packed, device="cpu"):
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (packed.w1, packed.w2, packed.imm, packed.lengths)
    )


def _host_inputs(tape, mode):
    inputs = [None] * len(tape.var_map)
    for v, i in tape.var_map.items():
        if mode == "float":
            inputs[i] = A_PTS if v == ref.Var.X else B_PTS
        else:
            inputs[i] = (A_LO, A_HI) if v == ref.Var.X else (B_PTS, B_PTS)
    return inputs


def _matrix_planes():
    """Float and interval input planes [T, 2, S0, 128] for CASES."""
    T = len(CASES)
    pts = np.zeros((T, 2, S0, 128), np.float32)
    lo = np.zeros_like(pts)
    hi = np.zeros_like(pts)
    for t_i, (_, tape) in enumerate(CASES):
        for v, i in tape.var_map.items():
            is_x = v == ref.Var.X
            pts[t_i, i] = (A_PTS if is_x else B_PTS).reshape(S0, 128)
            lo[t_i, i] = (A_LO if is_x else B_PTS).reshape(S0, 128)
            hi[t_i, i] = (A_HI if is_x else B_PTS).reshape(S0, 128)
    return pts, lo, hi


def _unpack_choices(words, n):
    idx = np.arange(n)
    w = words[..., np.minimum(idx // 16, words.shape[-3] - 1), :, :]
    return (w >> ((idx % 16) * 2)[:, None, None]) & 3


# ----------------------------------------------------------------------
# op matrix: every op in float and interval mode


def test_float_op_matrix():
    tapes = [port_tape_from_ref(t) for _, t in CASES]
    packed = pack_tapes(tapes, capacity=32)
    pts, _, _ = _matrix_planes()
    out = interp_float(
        *_arena(packed), torch.from_numpy(pts), nf=packed.nf, n_inputs=2,
        n_outputs=1, s0=S0,
    ).numpy()
    fm = RefFloatMode(np)
    for t_i, (label, tape) in enumerate(CASES):
        with np.errstate(all="ignore"):
            (want,), _ = ref_eval_tape(tape, fm, _host_inputs(tape, "float"))
        _assert_matches(out[t_i, 0], want, label)


def test_interval_op_matrix():
    tapes = [port_tape_from_ref(t) for _, t in CASES]
    packed = pack_tapes(tapes, capacity=32)
    _, lo, hi = _matrix_planes()
    olo, ohi, ch = interp_interval(
        *_arena(packed), torch.from_numpy(lo), torch.from_numpy(hi),
        nf=packed.nf, n_inputs=2, n_outputs=1, s0=S0, c_words=1,
    )
    olo, ohi, ch = olo.numpy(), ohi.numpy(), ch.numpy()
    im = RefIntervalMode(np)
    for t_i, (label, tape) in enumerate(CASES):
        with np.errstate(all="ignore"):
            (want,), choices = ref_eval_tape(
                tape, im, _host_inputs(tape, "interval"), trace=True
            )
        _assert_matches(olo[t_i, 0], want[0], label + ":lo")
        _assert_matches(ohi[t_i, 0], want[1], label + ":hi")
        if tape.choice_count:
            got = _unpack_choices(ch[t_i], tape.choice_count)
            want_ch = np.stack([c.reshape(S0, 128) for c in choices])
            np.testing.assert_array_equal(
                got.reshape(tape.choice_count, -1)[:, :NPAIR],
                want_ch.reshape(tape.choice_count, -1)[:, :NPAIR],
                err_msg=label,
            )


#: values past the op matrix: f32 integers beyond 2^23 (where the
#: a +- 0.5 rounding idiom breaks), halves, the f32 just below 0.5
EDGES = np.concatenate([SPICY, np.array(
    [8388609.0, -8388609.0, 1e10, -1e10, 2.5, -2.5, 0.49999997, 1e-40],
    dtype=np.float32,
)])


@pytest.mark.parametrize("op", list(UnaryOp), ids=lambda o: o.name)
def test_unary_ops_on_edge_values(op):
    """Each unary op of the port's FloatMode and IntervalMode against
    the reference's, with numpy on both sides of the comparison."""
    from fidget_tpu.compiler.tape import TapeOp as RefTapeOp
    from fidget_tpu_torch.compiler.tape import TapeOp
    from fidget_tpu_torch.eval.arith import FloatMode, IntervalMode

    # correctly rounded in IEEE f32 on both sides: exact; the
    # transcendentals at the op matrix's tolerance
    exact = op.name in ("NEG", "ABS", "SQUARE", "SQRT", "RECIP", "FLOOR",
                        "CEIL", "ROUND", "NOT")
    tol = 0 if exact else 2e-5
    a = np.repeat(EDGES, EDGES.size)
    b = np.tile(EDGES, EDGES.size)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    top, rop = TapeOp[op.name], RefTapeOp[op.name]
    with np.errstate(all="ignore"):
        got = FloatMode(torch).unary(top, torch.from_numpy(EDGES)).numpy()
        want = RefFloatMode(np).unary(rop, EDGES)
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        got = IntervalMode(torch).unary(
            top, (torch.from_numpy(lo), torch.from_numpy(hi))
        )
        want = RefIntervalMode(np).unary(rop, (lo, hi))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# K1 / K3 / K2 against the reference kernels in interpret mode


def _ref_tapes():
    out = []
    for name in sorted(SHAPES):
        ctx = ref.Context()
        out.append(ref.lower(ctx, [SHAPES[name](ctx)]))
    ctx = ref.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    gyroid = ctx.add(
        ctx.mul(ctx.sin(x), ctx.cos(y)),
        ctx.add(ctx.mul(ctx.sin(y), ctx.cos(z)), ctx.mul(ctx.sin(z), ctx.cos(x))),
    )
    sphere = ctx.sub(
        ctx.sqrt(ctx.add(ctx.square(x), ctx.add(ctx.square(y), ctx.square(z)))),
        0.9,
    )
    out.append(ref.lower(ctx, [ctx.max(sphere, gyroid)]))
    return out


REF_TAPES = _ref_tapes()
UNION = sorted(SHAPES).index("union")
V3 = 3


def _planes(tapes, seed, interval):
    """Per-tape input planes [T, 3, S0, 128] from a numpy seed (points,
    or intervals of random width around them)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, size=(len(tapes), 3, S0, 128)).astype(np.float32)
    width = rng.uniform(0, 0.5, size=pts.shape).astype(np.float32)
    kind_row = {"x": 0, "y": 1, "z": 2}
    lo = np.zeros((len(tapes), V3, S0, 128), np.float32)
    hi = np.zeros_like(lo)
    for t_i, tape in enumerate(tapes):
        for v, i in tape.var_map.items():
            r = kind_row[v.kind]
            lo[t_i, i] = pts[t_i, r]
            hi[t_i, i] = pts[t_i, r] + (width[t_i, r] if interval else 0)
    return lo, hi


@pytest.fixture(scope="module")
def packed_pair():
    port_tapes = [port_tape_from_ref(t) for t in REF_TAPES]
    return (
        pack_tapes(port_tapes, capacity=512),
        ref_pack_tapes(REF_TAPES, capacity=512),
    )


def test_k3_float_matches_reference_kernel(packed_pair):
    pp, rp = packed_pair
    vars_, _ = _planes(REF_TAPES, 0, interval=False)
    want = np.asarray(ref_interp.interp_float(
        rp.w1, rp.w2, rp.imm, rp.lengths, vars_, nf=rp.nf, n_inputs=V3,
        n_outputs=1, s0=S0, interpret=True,
    ))
    got = interp_float(
        *_arena(pp), torch.from_numpy(vars_), nf=pp.nf, n_inputs=V3,
        n_outputs=1, s0=S0,
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_k1_interval_matches_reference_kernel(packed_pair):
    pp, rp = packed_pair
    lo, hi = _planes(REF_TAPES, 1, interval=True)
    cw = 4
    wlo, whi, wch = (np.asarray(a) for a in ref_interp.interp_interval(
        rp.w1, rp.w2, rp.imm, rp.lengths, lo, hi, nf=rp.nf, n_inputs=V3,
        n_outputs=1, s0=S0, c_words=cw, interpret=True,
    ))
    glo, ghi, gch = (a.numpy() for a in interp_interval(
        *_arena(pp), torch.from_numpy(lo), torch.from_numpy(hi), nf=pp.nf,
        n_inputs=V3, n_outputs=1, s0=S0, c_words=cw,
    ))
    np.testing.assert_allclose(glo, wlo, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ghi, whi, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(gch, wch)
    assert (gch != 0).any()


def test_k1_choice_words_fold_into_last_word(packed_pair):
    """With too few choice words, indices past 16 * CW OR into the last
    word, as the reference does (the union tape has 39 choices)."""
    pp, rp = packed_pair
    lo, hi = _planes(REF_TAPES, 2, interval=True)
    wch = np.asarray(ref_interp.interp_interval(
        rp.w1, rp.w2, rp.imm, rp.lengths, lo, hi, nf=rp.nf, n_inputs=V3,
        n_outputs=1, s0=S0, c_words=1, interpret=True,
    )[2])
    gch = interp_interval(
        *_arena(pp), torch.from_numpy(lo), torch.from_numpy(hi), nf=pp.nf,
        n_inputs=V3, n_outputs=1, s0=S0, c_words=1,
    )[2].numpy()
    np.testing.assert_array_equal(gch, wch)


@pytest.mark.parametrize("shared", [True, False])
def test_k2_liveness_codes_match_reference_kernel(packed_pair, shared):
    pp, rp = packed_pair
    lo, hi = _planes(REF_TAPES, 3, interval=True)
    cw = 4
    ch = interp_interval(
        *_arena(pp), torch.from_numpy(lo), torch.from_numpy(hi), nf=pp.nf,
        n_inputs=V3, n_outputs=1, s0=S0, c_words=cw,
    )[2]
    L = pp.w1.shape[1]
    T = len(REF_TAPES)
    rows = slice(UNION, UNION + 1) if shared else slice(0, T)
    if shared:  # the union's tape for two instances with its choices
        ch = ch[rows].expand(2, -1, -1, -1).contiguous()
    w1, w2, _, lens = (a[rows] for a in _arena(pp))
    Tt = w1.shape[0]
    want = np.asarray(_liveness_codes(
        w1.numpy().reshape(Tt, 1, L), w2.numpy().reshape(Tt, 1, L),
        lens.numpy().reshape(Tt, 1, 1), ch.numpy(), nf=pp.nf, L=L,
        shared_tape=shared, interpret=True,
    ))
    got = liveness_codes(
        w1, w2, lens, ch, nf=pp.nf, L=L, shared_tape=shared
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any()


def test_k2_immediate_operands_are_clamped():
    """Immediates carry IMM12 (4095) in a/b; the liveness plane is
    indexed at min(a, nf - 1) with a zero use bit, so a tiny register
    file gives the reference's codes (BUGREPORT.md)."""
    ctx = ref.Context()
    x, y = ctx.x(), ctx.y()
    f = ctx.min(ctx.sub(ctx.abs(x), 0.25), ctx.mul(ctx.sub(y, 0.5), 2.0))
    t_ref = ref.lower(ctx, [f])
    pp = pack_tapes([port_tape_from_ref(t_ref)])
    L = pp.w1.shape[1]
    rng = np.random.default_rng(4)
    words = rng.integers(0, 4, size=(1, 1, S0, 128)).astype(np.int32)
    w1, w2, _, lens = _arena(pp)
    want = np.asarray(_liveness_codes(
        w1.numpy().reshape(1, 1, L), w2.numpy().reshape(1, 1, L),
        lens.numpy().reshape(1, 1, 1), words, nf=pp.nf, L=L,
        shared_tape=True, interpret=True,
    ))
    got = liveness_codes(
        w1, w2, lens, torch.from_numpy(words), nf=pp.nf, L=L,
        shared_tape=True,
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_reconstruct_matches_reference(packed_pair):
    pp, rp = packed_pair
    lo, hi = _planes(REF_TAPES, 5, interval=True)
    union = UNION
    ch = interp_interval(
        *(a[union:union + 1] for a in _arena(pp)),
        torch.from_numpy(lo[union:union + 1]),
        torch.from_numpy(hi[union:union + 1]),
        nf=pp.nf, n_inputs=V3, n_outputs=1, s0=S0, c_words=4,
    )[2]
    w1, w2, imm, lens = (a[union:union + 1] for a in _arena(pp))
    L = w1.shape[1]
    perlane = liveness_codes(w1, w2, lens, ch, nf=pp.nf, L=L, shared_tape=True)
    n = 300
    rows = per_lane_to_rows(perlane, n)
    ref_rows = np.moveaxis(
        perlane.numpy().reshape(1, -1, LANES), 1, 2
    ).reshape(LANES, -1)[:n]
    np.testing.assert_array_equal(rows.numpy(), ref_rows)
    codes = unpack_codes(rows, L)
    np.testing.assert_array_equal(
        codes.numpy(), np.asarray(DeviceSimplifier.unpack_codes(ref_rows, L))
    )
    got = reconstruct(w1, w2, imm, codes)
    bw = lambda a: np.broadcast_to(a.numpy(), (n, L))
    want = DynamicSimplifier.reconstruct(
        bw(w1), bw(w2), bw(imm), codes.numpy()
    )
    for g, w, name in zip(got, want, ("w1", "w2", "imm", "lengths", "nch")):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    lens_c = got[3].numpy()
    assert lens_c.min() < lens_c.max() <= int(lens[0])


def test_zero_length_instances_write_zero_outputs(packed_pair):
    pp, _ = packed_pair
    w1, w2, imm, lens = _arena(pp)
    lens = torch.zeros_like(lens)
    vars_, _ = _planes(REF_TAPES, 6, interval=False)
    out = interp_float(
        w1, w2, imm, lens, torch.from_numpy(vars_), nf=pp.nf, n_inputs=V3,
        n_outputs=2, s0=S0,
    )
    assert out.shape == (len(REF_TAPES), 2, S0, 128)
    assert (out == 0).all()


def test_interval_lane_chunks_agree(packed_pair):
    """Any split of the lanes gives the same outputs and choice words
    (the chunk-equality property of the reference's s0 split)."""
    pp, _ = packed_pair
    lo, hi = _planes(REF_TAPES, 7, interval=True)
    args = dict(nf=pp.nf, n_inputs=V3, n_outputs=1, c_words=4)
    full = interp_interval(
        *_arena(pp), torch.from_numpy(lo), torch.from_numpy(hi), s0=S0, **args
    )
    halves = [
        interp_interval(
            *_arena(pp), torch.from_numpy(lo[:, :, k:k + 4].copy()),
            torch.from_numpy(hi[:, :, k:k + 4].copy()), s0=4, **args,
        )
        for k in (0, 4)
    ]
    for i in range(3):
        torch.testing.assert_close(
            full[i], torch.cat([h[i] for h in halves], dim=2), rtol=0, atol=0
        )


def test_cpu_path_launches_no_kernel(packed_pair):
    pp, _ = packed_pair
    cuda.reset_launches()
    vars_, _ = _planes(REF_TAPES, 8, interval=False)
    interp_float(
        *_arena(pp), torch.from_numpy(vars_), nf=pp.nf, n_inputs=V3,
        n_outputs=1, s0=S0,
    )
    assert cuda.LAUNCHES == {name: 0 for name in cuda.KERNELS}


def test_wrappers_reject_bad_layouts(packed_pair):
    pp, _ = packed_pair
    vars_ = torch.zeros((len(REF_TAPES), V3, S0, 64))
    with pytest.raises(ValueError, match="planes"):
        interp_float(*_arena(pp), vars_, nf=pp.nf, n_inputs=V3, n_outputs=1,
                     s0=S0)
    w1, w2, imm, lens = _arena(pp)
    with pytest.raises(ValueError, match="dtype"):
        interp_float(w1, w2, imm.double(), lens,
                     torch.zeros((len(REF_TAPES), V3, S0, 128)), nf=pp.nf,
                     n_inputs=V3, n_outputs=1, s0=S0)


def test_tape_n_ops_matches_reference():
    for t_ref in REF_TAPES + [t for _, t in CASES[::7]]:
        t = port_tape_from_ref(t_ref)
        assert tape_n_ops(t) == ref_interp.tape_n_ops(t_ref)
