"""The coded leaf kernel (K6), opcode renumbering through K1-K3 and the
`DeviceSimplifier` of the port against fidget_tpu's, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernels in interpret mode on the same seeded
numpy inputs. Values are held at the tolerances of
tests/test_torch_kernels.py (rtol = atol = 2e-5 on the op matrix,
rtol 1e-6 / atol 1e-7 on the shapes); packed words, choice words,
action codes, lengths and choice counts exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.compiler.pack import frequency_op_order as ref_frequency_op_order
from fidget_tpu.compiler.pack import pack_tapes as ref_pack_tapes
from fidget_tpu.eval import pallas_interp as ref_interp
from fidget_tpu.eval.arith import FloatMode as RefFloatMode
from fidget_tpu.eval.simplify_device import DeviceSimplifier as RefDeviceSimplifier
from fidget_tpu.eval.simplify_device import _liveness_codes
from fidget_tpu.eval.unrolled import eval_tape as ref_eval_tape

import fidget_tpu_torch as port
from fidget_tpu_torch.compiler.pack import pack_rows, pack_tapes
from fidget_tpu_torch.eval.arith import FloatMode, IntervalMode
from fidget_tpu_torch.eval.interp import (
    interp_float,
    interp_float_coded,
    interp_interval,
)
from fidget_tpu_torch.eval.simplify_device import (
    DeviceSimplifier,
    liveness_codes,
    per_lane_to_rows,
    reconstruct,
    unpack_codes,
)
from fidget_tpu_torch.eval.unrolled import eval_tape
from fidget_tpu_torch.scenes import pack_action_codes, seeded_action_codes
from test_torch_compiler import _assert_same_tape, port_tape_from_ref
from test_torch_kernels import (
    CASES,
    REF_TAPES,
    S0,
    UNION,
    V3,
    _arena,
    _assert_matches,
    _host_inputs,
    _matrix_planes,
    _planes,
)


def _ref_coded(w1, w2, imm, lengths, words, vars_, nf, V):
    return np.asarray(ref_interp.interp_float_coded(
        w1, w2, imm, lengths, words, vars_, nf=nf, n_inputs=V, n_outputs=1,
        s0=S0, interpret=True,
    ))


# ----------------------------------------------------------------------
# K6


def test_k6_op_matrix_with_seeded_codes_matches_reference_kernel():
    """Every op-matrix tape as the shared tape of six tiles: tile 0
    executes every row, tiles 1-4 carry seeded codes that rewrite ops to
    copies of either operand (immediates included) and skip the rows
    that makes dead, tile 5 is culled (length 0). Compared on the tiles
    the reference writes. The reference's kernels evaluate ATAN2, ASIN,
    ACOS, ATAN and MOD by their own routines (eval/softmath.py) where
    the port uses the native functions and is held to numpy, so a tile
    that executes such an op is held to the reference's numpy evaluator
    instead, as the float op matrix of tests/test_torch_kernels.py is."""
    tapes = [port_tape_from_ref(t) for _, t in CASES]
    packed = pack_tapes(tapes, capacity=32)
    pts, _, _ = _matrix_planes()
    rng = np.random.default_rng(11)
    T = 6
    seen = set()
    fm = RefFloatMode(np)
    for t_i, (label, t_ref) in enumerate(CASES):
        n = int(packed.lengths[t_i])
        w1, w2, imm = (a[t_i:t_i + 1] for a in (packed.w1, packed.w2, packed.imm))
        codes = np.zeros((T, 32), np.uint32)
        codes[0, :n] = 1
        for k in range(1, 5):
            codes[k] = seeded_action_codes(w1[0], w2[0], n, packed.nf, rng)
        codes[5] = codes[0]
        seen |= set(np.unique(codes[1:5, :n]).tolist())
        words = pack_action_codes(codes)
        lengths = np.full(T, n, np.int32)
        lengths[5] = 0
        vars_ = np.broadcast_to(pts[t_i], (T, 2, S0, 128)).copy()
        want = _ref_coded(w1, w2, imm, lengths, words, vars_, packed.nf, 2)
        got = interp_float_coded(
            *(torch.from_numpy(a) for a in (w1, w2, imm, lengths, words, vars_)),
            nf=packed.nf, n_inputs=2, n_outputs=1, s0=S0,
        ).numpy()
        with np.errstate(all="ignore"):
            (host,), _ = ref_eval_tape(t_ref, fm, _host_inputs(t_ref, "float"))
        soft = label.split(":")[-1 if ":" not in label else 1] in (
            "ATAN2", "ASIN", "ACOS", "ATAN", "MOD",
        )
        for k in range(5):
            whole = soft and (codes[k] == codes[0]).all()
            _assert_matches(
                got[k, 0], host if whole else want[k, 0], f"{label}:tile{k}"
            )
        assert (got[5] == 0).all()
        # tile 0 runs the whole tape: the float kernel's result
        full = interp_float(
            *(torch.from_numpy(a) for a in (w1, w2, imm, lengths[:1], vars_[:1])),
            nf=packed.nf, n_inputs=2, n_outputs=1, s0=S0,
        ).numpy()
        np.testing.assert_array_equal(got[0].view(np.uint32),
                                      full[0].view(np.uint32))
    assert seen == {0, 1, 2, 3}


@pytest.mark.parametrize("capacity", [512, None], ids=["padded", "ragged"])
def test_k6_with_liveness_codes_matches_reference_kernel(capacity):
    """Real codes: K1 over random boxes as lanes, K2 over the shared
    tape, then the coded leaf over points inside each tile's box,
    against the reference's coded kernel and against reconstruct + K3
    (bit-equal). `ragged` packs the tape at its own length, which is
    not a multiple of 16."""
    t_ref = REF_TAPES[UNION]
    tape = port_tape_from_ref(t_ref)
    pp = pack_tapes([tape], capacity=capacity)
    L = pp.w1.shape[1]
    if capacity is None:
        assert L % 16
    n_tiles = 24
    rng = np.random.default_rng(12)
    c = rng.uniform(-1, 1, size=(2, n_tiles)).astype(np.float32)
    half = rng.uniform(0.05, 0.4, size=n_tiles).astype(np.float32)
    lo = np.zeros((1, 2, S0, 128), np.float32)
    hi = np.zeros_like(lo)
    for v, i in tape.var_map.items():
        k = {"x": 0, "y": 1}[v.kind]
        lo[0, i].reshape(-1)[:n_tiles] = c[k] - half
        hi[0, i].reshape(-1)[:n_tiles] = c[k] + half
    w1, w2, imm, lens = _arena(pp)
    ch = interp_interval(
        w1, w2, imm, lens, torch.from_numpy(lo), torch.from_numpy(hi),
        nf=pp.nf, n_inputs=2, n_outputs=1, s0=S0, c_words=4,
    )[2]
    words = per_lane_to_rows(
        liveness_codes(w1, w2, lens, ch, nf=pp.nf, L=L, shared_tape=True),
        n_tiles,
    ).contiguous()
    codes = unpack_codes(words, L)
    assert set(np.unique(codes.numpy()).tolist()) >= {0, 1, 2}
    lengths = np.full(n_tiles, int(lens[0]), np.int32)
    lengths[3] = 0
    u = rng.uniform(-1, 1, size=(n_tiles, 2, S0, 128)).astype(np.float32)
    vars_ = np.zeros((n_tiles, 2, S0, 128), np.float32)
    for v, i in tape.var_map.items():
        k = {"x": 0, "y": 1}[v.kind]
        vars_[:, i] = c[k][:, None, None] + half[:, None, None] * u[:, k]
    want = _ref_coded(
        pp.w1, pp.w2, pp.imm, lengths, words.numpy(), vars_, pp.nf, 2
    )
    got = interp_float_coded(
        w1, w2, imm, torch.from_numpy(lengths), words, torch.from_numpy(vars_),
        nf=pp.nf, n_inputs=2, n_outputs=1, s0=S0,
    )
    live = lengths > 0
    np.testing.assert_allclose(
        got.numpy()[live], want[live], rtol=1e-6, atol=1e-7
    )
    assert (got[3] == 0).all()
    w1c, w2c, immc, lensc, _ = reconstruct(w1, w2, imm, codes)
    lensc = torch.where(torch.from_numpy(live), lensc, 0)
    leaf = interp_float(
        w1c, w2c, immc, lensc, torch.from_numpy(vars_), nf=pp.nf, n_inputs=2,
        n_outputs=1, s0=S0,
    )
    assert torch.equal(got.view(torch.int32), leaf.view(torch.int32))
    assert int(lensc.max()) < int(lens[0])


def test_k6_rejects_bad_layouts():
    pp = pack_tapes([port_tape_from_ref(REF_TAPES[UNION])], capacity=512)
    w1, w2, imm, _ = _arena(pp)
    vars_ = torch.zeros((2, 2, S0, 128))
    lengths = torch.zeros(2, dtype=torch.int32)
    kw = dict(nf=pp.nf, n_inputs=2, n_outputs=1, s0=S0)
    with pytest.raises(ValueError, match="code words"):
        interp_float_coded(w1, w2, imm, lengths,
                           torch.zeros((2, 31), dtype=torch.int32), vars_, **kw)
    with pytest.raises(ValueError, match="shared tape"):
        interp_float_coded(w1.expand(2, -1), w2, imm, lengths,
                           torch.zeros((2, 32), dtype=torch.int32), vars_, **kw)


# ----------------------------------------------------------------------
# opcode renumbering through K1, K2, K3


@pytest.fixture(scope="module")
def ordered_pair():
    """REF_TAPES packed under the union tape's frequency order, in both
    packages, beside the port's canonical arena."""
    order = ref_frequency_op_order(REF_TAPES[UNION])
    assert order != tuple(range(31))
    port_tapes = [port_tape_from_ref(t) for t in REF_TAPES]
    return (
        order,
        pack_tapes(port_tapes, capacity=512, op_order=order),
        ref_pack_tapes(REF_TAPES, capacity=512, op_order=order),
        pack_tapes(port_tapes, capacity=512),
    )


def test_k3_under_op_order_matches_reference_kernel(ordered_pair):
    order, pp, rp, canon = ordered_pair
    vars_, _ = _planes(REF_TAPES, 20, interval=False)
    want = np.asarray(ref_interp.interp_float(
        rp.w1, rp.w2, rp.imm, rp.lengths, vars_, nf=rp.nf, n_inputs=V3,
        n_outputs=1, s0=S0, interpret=True, op_order=order,
    ))
    kw = dict(nf=pp.nf, n_inputs=V3, n_outputs=1, s0=S0)
    got = interp_float(*_arena(pp), torch.from_numpy(vars_), op_order=order, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    plain = interp_float(*_arena(canon), torch.from_numpy(vars_), **kw)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


def test_k1_under_op_order_matches_reference_kernel(ordered_pair):
    order, pp, rp, canon = ordered_pair
    lo, hi = _planes(REF_TAPES, 21, interval=True)
    wlo, whi, wch = (np.asarray(a) for a in ref_interp.interp_interval(
        rp.w1, rp.w2, rp.imm, rp.lengths, lo, hi, nf=rp.nf, n_inputs=V3,
        n_outputs=1, s0=S0, c_words=4, interpret=True, op_order=order,
    ))
    kw = dict(nf=pp.nf, n_inputs=V3, n_outputs=1, s0=S0, c_words=4)
    tlo, thi = torch.from_numpy(lo), torch.from_numpy(hi)
    got = interp_interval(*_arena(pp), tlo, thi, op_order=order, **kw)
    np.testing.assert_allclose(got[0].numpy(), wlo, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[1].numpy(), whi, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), wch)
    assert (wch != 0).any()
    plain = interp_interval(*_arena(canon), tlo, thi, **kw)
    for g, p in zip(got, plain):
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("shared", [True, False])
def test_k2_under_op_order_matches_reference_kernel(ordered_pair, shared):
    order, pp, rp, canon = ordered_pair
    lo, hi = _planes(REF_TAPES, 22, interval=True)
    ch = interp_interval(
        *_arena(pp), torch.from_numpy(lo), torch.from_numpy(hi), nf=pp.nf,
        n_inputs=V3, n_outputs=1, s0=S0, c_words=4, op_order=order,
    )[2]
    L = pp.w1.shape[1]
    rows = slice(UNION, UNION + 1) if shared else slice(0, len(REF_TAPES))
    if shared:
        ch = ch[rows].expand(2, -1, -1, -1).contiguous()
    w1, w2, _, lens = (a[rows] for a in _arena(pp))
    Tt = w1.shape[0]
    want = np.asarray(_liveness_codes(
        w1.numpy().reshape(Tt, 1, L), w2.numpy().reshape(Tt, 1, L),
        lens.numpy().reshape(Tt, 1, 1), ch.numpy(), nf=pp.nf, L=L,
        shared_tape=shared, interpret=True, op_order=order,
    ))
    got = liveness_codes(
        w1, w2, lens, ch, nf=pp.nf, L=L, shared_tape=shared, op_order=order
    )
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).any()
    cw1, cw2, _, clens = (a[rows] for a in _arena(canon))
    assert torch.equal(got, liveness_codes(
        cw1, cw2, clens, ch, nf=pp.nf, L=L, shared_tape=shared
    ))


def test_wrong_op_order_changes_the_result(ordered_pair):
    """The invariant the renumbering rests on: an arena evaluated under
    another order than it was packed with gives another answer."""
    order, pp, _, canon = ordered_pair
    vars_, _ = _planes(REF_TAPES, 23, interval=False)
    kw = dict(nf=pp.nf, n_inputs=V3, n_outputs=1, s0=S0)
    right = interp_float(*_arena(canon), torch.from_numpy(vars_), **kw)
    wrong = interp_float(*_arena(pp), torch.from_numpy(vars_), **kw)
    assert not torch.equal(right, wrong)


# ----------------------------------------------------------------------
# DeviceSimplifier


def _spiky3(pkg, reg_limit):
    ctx = pkg.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    r = ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y)))
    circ = ctx.sub(r, 1.0)
    sq = ctx.max(ctx.sub(ctx.abs(x), 0.8), ctx.sub(ctx.abs(y), 0.8))
    swirl = ctx.add(ctx.sin(ctx.mul(x, 3.0)), ctx.cos(ctx.mul(y, 3.0)))
    f = ctx.min(circ, ctx.max(sq, ctx.mul(swirl, 0.2)))
    f = ctx.min(f, ctx.max(ctx.sub(z, 0.5), ctx.min(x, y)))
    return pkg.lower(ctx, [f], reg_limit=reg_limit)


def _regions(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.5, 1.5, size=(n, 3))
    w = rng.uniform(0.05, 0.6, size=(n, 3))
    return (c - w).astype(np.float32), (c + w).astype(np.float32)


@pytest.mark.parametrize("reg_limit", [255, 6, 3], ids=["regs", "tight", "spills"])
def test_device_simplifier_matches_host_simplify(reg_limit):
    """`DeviceSimplifier.__call__` over real choice traces against the
    port's host `simplify`, itself held field for field to the
    reference's `simplify` of the same tape and trace: lengths and
    choice counts equal, child rows bit-identical to packing the
    host-simplified tape, and the child tape evaluates like its parent
    inside its region (bit-equal through the same evaluator; allclose
    to numpy at the frame's tolerance, torch's and numpy's sin and cos
    differing by an ulp)."""
    t_ref = _spiky3(ref, reg_limit)
    tape = port_tape_from_ref(t_ref)
    if reg_limit == 3:
        assert tape.mem_count > 0
    ds = DeviceSimplifier(tape, device="cpu")
    lo, hi = _regions(16, reg_limit)
    im = IntervalMode(np)
    kind = {"x": 0, "y": 1, "z": 2}
    traces = []
    for t in range(16):
        inputs = [None] * len(tape.var_map)
        for v, i in tape.var_map.items():
            inputs[i] = (lo[t, kind[v.kind]], hi[t, kind[v.kind]])
        _, choices = eval_tape(tape, im, inputs, trace=True)
        traces.append(np.array([int(c) for c in choices], np.uint8))
    traces = np.stack(traces)
    w1, w2, imm, lengths, ncho = (
        a.numpy() for a in ds(torch.from_numpy(traces))
    )
    V = len(tape.var_map)
    pw = pack_tapes([tape])
    rng = np.random.default_rng(42)
    for t in range(16):
        host = port.simplify(tape, traces[t])
        _assert_same_tape(host, ref.simplify(t_ref, traces[t]))
        assert lengths[t] == len(host)
        assert ncho[t] == host.choice_count
        hw1, hw2, himm = pack_rows(host)
        np.testing.assert_array_equal(w1[t, : lengths[t]], hw1)
        np.testing.assert_array_equal(w2[t, : lengths[t]], hw2)
        np.testing.assert_array_equal(imm[t, : lengths[t]], himm)
        pts = np.stack([
            rng.uniform(lo[t, k], hi[t, k], 256).astype(np.float32)
            for k in range(3)
        ])
        vars_ = np.zeros((1, V, 2, 128), np.float32)
        for v, i in tape.var_map.items():
            vars_[0, i] = pts[kind[v.kind]].reshape(2, 128)
        kw = dict(nf=ds.nf, n_inputs=V, n_outputs=1, s0=2)
        got = interp_float(
            *(torch.from_numpy(a[t:t + 1].copy()) for a in (w1, w2, imm, lengths)),
            torch.from_numpy(vars_), **kw,
        )
        parent = interp_float(*_arena(pw), torch.from_numpy(vars_), **kw)
        assert torch.equal(got, parent)
        inputs = [None] * V
        for v, i in tape.var_map.items():
            inputs[i] = pts[kind[v.kind]]
        (want,), _ = eval_tape(tape, FloatMode(np), inputs)
        np.testing.assert_allclose(
            got.numpy()[0, 0].reshape(-1), want, rtol=1e-5, atol=1e-6
        )
    assert lengths.min() < lengths.max()


def test_device_simplifier_all_both_is_identity():
    tape = _spiky3(port, 255)
    ds = DeviceSimplifier(tape, device="cpu")
    traces = torch.full((2, tape.choice_count), 3, dtype=torch.uint8)
    _, _, _, lengths, ncho = ds(traces)
    assert int(lengths[0]) == len(tape)
    assert int(ncho[0]) == tape.choice_count


@pytest.mark.parametrize("reg_limit", [255, 6, 3], ids=["regs", "tight", "spills"])
@pytest.mark.parametrize("ordered", [False, True], ids=["canonical", "op_order"])
def test_simplify_packed_matches_reference(reg_limit, ordered):
    """`simplify_packed` (K2 over the shared tape, then reconstruction)
    on packed choice words from K1: every arena word for word against
    the reference's, and the scan path gives the same arenas."""
    t_ref = _spiky3(ref, reg_limit)
    tape = port_tape_from_ref(t_ref)
    order = ref_frequency_op_order(t_ref) if ordered else None
    ds = DeviceSimplifier(tape, order, device="cpu")
    rds = RefDeviceSimplifier(t_ref, order)
    assert (ds.nf, ds.L, ds.n_choices) == (rds.nf, rds.L, rds.n_choices)
    n_tiles = 40
    lo_r, hi_r = _regions(n_tiles, 7 + reg_limit)
    V = len(tape.var_map)
    lo = np.zeros((1, V, S0, 128), np.float32)
    hi = np.zeros_like(lo)
    for v, i in tape.var_map.items():
        k = {"x": 0, "y": 1, "z": 2}[v.kind]
        lo[0, i].reshape(-1)[:n_tiles] = lo_r[:, k]
        hi[0, i].reshape(-1)[:n_tiles] = hi_r[:, k]
    pp = pack_tapes([tape], op_order=order)
    assert pp.w1.shape[1] % 16  # the last code word is ragged
    c_words = max(1, -(-tape.choice_count // 16))
    ch = interp_interval(
        *_arena(pp), torch.from_numpy(lo), torch.from_numpy(hi), nf=ds.nf,
        n_inputs=V, n_outputs=1, s0=S0, c_words=c_words, op_order=order,
    )[2]
    want = rds.simplify_packed(
        jnp.asarray(ch.numpy()), n_tiles=n_tiles, interpret=True
    )
    got = ds.simplify_packed(ch, n_tiles=n_tiles)
    for g, w, name in zip(got, want, ("w1", "w2", "imm", "lengths", "nch")):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_array_equal(
        ds.codes_per_tile(ch, n_tiles=n_tiles).numpy(),
        np.asarray(rds.codes_per_tile(
            jnp.asarray(ch.numpy()), n_tiles=n_tiles, interpret=True
        )),
    )
    # the scan path on the same choices, unpacked per tile
    idx = np.arange(tape.choice_count)
    per_tile = ch.numpy().reshape(c_words, -1)[:, :n_tiles]
    traces = ((per_tile[idx // 16] >> ((idx % 16) * 2)[:, None]) & 3).T
    scan = ds(torch.from_numpy(traces.astype(np.uint8)))
    for g, s in zip(got, scan):
        assert torch.equal(g, s)
    assert int(got[3].min()) < int(got[3].max())


def test_device_simplifier_without_device_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceSimplifier(_spiky3(port, 255))
