"""The port's `BulkEvaluator` against fidget_tpu's, on the CPU.

Both evaluate the same tapes on the same flat point lists from a numpy
seed: the port on its plain PyTorch versions (K3, K1, K4 on the card),
the reference on its Pallas kernels in interpret mode. Distances and
intervals allclose (rtol 1e-5, atol 1e-6, as tests/test_kernel_ops.py
has them), signs, classification and choice words exact, duals at the
mesher's normals tolerance (1e-4). Ragged lengths, a constant-only tape
and a tape with a `Var` included.
"""

import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.eval.bulk import BulkEvaluator as RefBulk

import fidget_tpu_torch as port
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval.bulk import LANE_ROWS, BulkEvaluator


def _sphere_box(pkg):
    ctx = pkg.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    s = ctx.sub(ctx.sqrt(ctx.add(ctx.square(x), ctx.add(ctx.square(y),
                                                         ctx.square(z)))), 0.6)
    b = ctx.max(ctx.sub(ctx.abs(x), 0.4), ctx.sub(ctx.abs(z), 0.3))
    return pkg.lower(ctx, [ctx.min(s, b)]), None


def _gyroid(pkg):
    ctx = pkg.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    g = ctx.add(ctx.mul(ctx.sin(x), ctx.cos(y)),
                ctx.add(ctx.mul(ctx.sin(y), ctx.cos(z)),
                        ctx.mul(ctx.sin(z), ctx.cos(x))))
    return pkg.lower(ctx, [ctx.sub(ctx.abs(g), 0.2)]), None


def _with_var(pkg):
    ctx = pkg.Context()
    r = pkg.Var.new()
    x, y = ctx.x(), ctx.y()
    f = ctx.sub(ctx.sqrt(ctx.add(ctx.square(x), ctx.square(ctx.mul(y, 2.0)))),
                ctx.input(r))
    tape = pkg.lower(ctx, [f])
    vec = np.zeros(len(tape.var_map), np.float32)
    vec[tape.var_map[r]] = 0.45
    return tape, vec


def _constant(pkg):
    ctx = pkg.Context()
    return pkg.lower(ctx, [ctx.constant(-0.25)]), None


TAPES = {"sphere_box": _sphere_box, "gyroid": _gyroid, "var": _with_var,
         "constant": _constant}
#: ragged point counts: under one lane row, not a multiple of 128, and
#: one past an instance of LANE_ROWS * 128 lanes (two instances)
SIZES = [5, 1000, LANE_ROWS * 128 + 1]


@pytest.fixture(scope="module", params=sorted(TAPES))
def pair(request):
    make = TAPES[request.param]
    (rt, vec), (pt, _) = make(ref), make(port)
    return RefBulk(rt, interpret=True), BulkEvaluator(pt, device="cpu"), vec


def _points(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1.2, 1.2, n).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n", SIZES)
def test_eval_and_signs_match_reference(pair, n):
    rev, pev, vec = pair
    x, y, z = _points(n, n)
    want = np.asarray(rev.eval(x, y, z, vec))
    got = pev.eval(x, y, z, vec)
    assert got.shape == (1, n) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    signs = pev.eval(x, y, z, vec, signs=True)
    assert signs.dtype == torch.bool
    np.testing.assert_array_equal(
        signs.numpy(), np.asarray(rev.eval(x, y, z, vec, signs=True))
    )


@pytest.mark.parametrize("n", SIZES[:2])
def test_eval_interval_matches_reference(pair, n):
    rev, pev, vec = pair
    rng = np.random.default_rng(100 + n)
    lo = _points(n, n + 1)
    w = [rng.uniform(0, 0.3, n).astype(np.float32) for _ in range(3)]
    ivs = [(a, a + d) for a, d in zip(lo, w)]
    (r_lo, r_hi), r_choices, (r_s0, _) = rev.eval_interval(*ivs, vec,
                                                           capture=True)
    (p_lo, p_hi), p_choices, (p_s0, p_n) = pev.eval_interval(*ivs, vec,
                                                             capture=True)
    assert (p_s0, p_n) == (LANE_ROWS, n)
    np.testing.assert_allclose(p_lo.numpy(), np.asarray(r_lo), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(p_hi.numpy(), np.asarray(r_hi), rtol=1e-5, atol=1e-6)
    # choice words per lane, [CW, lanes] on both sides
    def per_lane(c):
        c = np.asarray(c)
        return np.moveaxis(c, 1, 0).reshape(c.shape[1], -1)[:, :n]

    np.testing.assert_array_equal(per_lane(p_choices.numpy()),
                                  per_lane(r_choices))
    np.testing.assert_array_equal(
        pev.eval_interval(*ivs, vec, classify=True).numpy(),
        np.asarray(rev.eval_interval(*ivs, vec, classify=True)),
    )


@pytest.mark.parametrize("n", SIZES[:2])
def test_eval_grad_matches_reference(pair, n):
    rev, pev, vec = pair
    x, y, z = _points(n, 7 * n)
    want = np.asarray(rev.eval_grad(x, y, z, vec))
    got = pev.eval_grad(x, y, z, vec)
    assert got.shape == (1, 4, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_attributes_and_tape_copies():
    """The reference's attributes; the port packs under the tape's
    frequency order with the tape's own registers, and copies the tape
    over a power-of-two instance count with the unused instances at
    length 0."""
    pt, vec = _with_var(port)
    ev = BulkEvaluator(pt, device="cpu")
    assert ev.nf == pt.reg_count + pt.mem_count
    assert ev.n_inputs == 3 and ev.n_outputs == 1 and ev.c_words == 1
    assert set(ev.axis_of) == {"x", "y", "v"}
    assert ev.op_order is not None and ev.packed.w1.shape == (1, len(pt))
    w1, w2, imm, lens = ev.tape_args(4, 3)
    assert w1.shape == (4, len(pt)) and w1.is_contiguous()
    assert lens.tolist() == [len(pt)] * 3 + [0]
    c = BulkEvaluator(_constant(port)[0], device="cpu")
    assert c.n_inputs == 1 and not c.axis_of


def test_cpu_evaluator_launches_no_kernel_and_cuda_is_default():
    pt, _ = _sphere_box(port)
    cuda.reset_launches()
    BulkEvaluator(pt, device="cpu").eval(*_points(10, 0))
    assert sum(cuda.LAUNCHES.values()) == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BulkEvaluator(pt)
