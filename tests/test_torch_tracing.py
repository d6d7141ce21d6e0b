"""The port's span recorder and counters (`fidget_tpu_torch.utils`): how
spans nest and what they keep, the clock they share with
`torch.profiler`, and the counters a fitting step and a kernel build
leave, on the CPU."""

import sys
import threading

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

import fidget_tpu_torch as port
from fidget_tpu_torch import utils
from fidget_tpu_torch.eval import unrolled_cuda as uc
from fidget_tpu_torch.parallel import sharding as sh

N = 64
#: how far the profiler's stamp of an event may fall outside the
#: recorder's around it (its clock is converted to the same scale)
SLACK_NS = 20_000


@pytest.fixture
def rec():
    utils.reset()
    yield utils.RECORDER
    utils.reset()


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    """A process group of one gloo rank, for `fit_step` at world 1."""
    own = not dist.is_initialized()
    if own:
        store = tmp_path_factory.mktemp("store") / "store"
        dist.init_process_group("gloo", store=dist.FileStore(str(store), 1),
                                rank=0, world_size=1)
    yield sh.make_mesh(device="cpu")
    if own:
        dist.destroy_process_group()


def _circle():
    """A circle of radius 0.5 + grow shifted by shift along x: the tape's
    inputs are x, y, shift and grow."""
    ctx = port.Context()
    shift, grow = port.Var.new(), port.Var.new()
    x = ctx.sub(ctx.x(), ctx.input(shift))
    d = ctx.sqrt(ctx.add(ctx.square(x), ctx.square(ctx.y())))
    root = ctx.sub(ctx.sub(d, 0.5), ctx.input(grow))
    return port.lower(ctx, [root]), shift, grow


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_spans_nest_with_parents_and_totals(rec):
    with utils.span("outer", request=True):
        with utils.span("inner"):
            with utils.span("leaf"):
                pass
        with utils.span("inner"):
            pass
    with utils.span("alone"):
        pass
    snap = utils.snapshot()
    spans = {s.name: s for s in snap["spans"]}
    outer, leaf = spans["outer"], spans["leaf"]
    inner = _by_name(snap["spans"], "inner")
    assert outer.parent == 0 and outer.request == outer.id
    assert all(s.parent == outer.id and s.request == outer.id for s in inner)
    assert leaf.parent == inner[0].id and leaf.request == outer.id
    assert spans["alone"].parent == 0 and spans["alone"].request == 0
    for s in snap["spans"]:
        assert s.start_ns <= s.end_ns and not s.profiled
    assert outer.start_ns <= inner[0].start_ns <= leaf.start_ns
    assert leaf.end_ns <= inner[0].end_ns <= inner[1].start_ns
    assert inner[1].end_ns <= outer.end_ns
    n, ns = snap["totals"]["inner"]
    assert n == 2 and ns == sum(s.end_ns - s.start_ns for s in inner)
    assert snap["launches"] is port.eval.cuda.LAUNCHES


def test_ring_is_bounded_and_totals_keep_all():
    r = utils.Recorder()
    n = utils.RING + 20
    for _ in range(n):
        with r.span("a"):
            pass
    snap = r.snapshot()
    assert len(snap["spans"]) == utils.RING and snap["totals"]["a"][0] == n
    ids = [s.id for s in snap["spans"]]
    assert ids == sorted(ids) and ids[-1] - ids[0] == utils.RING - 1
    r.reset()
    assert r.snapshot()["spans"] == [] and r.snapshot()["totals"] == {}


def test_decorator_and_timed_record_spans(rec):
    @utils.span("fidget.test.call")
    def f(a, b=1):
        """Doc."""
        with utils.span("fidget.test.body"):
            return a + b

    assert f(1, b=2) == 3 and f.__doc__ == "Doc." and f(0) == 1
    got = []
    with utils.timed("fidget.test.timed", sink=got.append) as t:
        pass
    snap = utils.snapshot()
    calls = _by_name(snap["spans"], "fidget.test.call")
    bodies = _by_name(snap["spans"], "fidget.test.body")
    assert len(calls) == 2
    assert [b.parent for b in bodies] == [c.id for c in calls]
    (s,) = _by_name(snap["spans"], "fidget.test.timed")
    assert t["seconds"] == (s.end_ns - s.start_ns) * 1e-9
    assert t["label"] == "fidget.test.timed" and got == [t]


def test_counters_take_ints_and_tensors_read_later(rec):
    utils.count("a")
    utils.count("a", 4, per=3)
    mask = torch.tensor([True, False, True])
    utils.count("b", mask, per=10)
    # enough tensor counts that they are summed where they lie
    for _ in range(utils.PENDING + 5):
        utils.count("c", torch.ones(2, dtype=torch.bool))
    c = utils.snapshot()["counters"]
    assert c["a"] == 13 and c["b"] == 20
    assert c["c"] == 2 * (utils.PENDING + 5)
    utils.count("b", mask)
    assert utils.snapshot()["counters"]["b"] == 22  # read once each


def test_threads_keep_their_own_stacks_under_contention():
    r = utils.Recorder()
    n_threads, n_spans = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n_spans):
                with r.span("req", request=True):
                    with r.span("child"):
                        r.count("n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = r.snapshot()
    total = n_threads * n_spans
    assert snap["counters"]["n"] == total
    assert snap["totals"]["req"][0] == snap["totals"]["child"][0] == total
    reqs = {s.id for s in snap["spans"] if s.name == "req"}
    for s in snap["spans"]:
        if s.name == "child":
            assert s.parent in reqs and s.request == s.parent
        else:
            assert s.parent == 0 and s.request == s.id


def test_spans_share_the_profilers_clock(rec):
    """A span under `torch.profiler` is a host event of the same name in
    its trace, not a user range (which the profiler mirrors on the
    device's timeline); the recorder's stamps bracket it and the op
    inside it, on the profiler's `start_ns()` scale."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with utils.span("fidget.test.clock"):
            torch.ones(64).mul_(2)
    (s,) = _by_name(utils.snapshot()["spans"], "fidget.test.clock")
    assert s.profiled
    events = list(prof.profiler.kineto_results.events())
    (ev,) = [e for e in events if e.name() == "fidget.test.clock"]
    (op,) = [e for e in events if e.name() == "aten::mul_"]
    assert not ev.is_user_annotation()
    ev0, ev1 = ev.start_ns(), ev.start_ns() + ev.duration_ns()
    op0, op1 = op.start_ns(), op.start_ns() + op.duration_ns()
    assert s.start_ns - SLACK_NS <= ev0 <= op0 <= op1 <= ev1
    assert ev1 <= s.end_ns + SLACK_NS
    assert ev0 - s.start_ns < 1_000_000 and s.end_ns - ev1 < 1_000_000
    # with the profiler off, a span is no event and says so
    with utils.span("fidget.test.off"):
        pass
    assert not _by_name(utils.snapshot()["spans"], "fidget.test.off")[0] \
        .profiled


@pytest.mark.parametrize("pipeline", ["unrolled", "interp"])
def test_fit_step_records_a_request_and_its_counts(rec, mesh, pipeline):
    """One step at 64^2 over its 4,096 lanes: the unrolled leaf seeds
    the two shape parameters alone, one K4 pass of two tangents, all of
    them kept; the interpreter differentiates in all four inputs, passes
    of three tangents and one, of which the shape parameters' columns
    reach the gradient. A second step with the same tape builds no
    renderer."""
    computed = {"unrolled": 2, "interp": 3 + 1}[pipeline] * N * N
    tape, shift, grow = _circle()
    size = port.ImageSize(N, N)
    target = torch.zeros(N, N)
    params = {shift: 0.1, grow: 0.05}
    sh._RENDERERS.clear()
    sh.fit_step(tape, size, mesh, params, target, pipeline=pipeline)
    snap = utils.snapshot()
    c = snap["counters"]
    assert c["renderers.built"] == 1
    assert c["jacobian.tangents_computed"] == computed
    assert c["jacobian.tangents_kept"] == 2 * N * N
    (step,) = _by_name(snap["spans"], "fidget.fit_step")
    assert step.request == step.id and step.parent == 0
    inside = [s for s in snap["spans"] if s.request == step.id]
    stages = ["fidget.fit.prep", "fidget.fit.forward", "fidget.fit.backward",
              "fidget.fit.reduce"]
    assert [s.name for s in inside if s.parent == step.id] == stages
    (reduce_,) = _by_name(inside, "fidget.fit.reduce")
    waits = _by_name(inside, "fidget.fit.wait")
    assert len(waits) == 2 and all(w.parent == reduce_.id for w in waits)
    (init,) = _by_name(inside, "fidget.renderer.init")
    assert init.parent == _by_name(inside, "fidget.fit.prep")[0].id
    sh.fit_step(tape, size, mesh, params, target, pipeline=pipeline)
    c = utils.snapshot()["counters"]
    assert c["renderers.built"] == 1
    assert c["jacobian.tangents_computed"] == 2 * computed
    assert c["jacobian.tangents_kept"] == 2 * 2 * N * N
    requests = {s.request for s in utils.snapshot()["spans"]
                if s.name.startswith("fidget.fit")}
    assert len(requests) == 2


def test_interp_rows_count_real_lanes_and_all_computed(rec, mesh):
    """At 48 x 40 the interpreter's lanes are padded to 2,048: K4
    computes the padding in passes of three tangents and one, the
    gradient keeps the 1,920 real lanes."""
    tape, shift, grow = _circle()
    size = port.ImageSize(48, 40)
    sh.fit_step(tape, size, mesh, {shift: 0.1, grow: 0.0},
                torch.zeros(40, 48), pipeline="interp")
    c = utils.snapshot()["counters"]
    assert c["jacobian.tangents_computed"] == (3 + 1) * 2048
    assert c["jacobian.tangents_kept"] == 2 * 48 * 40


def test_lower_and_kernel_emit_are_spans(rec):
    tape, _, _ = _circle()
    kern = uc.FloatKernel([tape], {"x": 0, "y": 1}, 4)
    unit = kern.unit()
    assert kern.unit() is unit  # emitted once
    names = [s.name for s in utils.snapshot()["spans"]]
    assert names.count("fidget.lower") == 1
    assert names.count("fidget.kernels.emit") == 1
    port.eval.cuda.source_hash()
    names = [s.name for s in utils.snapshot()["spans"]]
    assert names.count("fidget.kernels.emit") == 2
