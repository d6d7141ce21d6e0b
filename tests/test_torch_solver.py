"""The port's least-squares solver held to `fidget_tpu.solver` on the CPU.

Each case builds its equations in both packages from one recipe and
solves them from the same start: solutions agree within 1e-4 and the
residuals at the solutions within 1e-5. The port's passes run the plain
versions of K3 and K4 here (`device="cpu"`).
"""

import numpy as np
import pytest

import fidget_tpu as ref
import fidget_tpu.solver as ref_solver
import fidget_tpu_torch as port
import fidget_tpu_torch.solver as port_solver
from fidget_tpu_torch.scenes import chain_system, linkage_system

SOL_ATOL = 1e-4
RES_ATOL = 1e-5


def _basic(pkg):
    eq = pkg.Tree.x() + pkg.Tree.y()
    return [eq], {pkg.Var.X: (0.0, True), pkg.Var.Y: (-1.0, False)}


def _four_vars(pkg):
    vs = [pkg.Var.new() for _ in range(4)]
    root = pkg.Tree.var(vs[0])
    for v in vs[1:]:
        root = root + pkg.Tree.var(v)
    return [root], {v: (float(i), True) for i, v in enumerate(vs)}


def _two_circles(pkg):
    # a point on two circles: |p| = 1 and |p - (2, 0)| = 1 -> (1, 0)
    px, py = pkg.Var.new(), pkg.Var.new()
    x, y = pkg.Tree.var(px), pkg.Tree.var(py)
    c1 = (x.square() + y.square()).sqrt() - 1.0
    c2 = ((x - 2.0).square() + y.square()).sqrt() - 1.0
    return [c1, c2], {px: (0.5, True), py: (0.5, True)}


def _abs_kink(pkg):
    # |x| - 0.5 from x = 0: the partial at the kink is finite (0 or the
    # sign), so both packages step away from it to the same root
    a = pkg.Var.new()
    return [pkg.Tree.var(a).abs() - 0.5], {a: (0.0, True)}


RECIPES = {
    "basic": _basic,
    "four_vars": _four_vars,
    "two_circles": _two_circles,
    "linkage": linkage_system,
    "chain32": lambda pkg: chain_system(pkg, 32),
    "abs_kink": _abs_kink,
}


def _params(mod, start):
    return {
        v: mod.Parameter.Free(x) if free else mod.Parameter.Fixed(x)
        for v, (x, free) in start.items()
    }


@pytest.mark.parametrize("name", list(RECIPES))
def test_solution_matches_reference(name):
    eqs_r, start_r = RECIPES[name](ref)
    eqs_p, start_p = RECIPES[name](port)
    sol_r = ref_solver.solve(eqs_r, _params(ref_solver, start_r))
    sol_p = port_solver.solve(eqs_p, _params(port_solver, start_p),
                              device="cpu")
    free_r = [v for v, (_, f) in start_r.items() if f]
    free_p = [v for v, (_, f) in start_p.items() if f]
    assert set(sol_r) == set(free_r) and set(sol_p) == set(free_p)
    x_r = np.array([sol_r[v] for v in free_r])
    x_p = np.array([sol_p[v] for v in free_p])
    np.testing.assert_allclose(x_p, x_r, rtol=0, atol=SOL_ATOL)

    # residuals at each package's solution, each through its own
    # package's evaluator: the reference's straight-line float pass and
    # the port's K3 pass
    fixed_r = [v for v, (_, f) in start_r.items() if not f]
    fixed_p = [v for v, (_, f) in start_p.items() if not f]
    sr = ref_solver.Solver(eqs_r, free=free_r, fixed=fixed_r)
    fv_r = np.asarray([start_r[v][0] for v in fixed_r] or [0.0], np.float32)
    res_r = np.asarray(sr._res(x_r.astype(np.float32), fv_r), np.float64)
    sp = port_solver.Solver(eqs_p, free_p, fixed_p, device="cpu")
    sp._fixed.copy_(port_solver.torch.from_numpy(
        np.asarray([start_p[v][0] for v in fixed_p], np.float32)))
    res_p = sp.residuals(x_p.astype(np.float32))
    np.testing.assert_allclose(res_p, res_r, rtol=0, atol=RES_ATOL)
    assert np.abs(res_p).max() <= np.abs(res_r).max() + RES_ATOL


def test_basic_solver():
    eqn = port.Tree.x() + port.Tree.y()
    sol = port_solver.solve(
        [eqn],
        {port.Var.X: port_solver.Parameter.Free(0.0),
         port.Var.Y: port_solver.Parameter.Fixed(-1.0)},
        device="cpu",
    )
    assert set(sol) == {port.Var.X}
    assert sol[port.Var.X] == pytest.approx(1.0, abs=1e-5)


def test_fixed_only_returns_empty():
    P = port_solver.Parameter
    assert port_solver.solve([port.Tree.x()], {port.Var.X: P.Fixed(2.0)},
                             device="cpu") == {}
    assert ref_solver.solve([ref.Tree.x()],
                            {ref.Var.X: ref_solver.Parameter.Fixed(2.0)}) == {}


@pytest.mark.parametrize("mod,pkg,kw", [
    (ref_solver, ref, {}), (port_solver, port, {"device": "cpu"}),
], ids=["reference", "port"])
def test_unbound_variable_raises(mod, pkg, kw):
    with pytest.raises(ValueError, match="unbound variable"):
        mod.solve([pkg.Tree.x() + pkg.Tree.y()],
                  {pkg.Var.X: mod.Parameter.Free(0.0)}, **kw)


@pytest.mark.parametrize("mod,pkg,kw", [
    (ref_solver, ref, {}), (port_solver, port, {"device": "cpu"}),
], ids=["reference", "port"])
def test_constant_equation_raises(mod, pkg, kw):
    a = pkg.Var.new()
    with pytest.raises(ValueError, match="constant"):
        mod.solve([pkg.Tree.constant(1.0), pkg.Tree.var(a)],
                  {a: mod.Parameter.Free(0.0)}, **kw)


def test_role_change_raises():
    P = port_solver.Parameter
    a, b = port.Var.new(), port.Var.new()
    s = port_solver.Solver([port.Tree.var(a) - port.Tree.var(b)],
                           free=[a], fixed=[b], device="cpu")
    with pytest.raises(ValueError, match="structurally free"):
        s.solve({a: P.Fixed(0.0), b: P.Fixed(1.0)})
    with pytest.raises(ValueError, match="structurally fixed"):
        s.solve({a: P.Free(0.0), b: P.Free(1.0)})


def _drag_system(pkg):
    px, py, ax = pkg.Var.new(), pkg.Var.new(), pkg.Var.new()
    x, y, a = pkg.Tree.var(px), pkg.Tree.var(py), pkg.Tree.var(ax)
    c1 = ((x - a).square() + y.square()).sqrt() - 1.0
    c2 = (x.square() + y.square()).sqrt() - 1.0
    return (px, py, ax), [c1, c2]


def test_reusable_solver_matches_reference():
    """The interactive-drag pattern: fixed values change between solves
    of one Solver."""
    (px, py, ax), eqs = _drag_system(port)
    (rx, ry, rax), reqs = _drag_system(ref)
    s = port_solver.Solver(eqs, free=[px, py], fixed=[ax], device="cpu")
    sr = ref_solver.Solver(reqs, free=[rx, ry], fixed=[rax])
    P, RP = port_solver.Parameter, ref_solver.Parameter
    for anchor, expect_x in [(1.0, 0.5), (0.5, 0.25)]:
        sol = s.solve({px: P.Free(0.3), py: P.Free(0.8), ax: P.Fixed(anchor)})
        want = sr.solve({rx: RP.Free(0.3), ry: RP.Free(0.8),
                         rax: RP.Fixed(anchor)})
        assert sol[px] == pytest.approx(expect_x, abs=1e-3)
        np.testing.assert_allclose(
            [sol[px], sol[py]], [want[rx], want[ry]], rtol=0, atol=SOL_ATOL
        )


def test_reused_solver_packs_and_uploads_nothing(monkeypatch):
    """A second solve of one Solver packs no tape and uploads no arena:
    only the fixed values are rewritten in place."""
    calls = {"pack": 0, "upload": 0}
    pack, to_device = port_solver.pack_tapes, port_solver._to_device

    def counting_pack(*a, **k):
        calls["pack"] += 1
        return pack(*a, **k)

    def counting_upload(a, device):
        if a.ndim == 2:  # the arena words and the routing tables
            calls["upload"] += 1
        return to_device(a, device)

    monkeypatch.setattr(port_solver, "pack_tapes", counting_pack)
    monkeypatch.setattr(port_solver, "_to_device", counting_upload)
    (px, py, ax), eqs = _drag_system(port)
    s = port_solver.Solver(eqs, free=[px, py], fixed=[ax], device="cpu")
    assert calls == {"pack": 1, "upload": 5}
    fixed = s._fixed
    P = port_solver.Parameter
    for anchor in (1.0, 0.5):
        s.solve({px: P.Free(0.3), py: P.Free(0.8), ax: P.Fixed(anchor)})
        assert calls == {"pack": 1, "upload": 5}
        assert s._fixed is fixed and float(fixed[0]) == anchor


def test_solve_caches_solver_per_equation_set():
    px = port.Var.new()
    eq = (port.Tree.var(px) - 2.0).square() - 1.0
    P = port_solver.Parameter
    port_solver._SOLVE_CACHE.clear()
    s1 = port_solver.solve([eq], {px: P.Free(0.0)}, device="cpu")
    assert len(port_solver._SOLVE_CACHE) == 1
    cached = next(iter(port_solver._SOLVE_CACHE.values()))
    s2 = port_solver.solve([eq], {px: P.Free(5.0)}, device="cpu")
    assert next(iter(port_solver._SOLVE_CACHE.values())) is cached
    assert len(port_solver._SOLVE_CACHE) == 1
    assert s1[px] == pytest.approx(1.0, abs=1e-3)
    assert s2[px] == pytest.approx(3.0, abs=1e-3)
    # the device is part of the key
    (key,) = port_solver._SOLVE_CACHE
    assert key[-1] == "cpu"


def test_sqrt_kink_raises_in_both():
    """sqrt(x) - 0.5 from x = 0: the partial there is infinite; the
    reference's jacfwd keeps it and its step fails, and so must the
    port's (its Jacobian keeps non-finite partials)."""
    for pkg, mod, kw in ((ref, ref_solver, {}),
                         (port, port_solver, {"device": "cpu"})):
        a = pkg.Var.new()
        with pytest.raises(mod.SingularMatrix):
            mod.solve([pkg.Tree.var(a).sqrt() - 0.5],
                      {a: mod.Parameter.Free(0.0)}, **kw)


def test_jacobian_matches_reference_jacfwd():
    """The K4 Jacobian equals the reference's jacfwd at the start of the
    linkage, column for column (two K4 passes: four inputs a tape)."""
    eqs_r, start_r = linkage_system(ref)
    eqs_p, start_p = linkage_system(port)
    free_r = [v for v, (_, f) in start_r.items() if f]
    fixed_r = [v for v, (_, f) in start_r.items() if not f]
    free_p = [v for v, (_, f) in start_p.items() if f]
    fixed_p = [v for v, (_, f) in start_p.items() if not f]
    sr = ref_solver.Solver(eqs_r, free=free_r, fixed=fixed_r)
    sp = port_solver.Solver(eqs_p, free_p, fixed_p, device="cpu")
    cur = np.array([start_p[v][0] for v in free_p], np.float32)
    fv = np.zeros(len(fixed_r), np.float32)
    want = np.asarray(sr._jac(cur, fv), np.float64)
    np.testing.assert_allclose(sp.jacobian(cur), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        sp.residuals(cur), np.asarray(sr._res(cur, fv)), rtol=0,
        atol=RES_ATOL,
    )


def test_solver_without_device_raises_without_card(monkeypatch):
    """The solver runs on the card unless the caller names the CPU; with
    no card it raises and never falls back."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = port.Var.new()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.solve([port.Tree.var(a) - 1.0],
                   {a: port_solver.Parameter.Free(0.0)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_solver.Solver([port.Tree.var(a) - 1.0], [a], [])
