"""Least-squares solver for systems of equations.

The counterpart of `fidget_tpu.solver`, the analog of `fidget-solver`
(fidget-solver/src/lib.rs:191-288): a basic Levenberg-Marquardt
minimizer over a set of scalar constraint functions of `Var`s.

The equation tapes are packed once per `Solver` into one arena, an
instance per equation (compiler/pack.py). The residuals are one float
pass over it (K3, `interp_float`); the Jacobian takes ceil(V / 3)
dual-number passes (K4, `interp_grad`), each seeding three inputs of
every tape, as the Rust reference packs three forward-mode gradients
per Grad lane (lib.rs:107-146). Each instance evaluates one live lane.
The damping loop runs on the host in float64, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..compiler.lower import lower
from ..compiler.pack import pack_tapes
from ..compiler.tape import Tape, tape_key
from ..core.context import Context
from ..core.tree import Tree, import_tree
from ..core.var import Var
from ..eval.cuda import resolve_device
from ..eval.interp import interp_float, interp_grad

__all__ = ["Parameter", "SingularMatrix", "Solver", "solve"]

#: lanes of one instance's input plane (S0 = 1); lane 0 is the live one
_LANES = 128


@dataclass(frozen=True)
class Parameter:
    """Free (optimized, with a starting position) or Fixed input."""

    value: float
    free: bool

    @staticmethod
    def Free(v: float) -> "Parameter":
        return Parameter(float(v), True)

    @staticmethod
    def Fixed(v: float) -> "Parameter":
        return Parameter(float(v), False)


class SingularMatrix(RuntimeError):
    pass


def _as_tape(eq) -> Tape:
    if isinstance(eq, Tape):
        return eq
    if isinstance(eq, Tree):
        ctx = Context()
        return lower(ctx, [import_tree(ctx, eq)])
    raise TypeError(f"cannot solve over {type(eq).__name__}")


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array copied to the solver's device."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class Solver:
    """Reusable LM solver for one equation set + free/fixed structure.

    Built once, solved many times with changing values (interactive
    constraint dragging): the arena and the routing of values into each
    equation's inputs are packed and uploaded once; fixed-variable
    values live in a device tensor that each solve rewrites.

    device: where the passes run; None means CUDA, and raises when
    there is no card. Pass "cpu" to run the plain PyTorch versions.
    """

    def __init__(self, eqs: list, free: list, fixed: list, *, device=None):
        self.tapes = [_as_tape(e) for e in eqs]
        self.free = list(free)
        self.fixed = list(fixed)
        known = set(self.free) | set(self.fixed)
        for k, t in enumerate(self.tapes):
            if not len(t.var_map):
                # a constant equation (possibly by Context folding,
                # e.g. x - x) has no gradient and cannot be solved for
                raise ValueError(
                    f"equation {k} is constant (no variables) — it "
                    "cannot constrain anything"
                )
            for v in t.var_map:
                if v not in known:
                    raise ValueError(f"equation uses unbound variable {v!r}")
        self.device = resolve_device(device)
        idx = {v: i for i, v in enumerate(self.free)}
        fidx = {v: i for i, v in enumerate(self.fixed)}
        n_free, n_fixed = len(self.free), len(self.fixed)
        if not self.tapes:
            raise ValueError("no equations to solve")
        packed = pack_tapes(self.tapes)
        E = len(self.tapes)
        V = max(1, packed.n_inputs)
        # values vector of a pass: [cur (n_free), fixed (n_fixed), 0];
        # src[t, i] picks input i of equation t from it, and col[t, i]
        # is its Jacobian column (n_free: no column, a fixed input or an
        # unused slot)
        src = np.full((E, V), n_free + n_fixed, np.int64)
        col = np.full((E, V), n_free, np.int64)
        for t, tape in enumerate(self.tapes):
            for v, i in tape.var_map.items():
                if v in idx:
                    src[t, i] = col[t, i] = idx[v]
                else:
                    src[t, i] = n_free + fidx[v]
        dev = self.device
        self.E, self.V = E, V
        self.nf = packed.nf
        self._arena = tuple(
            _to_device(a, dev)
            for a in (packed.w1, packed.w2, packed.imm, packed.lengths)
        )
        self._src = _to_device(src, dev)
        self._col = _to_device(col, dev)
        self._fixed = torch.zeros(n_fixed, dtype=torch.float32, device=dev)
        self._pad = torch.zeros(1, dtype=torch.float32, device=dev)

    def _planes(self, cur: torch.Tensor) -> torch.Tensor:
        """[E, V, 1, 128] input planes of every equation at `cur`."""
        vals = torch.cat([cur, self._fixed, self._pad])[self._src]
        return vals[:, :, None, None].expand(self.E, self.V, 1, _LANES)

    def residuals(self, cur: np.ndarray) -> np.ndarray:
        """Every equation's value at the free values `cur` (f32 [n_free]),
        as float64: one K3 pass."""
        planes = self._planes(_to_device(cur, self.device)).contiguous()
        with torch.no_grad():
            out = interp_float(
                *self._arena, planes, nf=self.nf, n_inputs=self.V,
                n_outputs=1, s0=1,
            )
        return out[:, 0, 0, 0].double().cpu().numpy()

    def jacobian(self, cur: np.ndarray) -> np.ndarray:
        """J [E, n_free] at `cur`, float64: ceil(V / 3) K4 passes, each
        seeding one-hot tangents on three inputs of every equation.
        Partials that are not finite stay so (a kink makes the step
        non-finite, and the loop raises `SingularMatrix`, as the
        reference's `jacfwd` does)."""
        E, V = self.E, self.V
        planes = self._planes(_to_device(cur, self.device))
        cols = []
        for i0 in range(0, V, 3):
            kk = min(3, V - i0)
            duals = planes.new_zeros((E, V, 4, 1, _LANES))
            duals[:, :, 0] = planes
            for c in range(kk):
                duals[:, i0 + c, 1 + c] = 1.0
            g = interp_grad(
                *self._arena, duals, nf=self.nf, n_inputs=V, n_outputs=1,
                s0=1,
            )
            cols.append(g[:, 0, 1:1 + kk, 0, 0])
        partials = torch.cat(cols, dim=1)  # [E, V]: d r_t / d input i
        J = partials.new_zeros((E, len(self.free) + 1))
        J.scatter_(1, self._col, partials)
        return J[:, :-1].double().cpu().numpy()

    def solve(
        self, vars: dict[Var, Parameter], *, max_iters: int = 100
    ) -> dict[Var, float]:
        free, fixed = self.free, self.fixed
        for v in free:
            if not vars[v].free:
                raise ValueError(
                    f"{v!r} is Fixed but structurally free in this Solver; "
                    "build a new Solver when roles change"
                )
        for v in fixed:
            if vars[v].free:
                raise ValueError(
                    f"{v!r} is Free but structurally fixed in this Solver; "
                    "build a new Solver when roles change"
                )
        idx = {v: i for i, v in enumerate(free)}
        cur = np.array([vars[v].value for v in free], np.float32)
        if not free:
            return {}
        self._fixed.copy_(torch.from_numpy(
            np.array([vars[v].value for v in fixed], np.float32)
        ))
        return _lm_loop(self.residuals, self.jacobian, cur, idx, max_iters)


_SOLVE_CACHE: dict = {}
_SOLVE_CACHE_MAX = 64


def solve(
    eqs: list,
    vars: dict[Var, Parameter],
    *,
    max_iters: int = 100,
    device=None,
) -> dict[Var, float]:
    """Minimizes sum of squares of `eqs` over the free variables.

    Levenberg-Marquardt with multiplicative damping adaptation, exit
    criteria matching the reference (zero residual, no position change,
    or a flat 4-sample error history; lib.rs:236-279).

    Solvers are cached per (equation set, free/fixed structure,
    device), so interactive constraint dragging — repeated solves with
    the same equations and changing values — packs and uploads the
    equations once.

    Solve a - 1 = 0 with `a` free (the reference's doc example,
    fidget-solver/src/lib.rs):

    >>> from fidget_tpu_torch import Tree, Var
    >>> from fidget_tpu_torch.solver import Parameter, solve
    >>> a = Var.new()
    >>> eq = Tree.var(a) - 1.0
    >>> out = solve([eq], {a: Parameter.Free(0.0)}, device="cpu")
    >>> round(float(out[a]), 4)
    1.0
    """
    free = [v for v, p in vars.items() if p.free]
    fixed = [v for v, p in vars.items() if not p.free]
    tapes = [_as_tape(e) for e in eqs]
    dev = resolve_device(device)
    key = (
        tuple(tape_key(t) for t in tapes), tuple(free), tuple(fixed),
        str(dev),
    )
    solver = _SOLVE_CACHE.get(key)
    if solver is None:
        if len(_SOLVE_CACHE) >= _SOLVE_CACHE_MAX:
            _SOLVE_CACHE.pop(next(iter(_SOLVE_CACHE)))
        solver = Solver(tapes, free, fixed, device=dev)
        _SOLVE_CACHE[key] = solver
    return solver.solve(vars, max_iters=max_iters)


def _lm_loop(res_f, jac_f, cur, idx, max_iters):

    free = list(idx)
    damping = 1.0
    prev_err = np.inf
    err_buf = np.full(4, np.nan, np.float64)
    for it in range(max_iters):
        r = res_f(cur)
        if (r == 0.0).all():
            break
        J = jac_f(cur)
        jt_j = J.T @ J
        jt_r = J.T @ r
        # inner loop: grow damping until the step reduces the error
        # (bounded; a persistently error-increasing step is rejected)
        accepted = False
        for _inner in range(60):
            adjusted = jt_j + damping * np.diag(np.diag(jt_j))
            try:
                delta, *_ = np.linalg.lstsq(adjusted, jt_r, rcond=None)
            except np.linalg.LinAlgError as e:
                raise SingularMatrix(str(e)) from e
            if not np.isfinite(delta).all():
                raise SingularMatrix("non-finite step")
            err = float(
                np.square(res_f((cur - delta).astype(np.float32))).sum()
            )
            if err > prev_err:
                damping *= 1.5
            else:
                damping /= 3.0
                accepted = True
                break
        if not accepted:
            break  # no damping reduces the error: stay at cur
        new = (cur - delta).astype(np.float32)
        changed = (new != cur).any()
        cur = new
        err_buf[it % 4] = err
        if (
            not changed
            or err == 0.0
            or damping == 0.0
            or (np.isfinite(err_buf).all() and (err_buf == err_buf[0]).all())
        ):
            break
        prev_err = err

    return {v: float(cur[idx[v]]) for v in free}
