"""Shape API: binding expression graphs to spatial axes + transforms.

The counterpart of `fidget_tpu.shape`, itself the analog of the
reference's `Shape`/`ShapeVars`/`BoundShape`
(fidget-core/src/shape/mod.rs:44-176, :190-250, :810-891) and of
`Transformable` (shape/mod.rs:894-948): a `Shape` owns an expression
(context + root node), an optional homogeneous 4x4 transform applied to
the X/Y/Z inputs before evaluation, and lowers lazily to a register
`Tape`. `ShapeVars` supplies values for custom (`Var.new()`) inputs;
`BoundShape` is the pair validated at construction.

Unlike the reference — where each evaluator kind (point / interval /
float-slice / grad-slice) is a separate trait object — evaluation here
is always bulk, so the Shape exposes three vectorized entry points:
`eval`, `eval_interval`, `eval_grad`. They run on the host with numpy
through `eval_tape`; the renderers take the Shape's tape and transform
and evaluate on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..compiler.lower import lower
from ..compiler.tape import Tape, TapeOp
from ..core.context import Context
from ..core.tree import Tree, import_tree
from ..core.var import Var
from ..eval.arith import FloatMode, GradMode, IntervalMode
from ..eval.unrolled import eval_tape

__all__ = ["Shape", "ShapeVars", "BoundShape"]


class ShapeVars:
    """Values for custom variables (the reference's `ShapeVars<F>`,
    fidget-core/src/shape/mod.rs:190-250). Values may be scalars or
    arrays broadcastable against the evaluation lanes."""

    def __init__(self, values: dict[Var, float] | None = None):
        self._values: dict[Var, object] = dict(values or {})

    def __setitem__(self, v: Var, value) -> None:
        if v.kind != "v":
            raise ValueError("ShapeVars only binds custom vars, not axes")
        self._values[v] = value

    def __getitem__(self, v: Var):
        return self._values[v]

    def __contains__(self, v: Var) -> bool:
        return v in self._values

    def __len__(self) -> int:
        return len(self._values)

    def items(self):
        return self._values.items()


def _as_mat4(mat) -> np.ndarray:
    m = np.asarray(mat, dtype=np.float64)
    if m.shape != (4, 4):
        raise ValueError(f"expected a 4x4 homogeneous matrix, got {m.shape}")
    return m


class Shape:
    """An implicit surface: expression + axis bindings + 4x4 transform.

    Mirrors fidget's `Shape<F>` (fidget-core/src/shape/mod.rs:44-176):
    the transform maps *evaluation-space* points to *model-space* points
    fed to the expression, and composes under `apply_transform`.

    >>> from fidget_tpu_torch import Tree
    >>> from fidget_tpu_torch.shape import Shape
    >>> x, y, z = Tree.axes()
    >>> s = Shape.from_tree((x.square() + y.square()).sqrt() - 0.5)
    >>> s.tape().output_count
    1
    """

    def __init__(
        self,
        ctx: Context,
        node: int,
        transform: np.ndarray | None = None,
    ):
        self.ctx = ctx
        self.node = node
        self.transform = None if transform is None else _as_mat4(transform)
        self._tape: Tape | None = None

    # -- constructors ---------------------------------------------------

    @classmethod
    def from_tree(cls, tree: Tree) -> "Shape":
        ctx = Context()
        return cls(ctx, import_tree(ctx, tree))

    # -- transforms -----------------------------------------------------

    def apply_transform(self, mat) -> "Shape":
        """Returns a new Shape whose transform is `self.transform @ mat`
        (matching Shape::apply_transform composition order,
        fidget-core/src/shape/mod.rs:141-156)."""
        mat = _as_mat4(mat)
        combined = mat if self.transform is None else self.transform @ mat
        s = Shape(self.ctx, self.node, combined)
        s._tape = self._tape
        return s

    # -- lowering ---------------------------------------------------------

    def tape(self) -> Tape:
        """The lowered register tape (cached; transform NOT baked in)."""
        if self._tape is None:
            self._tape = lower(self.ctx, [self.node])
        return self._tape

    @property
    def vars(self) -> list[Var]:
        """Custom (non-axis) variables this shape depends on."""
        return [v for v in self.tape().var_map if v.kind == "v"]

    def bind(self, vars: ShapeVars | dict | None = None) -> "BoundShape":
        if isinstance(vars, dict):
            vars = ShapeVars(vars)
        return BoundShape(self, vars or ShapeVars())

    # -- bulk evaluation (host-side oracle paths) -------------------------

    def _inputs(self, x, y, z, vars, mode):
        """Builds the dense input list for `eval_tape`, applying the
        homogeneous transform per mode (the `Transformable` analog,
        fidget-core/src/shape/mod.rs:894-948)."""
        tape = self.tape()
        xp = np.broadcast_arrays(
            np.asarray(x, np.float32),
            np.asarray(y, np.float32),
            np.asarray(z, np.float32),
        )
        x, y, z = xp
        if self.transform is not None:
            m = self.transform.astype(np.float32)
            w = m[3, 0] * x + m[3, 1] * y + m[3, 2] * z + m[3, 3]
            tx = (m[0, 0] * x + m[0, 1] * y + m[0, 2] * z + m[0, 3]) / w
            ty = (m[1, 0] * x + m[1, 1] * y + m[1, 2] * z + m[1, 3]) / w
            tz = (m[2, 0] * x + m[2, 1] * y + m[2, 2] * z + m[2, 3]) / w
            x, y, z = tx, ty, tz
        inputs: list = [None] * len(tape.var_map)
        axes = {"x": x, "y": y, "z": z}
        for v, i in tape.var_map.items():
            if v.kind in axes:
                inputs[i] = mode.lift(axes[v.kind])
            else:
                if vars is None or v not in vars:
                    raise ValueError(f"missing value for variable {v!r}")
                val = np.broadcast_to(
                    np.asarray(vars[v], np.float32), x.shape
                ).astype(np.float32)
                inputs[i] = mode.lift(val)
        return tape, inputs

    def eval(self, x, y, z, vars: ShapeVars | dict | None = None):
        """Dense float evaluation at (broadcastable) points → f32 array."""
        mode = _PointLift(np)
        tape, inputs = self._inputs(x, y, z, vars, mode)
        with np.errstate(all="ignore"):
            outs, _ = eval_tape(tape, FloatMode(np), inputs)
        return outs[0]

    def eval_interval(
        self, x, y, z, vars: ShapeVars | dict | None = None, *, trace=False
    ):
        """Interval evaluation; x/y/z are (lo, hi) pairs of arrays.

        Returns (lo, hi) or ((lo, hi), choices) when trace=True; choices
        is the per-choice-op 2-bit array driving tape simplification."""
        mode = _IntervalLift(np)
        xs = tuple(np.asarray(a, np.float32) for a in x)
        ys = tuple(np.asarray(a, np.float32) for a in y)
        zs = tuple(np.asarray(a, np.float32) for a in z)
        if self.transform is not None:
            tape = self.tape()
            im = IntervalMode(np)
            m = self.transform.astype(np.float32)
            if not np.allclose(self.transform[3], [0, 0, 0, 1]):
                raise NotImplementedError(
                    "perspective transforms unsupported in interval eval"
                )

            def row(r):
                acc = ((np.float32(m[r, 3]),) * 2)
                acc = (np.broadcast_to(acc[0], xs[0].shape),) * 2
                for coef, ivl in ((m[r, 0], xs), (m[r, 1], ys), (m[r, 2], zs)):
                    t = im.binary(TapeOp.MUL, ivl, (coef, coef))
                    acc = im.binary(TapeOp.ADD, acc, t)
                return acc

            xs, ys, zs = row(0), row(1), row(2)
        tape = self.tape()
        inputs: list = [None] * len(tape.var_map)
        axes = {"x": xs, "y": ys, "z": zs}
        shape = np.broadcast_shapes(xs[0].shape, ys[0].shape, zs[0].shape)
        for v, i in tape.var_map.items():
            if v.kind in axes:
                lo, hi = axes[v.kind]
                inputs[i] = (
                    np.broadcast_to(lo, shape).astype(np.float32),
                    np.broadcast_to(hi, shape).astype(np.float32),
                )
            else:
                if vars is None or v not in vars:
                    raise ValueError(f"missing value for variable {v!r}")
                val = np.broadcast_to(
                    np.asarray(vars[v], np.float32), shape
                ).astype(np.float32)
                inputs[i] = (val, val)
        with np.errstate(all="ignore"):
            outs, choices = eval_tape(
                tape, IntervalMode(np), inputs, trace=trace
            )
        return (outs[0], choices) if trace else outs[0]

    def eval_grad(self, x, y, z, vars: ShapeVars | dict | None = None):
        """Forward-gradient evaluation → (v, dx, dy, dz) f32 arrays."""
        tape = self.tape()
        x, y, z = np.broadcast_arrays(
            np.asarray(x, np.float32),
            np.asarray(y, np.float32),
            np.asarray(z, np.float32),
        )
        zero = np.zeros_like(x)
        one = np.ones_like(x)
        dx = (x, one, zero, zero)
        dy = (y, zero, one, zero)
        dz = (z, zero, zero, one)
        if self.transform is not None:
            m = self.transform.astype(np.float32)
            if not np.allclose(self.transform[3], [0, 0, 0, 1]):
                raise NotImplementedError(
                    "perspective transforms unsupported in grad eval"
                )

            def row(r):
                return (
                    m[r, 0] * x + m[r, 1] * y + m[r, 2] * z + m[r, 3],
                    np.broadcast_to(np.float32(m[r, 0]), x.shape),
                    np.broadcast_to(np.float32(m[r, 1]), x.shape),
                    np.broadcast_to(np.float32(m[r, 2]), x.shape),
                )

            dx, dy, dz = row(0), row(1), row(2)
        inputs: list = [None] * len(tape.var_map)
        axes = {"x": dx, "y": dy, "z": dz}
        for v, i in tape.var_map.items():
            if v.kind in axes:
                inputs[i] = axes[v.kind]
            else:
                if vars is None or v not in vars:
                    raise ValueError(f"missing value for variable {v!r}")
                val = np.broadcast_to(
                    np.asarray(vars[v], np.float32), x.shape
                ).astype(np.float32)
                inputs[i] = (val, zero, zero, zero)
        with np.errstate(all="ignore"):
            outs, _ = eval_tape(tape, GradMode(np), inputs)
        return outs[0]


class _PointLift:
    def __init__(self, xp):
        self.xp = xp

    def lift(self, a):
        return a


class _IntervalLift:
    def __init__(self, xp):
        self.xp = xp

    def lift(self, a):
        return (a, a)


@dataclass
class BoundShape:
    """Shape + variable bindings, checked at construction (the
    reference's `BoundShape`, fidget-core/src/shape/mod.rs:810-891)."""

    shape: Shape
    vars: ShapeVars = field(default_factory=ShapeVars)

    def __post_init__(self):
        missing = [v for v in self.shape.vars if v not in self.vars]
        if missing:
            raise ValueError(f"unbound shape variables: {missing}")

    def eval(self, x, y, z):
        return self.shape.eval(x, y, z, self.vars)
