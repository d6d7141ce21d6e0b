"""Free-floating expression trees with lazy coordinate remapping.

`Tree` mirrors the reference's `Tree`/`TreeOp` layer
(fidget-core/src/context/tree.rs:13-40): a lightweight expression object
with operator overloading that is only deduplicated when imported into a
`Context`. Remapping of the coordinate axes is *lazy*: `RemapAxes` /
`RemapAffine` nodes are stored unevaluated and applied frame-by-frame at
import time; chained affine remaps compose their matrices eagerly
(context/mod.rs:1068-1096).
"""

from __future__ import annotations

import math
from typing import Union

import numpy as np

from .context import Context
from .ops import BinaryOp, UnaryOp
from .var import Var

TreeLike = Union["Tree", float, int]

# Tree node kinds
_CONST = "const"
_INPUT = "input"
_UNARY = "unary"
_BINARY = "binary"
_REMAP_AXES = "remap_axes"
_REMAP_AFFINE = "remap_affine"


class Tree:
    """An immutable expression tree node.

    Operator-overloaded shape building (fidget's `Tree`,
    fidget-core/src/context/tree.rs:13-40):

    >>> from fidget_tpu_torch import Context, Tree
    >>> x, y, z = Tree.axes()
    >>> sphere = (x.square() + y.square() + z.square()).sqrt() - 1.0
    >>> ctx = Context()
    >>> root = ctx.import_tree(sphere)
    >>> "sqrt" in ctx.export(root)
    True
    """

    __slots__ = ("kind", "data")

    def __init__(self, kind: str, data: tuple):
        self.kind = kind
        self.data = data

    # -- constructors ---------------------------------------------------

    @staticmethod
    def x() -> "Tree":
        return Tree(_INPUT, (Var.X,))

    @staticmethod
    def y() -> "Tree":
        return Tree(_INPUT, (Var.Y,))

    @staticmethod
    def z() -> "Tree":
        return Tree(_INPUT, (Var.Z,))

    @staticmethod
    def axes() -> tuple["Tree", "Tree", "Tree"]:
        return Tree.x(), Tree.y(), Tree.z()

    @staticmethod
    def var(v: Var | None = None) -> "Tree":
        return Tree(_INPUT, (v if v is not None else Var.new(),))

    @staticmethod
    def constant(v: float) -> "Tree":
        return Tree(_CONST, (float(v),))

    @staticmethod
    def _wrap(v: TreeLike) -> "Tree":
        if isinstance(v, Tree):
            return v
        if isinstance(v, (int, float)):
            return Tree.constant(float(v))
        raise TypeError(f"cannot convert {v!r} to Tree")

    def _unary(self, op: UnaryOp) -> "Tree":
        return Tree(_UNARY, (op, self))

    def _binary(self, op: BinaryOp, other: TreeLike, reverse=False) -> "Tree":
        other = Tree._wrap(other)
        a, b = (other, self) if reverse else (self, other)
        return Tree(_BINARY, (op, a, b))

    # -- remapping ------------------------------------------------------

    def remap_xyz(self, x: TreeLike, y: TreeLike, z: TreeLike) -> "Tree":
        """Evaluates this tree with the axes replaced by the given trees."""
        return Tree(
            _REMAP_AXES, (self, Tree._wrap(x), Tree._wrap(y), Tree._wrap(z))
        )

    def remap_affine(self, mat: np.ndarray) -> "Tree":
        """Applies a 4x4 homogeneous transform to the coordinate axes.

        Chained affine remaps compose their matrices immediately rather
        than stacking tree nodes.
        """
        mat = np.asarray(mat, dtype=np.float64)
        if mat.shape != (4, 4):
            raise ValueError(f"remap_affine needs a 4x4, got {mat.shape}")
        if not np.array_equal(mat[3], (0.0, 0.0, 0.0, 1.0)):
            # import_tree's frame composition drops row 3, so a
            # perspective matrix would silently lose its divide
            raise ValueError(
                "remap_affine requires an affine matrix (bottom row "
                "[0, 0, 0, 1]); perspective transforms belong in the "
                "renderer's world_to_model, not the tree"
            )
        if self.kind == _REMAP_AFFINE:
            inner, m1 = self.data
            return Tree(_REMAP_AFFINE, (inner, m1 @ mat))
        return Tree(_REMAP_AFFINE, (self, mat))

    # -- operator overloading -------------------------------------------

    def __add__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.ADD, o)

    def __radd__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.ADD, o, reverse=True)

    def __sub__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.SUB, o)

    def __rsub__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.SUB, o, reverse=True)

    def __mul__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.MUL, o)

    def __rmul__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.MUL, o, reverse=True)

    def __truediv__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.DIV, o)

    def __rtruediv__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.DIV, o, reverse=True)

    def __mod__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.MOD, o)

    def __rmod__(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.MOD, o, reverse=True)

    def __neg__(self) -> "Tree":
        return self._unary(UnaryOp.NEG)

    def __abs__(self) -> "Tree":
        return self._unary(UnaryOp.ABS)

    # -- named math -----------------------------------------------------

    def abs(self) -> "Tree":
        return self._unary(UnaryOp.ABS)

    def recip(self) -> "Tree":
        return self._unary(UnaryOp.RECIP)

    def sqrt(self) -> "Tree":
        return self._unary(UnaryOp.SQRT)

    def square(self) -> "Tree":
        return self._unary(UnaryOp.SQUARE)

    def floor(self) -> "Tree":
        return self._unary(UnaryOp.FLOOR)

    def ceil(self) -> "Tree":
        return self._unary(UnaryOp.CEIL)

    def round(self) -> "Tree":
        return self._unary(UnaryOp.ROUND)

    def sin(self) -> "Tree":
        return self._unary(UnaryOp.SIN)

    def cos(self) -> "Tree":
        return self._unary(UnaryOp.COS)

    def tan(self) -> "Tree":
        return self._unary(UnaryOp.TAN)

    def asin(self) -> "Tree":
        return self._unary(UnaryOp.ASIN)

    def acos(self) -> "Tree":
        return self._unary(UnaryOp.ACOS)

    def atan(self) -> "Tree":
        return self._unary(UnaryOp.ATAN)

    def exp(self) -> "Tree":
        return self._unary(UnaryOp.EXP)

    def ln(self) -> "Tree":
        return self._unary(UnaryOp.LN)

    def not_(self) -> "Tree":
        return self._unary(UnaryOp.NOT)

    def min(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.MIN, o)

    def max(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.MAX, o)

    def atan2(self, x: TreeLike) -> "Tree":
        return self._binary(BinaryOp.ATAN2, x)

    def compare(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.COMPARE, o)

    def modulo(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.MOD, o)

    def and_(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.AND, o)

    def or_(self, o: TreeLike) -> "Tree":
        return self._binary(BinaryOp.OR, o)

    # -- evaluation helpers --------------------------------------------

    def eval(self, x: float, y: float, z: float = 0.0) -> float:
        ctx = Context()
        node = ctx.import_tree(self)
        return ctx.eval(node, {Var.X: x, Var.Y: y, Var.Z: z})

    def __repr__(self) -> str:
        return f"Tree<{self.kind}>"


def tree_min(*trees: TreeLike) -> Tree:
    """Binary-tree-balanced n-ary minimum (fidget-shapes/src/lib.rs:126-133)."""
    return _balanced(BinaryOp.MIN, [Tree._wrap(t) for t in trees])


def tree_max(*trees: TreeLike) -> Tree:
    """Binary-tree-balanced n-ary maximum."""
    return _balanced(BinaryOp.MAX, [Tree._wrap(t) for t in trees])


def _balanced(op: BinaryOp, trees: list[Tree]) -> Tree:
    if not trees:
        raise ValueError("need at least one tree")
    while len(trees) > 1:
        nxt = []
        for i in range(0, len(trees) - 1, 2):
            nxt.append(Tree(_BINARY, (op, trees[i], trees[i + 1])))
        if len(trees) % 2:
            nxt.append(trees[-1])
        trees = nxt
    return trees[0]


# ----------------------------------------------------------------------
# Importing into a Context (attached here to avoid an import cycle)


def import_tree(self: Context, tree: Tree) -> int:
    """Imports a `Tree` into this context, returning the root node.

    Iterative post-order traversal with a (tree id, axis frame) memo —
    the shared-subtree import cache of the reference
    (fidget-core/src/context/mod.rs:1019-1034) — so giant shared trees
    import in O(unique nodes) with no recursion depth limit. The memo
    is persistent on the Context, so re-importing a tree (or a tree
    sharing subtrees with earlier imports — the script-engine hot path
    for models built from one large shared component) costs O(new
    nodes) only. Cached entries pin their Tree objects so `id()` keys
    can never be recycled by the garbage collector."""
    base_frame = (self.x(), self.y(), self.z())
    memo = getattr(self, "_tree_import_memo", None)
    if memo is None:
        memo = self._tree_import_memo = {}
    # pin every memoized subtree: a live reference per cache entry
    pins = getattr(self, "_tree_import_pins", None)
    if pins is None:
        pins = self._tree_import_pins = []

    def remap_frame(t: Tree, fr):
        """The inner frame a remap node evaluates its body under
        (children must already be in the memo)."""
        if t.kind == _REMAP_AXES:
            _, xt, yt, zt = t.data
            return (
                memo[(id(xt), fr)], memo[(id(yt), fr)], memo[(id(zt), fr)]
            )
        inner, m = t.data
        fx, fy, fz = fr
        axes = []
        for r in range(3):
            acc = self.constant(m[r, 3])
            for c, fn in ((0, fx), (1, fy), (2, fz)):
                acc = self.add(acc, self.mul(self.constant(m[r, c]), fn))
            axes.append(acc)
        return tuple(axes)

    # phases: 0 = expand children, 1 = children ready, 2 = remap body ready
    stack = [(tree, base_frame, 0)]
    while stack:
        t, fr, phase = stack.pop()
        key = (id(t), fr)
        if phase == 0:
            if key in memo:
                continue
            pins.append(t)
            k = t.kind
            if k == _CONST:
                memo[key] = self.constant(t.data[0])
            elif k == _INPUT:
                v = t.data[0]
                if v == Var.X:
                    memo[key] = fr[0]
                elif v == Var.Y:
                    memo[key] = fr[1]
                elif v == Var.Z:
                    memo[key] = fr[2]
                else:
                    memo[key] = self.input(v)
            elif k == _UNARY:
                stack.append((t, fr, 1))
                stack.append((t.data[1], fr, 0))
            elif k == _BINARY:
                stack.append((t, fr, 1))
                stack.append((t.data[1], fr, 0))
                stack.append((t.data[2], fr, 0))
            elif k == _REMAP_AXES:
                _, xt, yt, zt = t.data
                stack.append((t, fr, 1))
                stack.append((xt, fr, 0))
                stack.append((yt, fr, 0))
                stack.append((zt, fr, 0))
            elif k == _REMAP_AFFINE:
                nfr = remap_frame(t, fr)
                stack.append((t, fr, 2))
                stack.append((t.data[0], nfr, 0))
            else:
                raise ValueError(f"unknown tree kind {k!r}")
        elif phase == 1:
            k = t.kind
            if k == _UNARY:
                op, a = t.data
                memo[key] = self.op_unary(op, memo[(id(a), fr)])
            elif k == _BINARY:
                op, a, b = t.data
                memo[key] = _BUILDERS[op](
                    self, memo[(id(a), fr)], memo[(id(b), fr)]
                )
            else:  # _REMAP_AXES: axis children ready, import the body
                nfr = remap_frame(t, fr)
                stack.append((t, fr, 2))
                stack.append((t.data[0], nfr, 0))
        else:  # phase 2: remap body imported under the inner frame
            nfr = remap_frame(t, fr)
            memo[key] = memo[(id(t.data[0]), nfr)]
    return memo[(id(tree), base_frame)]


_BUILDERS = {
    BinaryOp.ADD: Context.add,
    BinaryOp.SUB: Context.sub,
    BinaryOp.MUL: Context.mul,
    BinaryOp.DIV: Context.div,
    BinaryOp.MIN: Context.min,
    BinaryOp.MAX: Context.max,
    BinaryOp.ATAN2: Context.atan2,
    BinaryOp.COMPARE: Context.compare,
    BinaryOp.MOD: Context.modulo,
    BinaryOp.AND: Context.and_,
    BinaryOp.OR: Context.or_,
}

# Attach to Context
Context.import_tree = import_tree  # type: ignore[attr-defined]
