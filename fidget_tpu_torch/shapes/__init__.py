"""Declarative shape standard library.

The analog of `fidget-shapes` (fidget-shapes/src/lib.rs):
~30 dataclass shapes — primitives, CSG operations, and transforms —
each convertible to a `Tree` via `.to_tree()`. Instead of the
reference's `facet` reflection + `visit_shapes` (lib.rs:644-683), every
subclass of `ShapeDef` self-registers through `__init_subclass__`, and
dataclass field metadata drives auto-registration in the script engine
(the same pattern as fidget-rhai/src/shapes.rs:14-52).

Semantics match the reference exactly (distance functions, transform
composition order, degree angles, balanced n-ary min/max trees).

>>> from fidget_tpu_torch.shapes import Circle, Move, Union
>>> a = Circle(center=(0.0, 0.0), radius=1.0)
>>> b = Move(shape=a.to_tree(), offset=(2.0, 0.0, 0.0))
>>> u = Union(input=[a.to_tree(), b.to_tree()])
>>> u.to_tree().kind
'binary'
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from typing import get_type_hints

import numpy as np

from ..core.tree import Tree, TreeLike, tree_max, tree_min

__all__ = [
    "Axis", "Plane", "ShapeDef", "SHAPE_REGISTRY",
    "Circle", "Rectangle",
    "Sphere", "Box", "HalfPlane",
    "Union", "Intersection", "Difference", "Inverse", "Blend",
    "Move", "Scale", "ScaleUniform",
    "Reflect", "ReflectX", "ReflectY", "ReflectZ", "ReflectXY",
    "Rotate", "RotateX", "RotateY", "RotateZ",
    "RevolveY", "ExtrudeZ", "LoftZ", "RepeatX",
    "union", "intersection", "difference", "inverse", "blend",
]


def _vec(v, n) -> tuple:
    a = np.asarray(v, dtype=np.float64).reshape(-1)
    if a.size == 1:
        a = np.full(n, float(a[0]))
    if a.size != n:
        raise ValueError(f"expected a {n}-vector, got {v!r}")
    return tuple(float(x) for x in a)


@dataclass(frozen=True)
class Axis:
    """Normalized 3D axis (fidget-shapes/src/types.rs:294-335)."""

    v: tuple = (0.0, 0.0, 1.0)

    def __post_init__(self):
        a = np.asarray(_vec(self.v, 3))
        n = np.linalg.norm(a)
        if not np.isfinite(n) or n < 1e-8 or n > 1e8:
            raise ValueError(f"bad axis length: {n}")
        object.__setattr__(self, "v", tuple(float(x) for x in a / n))

    X = None  # filled in below
    Y = None
    Z = None


Axis.X = Axis((1.0, 0.0, 0.0))
Axis.Y = Axis((0.0, 1.0, 0.0))
Axis.Z = Axis((0.0, 0.0, 1.0))


@dataclass(frozen=True)
class Plane:
    """Unoriented plane: axis + offset (types.rs:339-369)."""

    axis: Axis = Axis.Z
    offset: float = 0.0


#: name -> ShapeDef subclass, for script-engine auto-registration
SHAPE_REGISTRY: dict[str, type] = {}


class ShapeDef:
    """Base class; subclasses are dataclasses with a `to_tree`."""

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        SHAPE_REGISTRY[cls.__name__] = cls

    def to_tree(self) -> Tree:
        raise NotImplementedError

    @classmethod
    def field_specs(cls):
        """[(name, type, has_default)] for reflection-driven builders."""
        hints = get_type_hints(cls)
        import dataclasses

        out = []
        for f in fields(cls):
            has_default = (
                f.default is not dataclasses.MISSING
                or f.default_factory is not dataclasses.MISSING
            )
            out.append((f.name, hints.get(f.name, object), has_default))
        return out


def _axes():
    return Tree.axes()


# ---------------------------------------------------------------------------
# 2D primitives (fidget-shapes/src/lib.rs:29-63)


@dataclass
class Circle(ShapeDef):
    center: tuple = (0.0, 0.0)
    radius: float = 1.0

    def to_tree(self) -> Tree:
        x, y, _ = _axes()
        c = _vec(self.center, 2)
        return ((x - c[0]).square() + (y - c[1]).square()).sqrt() - self.radius


@dataclass
class Rectangle(ShapeDef):
    lower: tuple = (-1.0, -1.0)
    upper: tuple = (1.0, 1.0)

    def to_tree(self) -> Tree:
        x, y, _ = _axes()
        lo, hi = _vec(self.lower, 2), _vec(self.upper, 2)
        return ((lo[0] - x).max(x - hi[0])).max(
            (lo[1] - y).max(y - hi[1])
        )


# ---------------------------------------------------------------------------
# 3D primitives (lib.rs:69-111, types.rs Plane->Tree)


@dataclass
class Sphere(ShapeDef):
    center: tuple = (0.0, 0.0, 0.0)
    radius: float = 1.0

    def to_tree(self) -> Tree:
        x, y, z = _axes()
        c = _vec(self.center, 3)
        return (
            (x - c[0]).square() + (y - c[1]).square() + (z - c[2]).square()
        ).sqrt() - self.radius


@dataclass
class Box(ShapeDef):
    lower: tuple = (-1.0, -1.0, -1.0)
    upper: tuple = (1.0, 1.0, 1.0)

    def to_tree(self) -> Tree:
        x, y, z = _axes()
        lo, hi = _vec(self.lower, 3), _vec(self.upper, 3)
        return (
            ((lo[0] - x).max(x - hi[0]))
            .max((lo[1] - y).max(y - hi[1]))
            .max((lo[2] - z).max(z - hi[2]))
        )


@dataclass
class HalfPlane(ShapeDef):
    """Half-space below the given plane (types.rs:364-369)."""

    plane: Plane = field(default_factory=Plane)

    def to_tree(self) -> Tree:
        x, y, z = _axes()
        a = self.plane.axis.v
        return x * a[0] + y * a[1] + z * a[2] - self.plane.offset


# ---------------------------------------------------------------------------
# CSG (lib.rs:115-220)


def _tree(v: "Tree | ShapeDef") -> Tree:
    return v.to_tree() if isinstance(v, ShapeDef) else Tree._wrap(v)


@dataclass
class Union(ShapeDef):
    input: list = field(default_factory=list)

    def to_tree(self) -> Tree:
        if not self.input:
            return Tree.constant(math.inf)
        return tree_min(*[_tree(t) for t in self.input])


@dataclass
class Intersection(ShapeDef):
    input: list = field(default_factory=list)

    def to_tree(self) -> Tree:
        if not self.input:
            return Tree.constant(-math.inf)
        return tree_max(*[_tree(t) for t in self.input])


@dataclass
class Difference(ShapeDef):
    shape: TreeLike = None
    cutout: TreeLike = None

    def to_tree(self) -> Tree:
        return _tree(self.shape).max(-_tree(self.cutout))


@dataclass
class Inverse(ShapeDef):
    shape: TreeLike = None

    def to_tree(self) -> Tree:
        return -_tree(self.shape)


@dataclass
class Blend(ShapeDef):
    """Smooth-min union (lib.rs:143-166)."""

    a: TreeLike = None
    b: TreeLike = None
    radius: float = 0.0

    def to_tree(self) -> Tree:
        a, b = _tree(self.a), _tree(self.b)
        if self.radius > 0.0:
            r = self.radius
            return a.min(b) - (1.0 / (4.0 * r)) * (
                (r - abs(a - b)).max(0.0).square()
            )
        return a.min(b)


# ---------------------------------------------------------------------------
# Transforms (lib.rs:223-529)


def _translation(offset) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = offset
    return m


@dataclass
class Move(ShapeDef):
    shape: TreeLike = None
    offset: tuple = (0.0, 0.0, 0.0)

    def to_tree(self) -> Tree:
        return _tree(self.shape).remap_affine(
            _translation([-v for v in _vec(self.offset, 3)])
        )


@dataclass
class Scale(ShapeDef):
    shape: TreeLike = None
    scale: tuple = (1.0, 1.0, 1.0)

    def to_tree(self) -> Tree:
        s = _vec(self.scale, 3)
        # np.float64 division follows IEEE (1/0 = inf), matching the
        # reference's Rust f64 semantics — Python float division would
        # raise ZeroDivisionError out of a script instead
        inv = np.divide(1.0, np.asarray(s, np.float64))
        return _tree(self.shape).remap_affine(
            np.diag([inv[0], inv[1], inv[2], 1.0])
        )


@dataclass
class ScaleUniform(ShapeDef):
    shape: TreeLike = None
    scale: float = 1.0

    def to_tree(self) -> Tree:
        s = float(np.divide(1.0, np.float64(self.scale)))  # IEEE: 1/0=inf
        return _tree(self.shape).remap_affine(np.diag([s, s, s, 1.0]))


@dataclass
class Reflect(ShapeDef):
    """Reflection across a plane (lib.rs:286-313)."""

    shape: TreeLike = None
    plane: Plane = field(default_factory=lambda: Plane(Axis.X, 0.0))

    def to_tree(self) -> Tree:
        a = self.plane.axis.v
        x, y, z = _axes()
        d = x * a[0] + y * a[1] + z * a[2] - self.plane.offset
        scale = 2.0 * d
        return _tree(self.shape).remap_xyz(
            x - scale * a[0], y - scale * a[1], z - scale * a[2]
        )


@dataclass
class ReflectX(ShapeDef):
    shape: TreeLike = None
    offset: float = 0.0

    def to_tree(self) -> Tree:
        return Reflect(self.shape, Plane(Axis.X, self.offset)).to_tree()


@dataclass
class ReflectY(ShapeDef):
    shape: TreeLike = None
    offset: float = 0.0

    def to_tree(self) -> Tree:
        return Reflect(self.shape, Plane(Axis.Y, self.offset)).to_tree()


@dataclass
class ReflectZ(ShapeDef):
    shape: TreeLike = None
    offset: float = 0.0

    def to_tree(self) -> Tree:
        return Reflect(self.shape, Plane(Axis.Z, self.offset)).to_tree()


@dataclass
class ReflectXY(ShapeDef):
    """Swap X and Y (reflection across the x=y plane, lib.rs:339-361)."""

    shape: TreeLike = None
    offset: float = 0.0

    def to_tree(self) -> Tree:
        return Reflect(
            self.shape, Plane(Axis((-1.0, 1.0, 0.0)), self.offset)
        ).to_tree()


def _rotation(axis: Axis, angle_deg: float) -> np.ndarray:
    """4x4 coordinate remap for rotating a shape by `angle_deg`
    (Rodrigues rotation by -angle, lib.rs:428-445)."""
    d = -math.radians(angle_deg)
    ux, uy, uz = axis.v
    c, s = math.cos(d), math.sin(d)
    C = 1.0 - c
    m = np.eye(4)
    m[:3, :3] = [
        [c + ux * ux * C, ux * uy * C - uz * s, ux * uz * C + uy * s],
        [uy * ux * C + uz * s, c + uy * uy * C, uy * uz * C - ux * s],
        [uz * ux * C - uy * s, uz * uy * C + ux * s, c + uz * uz * C],
    ]
    return m


@dataclass
class Rotate(ShapeDef):
    shape: TreeLike = None
    axis: Axis = field(default_factory=lambda: Axis.Z)
    angle: float = 0.0  # degrees
    center: tuple = (0.0, 0.0, 0.0)

    def to_tree(self) -> Tree:
        c = _vec(self.center, 3)
        t = _tree(self.shape).remap_affine(_translation(c))
        t = t.remap_affine(_rotation(self.axis, self.angle))
        return t.remap_affine(_translation([-v for v in c]))


@dataclass
class RotateX(ShapeDef):
    shape: TreeLike = None
    angle: float = 0.0
    center: tuple = (0.0, 0.0, 0.0)

    def to_tree(self) -> Tree:
        return Rotate(self.shape, Axis.X, self.angle, self.center).to_tree()


@dataclass
class RotateY(ShapeDef):
    shape: TreeLike = None
    angle: float = 0.0
    center: tuple = (0.0, 0.0, 0.0)

    def to_tree(self) -> Tree:
        return Rotate(self.shape, Axis.Y, self.angle, self.center).to_tree()


@dataclass
class RotateZ(ShapeDef):
    shape: TreeLike = None
    angle: float = 0.0
    center: tuple = (0.0, 0.0, 0.0)

    def to_tree(self) -> Tree:
        return Rotate(self.shape, Axis.Z, self.angle, self.center).to_tree()


@dataclass
class RevolveY(ShapeDef):
    """Revolve an XY shape about a vertical axis at x=offset
    (lib.rs:532-553).

    Deliberate divergence: the reference computes r = sqrt(x^2 + y^2)
    (lib.rs:548), which leaves the result z-invariant — a prism, not a
    surface of revolution (the reference ships no test or model using
    RevolveY, so the bug is latent there). A revolution about the Y
    axis maps (X, Y, Z) -> f2d(sqrt(X^2 + Z^2), Y); that is what this
    implements."""

    shape: TreeLike = None
    offset: float = 0.0

    def to_tree(self) -> Tree:
        moved = Move(self.shape, (self.offset, 0.0, 0.0)).to_tree()
        x, y, z = _axes()
        r = (x.square() + z.square()).sqrt()
        t = moved.remap_xyz(r, y, z)
        return Move(t, (-self.offset, 0.0, 0.0)).to_tree()


@dataclass
class ExtrudeZ(ShapeDef):
    shape: TreeLike = None
    lower: float = 0.0
    upper: float = 1.0

    def to_tree(self) -> Tree:
        x, y, z = _axes()
        t = _tree(self.shape).remap_xyz(x, y, Tree.constant(0.0))
        return t.max((self.lower - z).max(z - self.upper))


@dataclass
class LoftZ(ShapeDef):
    """Linear loft between two XY shapes over [lower, upper] in Z
    (lib.rs:577-604)."""

    a: TreeLike = None
    b: TreeLike = None
    lower: float = 0.0
    upper: float = 1.0

    def to_tree(self) -> Tree:
        x, y, z = _axes()
        ta = _tree(self.a).remap_xyz(x, y, Tree.constant(0.0))
        tb = _tree(self.b).remap_xyz(x, y, Tree.constant(0.0))
        t = ((z - self.lower) * tb + (self.upper - z) * ta) / (
            self.upper - self.lower
        )
        return t.max((self.lower - z).max(z - self.upper))


@dataclass
class RepeatX(ShapeDef):
    """Tile a shape along X with period 2*radius (lib.rs:606-633)."""

    shape: TreeLike = None
    radius: float = 1.0
    offset: float = 0.0

    def to_tree(self) -> Tree:
        x, y, z = _axes()
        r = self.radius - self.offset
        return _tree(self.shape).remap_xyz(
            ((x + r).modulo(self.radius * 2.0)) - r, y, z
        )


# ---------------------------------------------------------------------------
# functional conveniences


def union(*shapes) -> Tree:
    return Union(list(shapes)).to_tree()


def intersection(*shapes) -> Tree:
    return Intersection(list(shapes)).to_tree()


def difference(shape, cutout) -> Tree:
    return Difference(shape, cutout).to_tree()


def inverse(shape) -> Tree:
    return Inverse(shape).to_tree()


def blend(a, b, radius: float = 0.0) -> Tree:
    return Blend(a, b, radius).to_tree()
