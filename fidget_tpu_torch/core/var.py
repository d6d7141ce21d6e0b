"""Variables with persistent identity.

Mirrors the semantics of the reference's `Var`/`VarMap`
(fidget-core/src/var/mod.rs:32-110): the spatial axes X/Y/Z are
singletons, and custom variables carry a random 64-bit identity so they
stay distinct across contexts and serialization.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Var:
    """A variable identity: one of the X/Y/Z axes or a custom value."""

    kind: str  # "x" | "y" | "z" | "v"
    ident: int = 0

    # Singletons for the spatial axes, assigned below the class body.
    X: "Var" = None  # type: ignore[assignment]
    Y: "Var" = None  # type: ignore[assignment]
    Z: "Var" = None  # type: ignore[assignment]

    @staticmethod
    def new() -> "Var":
        """Creates a fresh custom variable with a random 64-bit identity."""
        return Var("v", secrets.randbits(64))

    def __repr__(self) -> str:
        if self.kind in ("x", "y", "z"):
            return self.kind.upper()
        return f"v_{self.ident:x}"


Var.X = Var("x")
Var.Y = Var("y")
Var.Z = Var("z")


@dataclass
class VarMap:
    """Insertion-ordered map from `Var` to a dense argument index.

    >>> from fidget_tpu_torch import Var, VarMap
    >>> vm = VarMap()
    >>> vm.insert(Var.Y), vm.insert(Var.X), vm.insert(Var.Y)
    (0, 1, 0)
    >>> vm[Var.X]
    1
    """

    _map: dict[Var, int] = field(default_factory=dict)

    def insert(self, v: Var) -> int:
        """Inserts `v` (if not present) and returns its index."""
        return self._map.setdefault(v, len(self._map))

    def __getitem__(self, v: Var) -> int:
        return self._map[v]

    def get(self, v: Var):
        return self._map.get(v)

    def __contains__(self, v: Var) -> bool:
        return v in self._map

    def __len__(self) -> int:
        return len(self._map)

    def __iter__(self):
        return iter(self._map)

    def items(self):
        return self._map.items()

    def axis_indices(self) -> tuple[int | None, int | None, int | None]:
        """Returns the argument indices bound to the X, Y and Z axes."""
        return (self.get(Var.X), self.get(Var.Y), self.get(Var.Z))
