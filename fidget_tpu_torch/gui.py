"""GUI camera math: View2/View3, drag handles, canvases.

Pure-math port of `fidget-gui` (fidget-gui/src/lib.rs): world↔model
cameras (center + scale, plus turntable yaw/pitch in 3D), translation /
rotation drag handles, and stateful Canvas2/Canvas3 wrappers combining
a view with an image size for screen-space interaction. No UI toolkit
dependency — egui lives only in the reference's demos.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from .render.region import ImageSize, VoxelSize

__all__ = [
    "View2", "View3", "TranslateHandle", "RotateHandle",
    "Canvas2", "Canvas3", "DragMode",
]

#: eyeballed for pleasant UI (fidget-gui/src/lib.rs:315)
ROTATE_SPEED = 2.0


@dataclass
class TranslateHandle:
    """Pan gesture state (fidget-gui/src/lib.rs:330-380)."""

    start: np.ndarray  # initial click, model space
    initial_mat: np.ndarray  # world-to-model at gesture start
    initial_center: np.ndarray

    def center(self, pos: np.ndarray) -> np.ndarray:
        pos_model = _tp(self.initial_mat, pos)
        return self.initial_center - (pos_model - self.start)


@dataclass
class RotateHandle:
    """Turntable gesture state (fidget-gui/src/lib.rs:307-327)."""

    start: np.ndarray  # initial click, world space
    initial_yaw: float
    initial_pitch: float

    def yaw(self, x: float) -> float:
        return math.fmod(
            self.initial_yaw + (self.start[0] - x) * ROTATE_SPEED, math.tau
        )

    def pitch(self, y: float) -> float:
        return float(
            np.clip(
                self.initial_pitch + (y - self.start[1]) * ROTATE_SPEED,
                0.0,
                math.pi,
            )
        )


def _tp(mat: np.ndarray, p) -> np.ndarray:
    """Homogeneous transform_point."""
    p = np.asarray(p, np.float64)
    h = mat @ np.append(p, 1.0)
    return h[:-1] / h[-1]


class _GestureMixin:
    """Drag/zoom gesture math shared by View2 and View3 (the logic is
    dimension-agnostic: it only uses world_to_model/center/scale)."""

    def transform_point(self, p) -> np.ndarray:
        return _tp(self.world_to_model(), p)

    def begin_translate(self, start) -> TranslateHandle:
        m = self.world_to_model()
        return TranslateHandle(_tp(m, start), m, self.center.copy())

    def translate(self, h: TranslateHandle, pos) -> bool:
        nxt = h.center(np.asarray(pos, np.float64))
        changed = not np.array_equal(nxt, self.center)
        self.center = nxt
        return changed

    def zoom(self, amount: float, pos=None) -> bool:
        if pos is not None:
            # keep the model point under the cursor fixed
            before = self.transform_point(pos)
            self.scale *= amount
            after = self.transform_point(pos)
            self.center = self.center + (before - after)
        else:
            self.scale *= amount
        return amount != 1.0


@dataclass
class View2(_GestureMixin):
    """World-to-model camera: uniform scale then translation
    (fidget-gui/src/lib.rs:55-150).

    >>> import numpy as np
    >>> v = View2(center=np.array([1.0, 0.0]), scale=2.0)
    >>> v.world_to_model()[0].tolist()  # x row: scale then shift
    [2.0, 0.0, 1.0]
    """

    center: np.ndarray = field(
        default_factory=lambda: np.zeros(2, np.float64)
    )
    scale: float = 1.0

    @staticmethod
    def from_center_and_scale(center, scale: float) -> "View2":
        return View2(np.asarray(center, np.float64), float(scale))

    def components(self):
        return (self.center.copy(), self.scale)

    def world_to_model(self) -> np.ndarray:
        m = np.eye(3)
        m[0, 0] = m[1, 1] = self.scale
        m[:2, 2] = self.center
        return m

    def to_dict(self):
        return {"center": self.center.tolist(), "scale": self.scale}

    @staticmethod
    def from_dict(d) -> "View2":
        return View2.from_center_and_scale(d["center"], d["scale"])


@dataclass
class View3(_GestureMixin):
    """World-to-model camera: scale, then turntable rotation
    (yaw about +Z after pitch about +X), then translation
    (fidget-gui/src/lib.rs:154-305)."""

    center: np.ndarray = field(
        default_factory=lambda: np.zeros(3, np.float64)
    )
    scale: float = 1.0
    yaw: float = 0.0
    pitch: float = 0.0

    @staticmethod
    def from_center_and_scale(center, scale: float) -> "View3":
        return View3(np.asarray(center, np.float64), float(scale))

    def components(self):
        return (self.center.copy(), self.scale, self.yaw, self.pitch)

    def _rot_mat(self) -> np.ndarray:
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float64)
        rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float64)
        m = np.eye(4)
        m[:3, :3] = rz @ rx
        return m

    def world_to_model(self) -> np.ndarray:
        s = np.diag([self.scale, self.scale, self.scale, 1.0])
        t = np.eye(4)
        t[:3, 3] = self.center
        return t @ self._rot_mat() @ s

    def begin_rotate(self, start) -> RotateHandle:
        return RotateHandle(
            np.asarray(start, np.float64), self.yaw, self.pitch
        )

    def rotate(self, h: RotateHandle, pos) -> bool:
        pos = np.asarray(pos, np.float64)
        ny, npi = h.yaw(pos[0]), h.pitch(pos[1])
        changed = (ny != self.yaw) or (npi != self.pitch)
        self.yaw, self.pitch = ny, npi
        return changed

    def to_dict(self):
        return {
            "center": self.center.tolist(),
            "scale": self.scale,
            "yaw": self.yaw,
            "pitch": self.pitch,
        }

    @staticmethod
    def from_dict(d) -> "View3":
        return View3(
            np.asarray(d["center"], np.float64), d["scale"],
            d["yaw"], d["pitch"],
        )


class DragMode(Enum):
    PAN = "pan"
    ROTATE = "rotate"


class Canvas2:
    """2D canvas with drag/zoom state (fidget-gui/src/lib.rs:383-522)."""

    def __init__(self, image_size: ImageSize, view: View2 | None = None):
        self.view = view or View2()
        self.size = image_size
        self._drag: TranslateHandle | None = None

    def _world(self, pos_screen) -> np.ndarray:
        return _tp(
            self.size.screen_to_world(), np.asarray(pos_screen, np.float64)
        )

    def resize(self, image_size: ImageSize) -> None:
        self.size = image_size

    def begin_drag(self, pos_screen) -> None:
        self._drag = self.view.begin_translate(self._world(pos_screen))

    def drag(self, pos_screen) -> bool:
        if self._drag is None:
            return False
        return self.view.translate(self._drag, self._world(pos_screen))

    def end_drag(self) -> None:
        self._drag = None

    def zoom(self, amount: float, pos_screen=None) -> bool:
        pos = None if pos_screen is None else self._world(pos_screen)
        return self.view.zoom(amount, pos)


class Canvas3:
    """3D canvas with pan/rotate drag and zoom
    (fidget-gui/src/lib.rs:525-660)."""

    def __init__(self, image_size: VoxelSize, view: View3 | None = None):
        self.view = view or View3()
        self.size = image_size
        self._drag = None  # (mode, handle)

    def _world(self, pos_screen) -> np.ndarray:
        p = np.asarray(pos_screen, np.float64)
        return _tp(self.size.screen_to_world(), np.array([p[0], p[1], 0.0]))

    def resize(self, image_size: VoxelSize) -> None:
        self.size = image_size

    def begin_drag(self, pos_screen, drag_mode: DragMode) -> None:
        w = self._world(pos_screen)
        if drag_mode == DragMode.PAN:
            self._drag = (drag_mode, self.view.begin_translate(w))
        else:
            self._drag = (drag_mode, self.view.begin_rotate(w))

    def drag(self, pos_screen) -> bool:
        if self._drag is None:
            return False
        mode, h = self._drag
        w = self._world(pos_screen)
        if mode == DragMode.PAN:
            return self.view.translate(h, w)
        return self.view.rotate(h, w)

    def end_drag(self) -> None:
        self._drag = None

    def zoom(self, amount: float, pos_screen=None) -> bool:
        pos = None if pos_screen is None else self._world(pos_screen)
        return self.view.zoom(amount, pos)
