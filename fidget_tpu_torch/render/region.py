"""Image regions and screen <-> world transforms.

Matches the reference's coordinate conventions
(fidget-core/src/render/region.rs:6-108): screen +y points down, world
+y up; the world ±1 square is mapped over the shorter image axis with
`scale = 2 / min(size)`, centered at `size/2` with a one-pixel Y
offset; +z points out of the screen. Pixels are sampled at integer
screen coordinates (fidget-raster/src/pixel.rs:397-410).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class ImageSize:
    """2D render target size; screen pixels map into the ±1 world
    square with the reference's Y-flip convention
    (fidget-core/src/render/region.rs:6-57).

    >>> import numpy as np
    >>> m = ImageSize(4, 4).screen_to_world()
    >>> (m @ np.array([1.5, 1.5, 1.0]))[:2].tolist()  # near center
    [-0.25, -0.25]
    """

    width: int
    height: int

    def screen_to_world(self) -> np.ndarray:
        """3x3 homogeneous matrix: (col, row, 1) -> (wx, wy, 1)."""
        cx = self.width / 2.0
        cy = self.height / 2.0 - 1.0
        s = 2.0 / min(self.width, self.height)
        return np.array(
            [
                [s, 0.0, -cx * s],
                [0.0, -s, cy * s],
                [0.0, 0.0, 1.0],
            ],
            dtype=np.float64,
        )


@dataclass(frozen=True)
class VoxelSize:
    """3D render target size; (col, row, slice) voxels map into the ±1
    world cube over the shortest axis, with the Y flip of `ImageSize`
    and +z toward the viewer (fidget-core/src/render/region.rs:59-108).

    >>> import numpy as np
    >>> m = VoxelSize(4, 4, 4).screen_to_world()
    >>> (m @ np.array([2.0, 1.0, 2.0, 1.0]))[:3].tolist()
    [0.0, 0.0, 0.0]
    """

    width: int
    height: int
    depth: int

    def screen_to_world(self) -> np.ndarray:
        """4x4 homogeneous matrix: (col, row, slice, 1) -> world."""
        c = np.array([self.width / 2.0, self.height / 2.0 - 1.0,
                      self.depth / 2.0])
        s = 2.0 / min(self.width, self.height, self.depth)
        m = np.eye(4)
        m[0, 0] = s
        m[1, 1] = -s
        m[2, 2] = s
        m[0, 3] = -c[0] * s
        m[1, 3] = c[1] * s
        m[2, 3] = -c[2] * s
        return m


def mat3_to_mat4(m3: np.ndarray) -> np.ndarray:
    """Embeds a 2D homogeneous 3x3 (acting on (x, y, 1)) into a 4x4
    acting on (x, y, z, 1), passing z through unchanged."""
    m3 = np.asarray(m3, dtype=np.float64)
    m4 = np.zeros((4, 4))
    m4[:2, :2] = m3[:2, :2]
    m4[:2, 3] = m3[:2, 2]
    m4[2, 2] = 1.0
    m4[3, :2] = m3[2, :2]
    m4[3, 3] = m3[2, 2]
    return m4


def compose2(world_to_model: np.ndarray | None, size: ImageSize) -> np.ndarray:
    """Combined screen->model 3x3 for 2D rendering."""
    s2w = size.screen_to_world()
    if world_to_model is None:
        return s2w
    w2m = np.asarray(world_to_model, dtype=np.float64)
    if w2m.shape != (3, 3):
        raise ValueError("2D world-to-model must be a 3x3 homogeneous")
    return w2m @ s2w
