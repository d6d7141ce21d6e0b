"""Multi-shape layer compositing (the viewer's draw/draw_rgb path).

The reference viewer renders each drawn shape as a color layer and
composites them in draw order with OVER blending (demos/viewer/src/
script.rs:101-137, draw2d.rs:93-95). Here each layer goes through the
full tiled 2D pipeline on the render device, the composite is a few
tensor ops there, and the finished image is copied to the host once.
"""

from __future__ import annotations

import numpy as np
import torch

from .region import ImageSize
from .render2d import PixelRenderer

WHITE = (1.0, 1.0, 1.0)


def render_layers(
    shapes: list,
    size: ImageSize,
    *,
    colors: list | None = None,
    world_to_model: np.ndarray | None = None,
    z: float = 0.0,
    background=(0.0, 0.0, 0.0),
    device=None,
) -> np.ndarray:
    """Renders shapes as color layers, later shapes over earlier ones.

    colors: per-shape (r, g, b) in [0, 1]; None entries (and a None
    list) draw white, matching the plain `draw()` call. device: the
    render device (None means CUDA, and raises without a card). Returns
    u8 [H, W, 3] on the host.
    """
    from ..core.tree import Tree
    from ..eval.cuda import resolve_device
    from ..shape import Shape

    dev = resolve_device(device)
    H, W = size.height, size.width
    out = torch.empty((H, W, 3), dtype=torch.float32, device=dev)
    out[:] = torch.as_tensor(np.asarray(background, np.float32), device=dev)
    n = len(shapes)
    colors = list(colors) if colors is not None else [None] * n
    for shape, color in zip(shapes, colors):
        if isinstance(shape, Tree):
            shape = Shape.from_tree(shape)
        # single-level 64px: the bucketed tape-as-data path, shared by
        # every layer and shape
        r = PixelRenderer(shape, size, tile_size=64, device=dev)
        inside = r.render(world_to_model, z=z).inside()
        c = np.clip(np.asarray(color if color is not None else WHITE,
                               np.float32), 0.0, 1.0)
        out = torch.where(inside[..., None], torch.as_tensor(c, device=dev), out)
    return (out * 255.0).to(torch.uint8).cpu().numpy()
