"""Render support types: cancellation, tile sizes, hints.

Analogs of fidget-core/src/render/{mod,config}.rs. A frame is a short
sequence of kernel launches on one stream, so cancellation is polled
before the frame is enqueued, as in `fidget_tpu.render.config`.
`TileSizes` and `RenderHints` are the reference's, host code that no
renderer reads: the renderers take their tile sizes as arguments.
"""

from __future__ import annotations

import threading


class RenderCancelled(Exception):
    """Raised by renderers when their CancelToken fires.

    The reference returns `None` from cancelled renders
    (fidget-raster/src/lib.rs:141-162); an exception is the Python
    idiom for the same "no result, caller asked us to stop" contract.
    """


class CancelToken:
    """Cooperative cancellation flag (render/config.rs:38-80).

    Thread-safe; `cancel()` may be called from any thread. Polled by
    `PixelRenderer.render` before it enqueues a frame.
    """

    def __init__(self):
        self._ev = threading.Event()

    def cancel(self) -> None:
        self._ev.set()

    def is_cancelled(self) -> bool:
        return self._ev.is_set()


def check_cancel(cancel: "CancelToken | None") -> None:
    """Raises RenderCancelled if `cancel` is set and fired."""
    if cancel is not None and cancel.is_cancelled():
        raise RenderCancelled()


class TileSizes(list):
    """Strictly-descending, divisible tile-size list (render/mod.rs:181-236)."""

    def __init__(self, sizes):
        sizes = [int(s) for s in sizes]
        if not sizes:
            raise ValueError("tile sizes must not be empty")
        for a, b in zip(sizes, sizes[1:]):
            if b >= a:
                raise ValueError("tile sizes must be strictly descending")
            if a % b:
                raise ValueError("each tile size must divide the previous")
        super().__init__(sizes)

    def last(self) -> int:
        return self[-1]


class RenderHints:
    """Backend tuning hints (render/mod.rs:258-274), the reference's
    defaults: one 64-px root level in 2D, 64 then 16 in 3D."""

    @staticmethod
    def tile_sizes_2d() -> TileSizes:
        return TileSizes([64])

    @staticmethod
    def tile_sizes_3d() -> TileSizes:
        return TileSizes([64, 16])

    @staticmethod
    def simplify_tree_during_meshing(depth: int) -> bool:
        # the mesher evaluates with the root tape, as the reference's
        return False
