"""Render support types: cancellation.

Analog of fidget-core/src/render/config.rs:38-80. A frame is a short
sequence of kernel launches on one stream, so cancellation is polled
before the frame is enqueued, as in `fidget_tpu.render.config`.
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
