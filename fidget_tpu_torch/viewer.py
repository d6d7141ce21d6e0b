"""Live-reload script viewer (terminal edition).

The analog of the reference's egui viewer (demos/viewer): watches a
`.vm` / `.rhai` model file, re-renders on change, writes the frame to
an output image, and paints an ASCII preview in the terminal. Uses
mtime polling instead of the `notify` crate and the terminal instead of
wgpu textures — the render pipeline underneath is identical to the CLI,
and runs on the CUDA card unless `device="cpu"` is passed.
"""

from __future__ import annotations

import pathlib
import sys
import time

import numpy as np

from .render.config import CancelToken

_RAMP = " .:-=+*#%@"


def _ascii(img: np.ndarray, cols: int = 78) -> str:
    h, w = img.shape[:2]
    step = max(1, -(-w // cols))  # ceil: rows must not exceed `cols`
    g = img[::2 * step, ::step]
    if g.ndim == 3:
        g = g.mean(axis=-1)
    g = (g / max(1.0, g.max()) * (len(_RAMP) - 1)).astype(int)
    return "\n".join("".join(_RAMP[v] for v in row) for row in g)


def watch(
    path: str,
    *,
    size: int = 256,
    mode3d: bool = False,
    out: str | None = None,
    cancel: CancelToken | None = None,
    poll_s: float = 0.25,
    once: bool = False,
    device=None,
) -> int:
    """Watches `path` and re-renders on change until cancelled. device:
    the render device (None means CUDA, and raises without a card)."""
    from .cli import _load, _tape, image3d_rgb
    from .eval.cuda import resolve_device
    from .io.image import write_png
    from .render.compose import render_layers
    from .render.region import ImageSize, VoxelSize
    from .render.render2d import PixelRenderer
    from .render.render3d import VoxelRenderer

    device = resolve_device(device)
    cancel = cancel or CancelToken()
    p = pathlib.Path(path)
    last_mtime = None
    while not cancel.is_cancelled():
        try:
            mtime = p.stat().st_mtime
        except OSError as e:
            if once:  # single-iteration mode must not hang on a typo
                print(f"[viewer] cannot stat {p}: {e}", file=sys.stderr)
                return 1
            time.sleep(poll_s)
            continue
        if mtime == last_mtime:
            if once:
                break
            time.sleep(poll_s)
            continue
        last_mtime = mtime
        t0 = time.perf_counter()
        try:
            if mode3d:
                tape = _tape(_load(str(p)))
                # bucketed pipeline: shape edits re-render without a
                # per-shape build (matches the 2D default)
                r = VoxelRenderer(
                    tape, VoxelSize(size, size, size), specialize=False,
                    device=device,
                )
                img = r.render(mode="normals", cancel=cancel)
                # denoised and shaded like the CLI's `render3d --mode
                # shaded`, on the render device
                frame = image3d_rgb(img, "shaded", size).cpu().numpy()
            elif p.suffix == ".rhai":
                # layered color compositing, like the reference viewer
                from .script import eval_script

                res = eval_script(p.read_text())
                frame = render_layers(
                    [_tape(t) for t in res.shapes],
                    ImageSize(size, size),
                    colors=res.colors,
                    device=device,
                )
            else:
                r = PixelRenderer(
                    _tape(_load(str(p))), ImageSize(size, size), device=device
                )
                inside = r.render(cancel=cancel).inside().cpu().numpy()
                frame = np.where(
                    inside[..., None], 255, 0
                ).astype(np.uint8) * np.ones(3, np.uint8)
        except Exception as e:  # script errors: show, keep watching
            print(f"\n[viewer] error: {e}", file=sys.stderr)
            if once:
                return 1
            continue
        dt = (time.perf_counter() - t0) * 1e3
        if out:
            write_png(out, np.ascontiguousarray(frame))
        sys.stdout.write("\x1b[2J\x1b[H" if not once else "")
        print(f"[viewer] {p.name} rendered in {dt:.1f} ms")
        print(_ascii(frame))
        if once:
            break
    return 0
