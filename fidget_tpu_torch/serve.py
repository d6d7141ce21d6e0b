"""HTTP editor/viewer service — the web-editor analog.

The reference's web editor (demos/web-editor) evaluates scripts in a
worker and streams rendered frames to a browser canvas. The analog here
is a small HTTP service: a single-page editor posts script text to
`/render`, the server traces it with the script engine, renders through
the tiled pipeline, and returns a PNG. Tapes can also be exported in
the canonical bytecode interchange format (`/tape`), the moral
equivalent of the web editor's bincoded VmData worker messages
(demos/web-editor/crate/src/lib.rs:30-45).

The editor page is also the INTERACTIVE viewer (the egui viewer-demo
analog, demos/viewer/src/main.rs): the rendered canvas accepts mouse
input — drag to pan (2D) or turntable-rotate (3D; right/shift-drag to
pan), wheel to zoom about the cursor — and a 2D/3D mode switch. The
client mirrors the View2/View3 camera math (fidget-gui/src/lib.rs:55,
:154; fidget_tpu_torch/gui.py) and posts the resulting camera with each
frame request; the server rebuilds the matching View and renders with
its world_to_model matrix, so the browser-side gestures and the
Python-side cameras stay one definition.

Endpoints:
  GET  /            the editor/viewer page
  POST /render      body = script text (.rhai subset) -> image/png
                    query: size (px), mode (2d|3d),
                    view2=cx,cy,scale  view3=cx,cy,cz,scale,yaw,pitch
  POST /tape        body = script text -> application/octet-stream
                    (canonical bytecode words, little-endian)

Frames render on the CUDA card (`--cpu`: on the CPU), one at a time.

Run: python -m fidget_tpu_torch serve --port 8080
"""

from __future__ import annotations

import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_PAGE = b"""<!doctype html>
<title>fidget_tpu_torch viewer</title>
<style>
 body { display: flex; font-family: monospace; margin: 0; height: 100vh; }
 textarea { flex: 1; font: 14px monospace; padding: 8px; border: 0;
            background: #1e1e2e; color: #cdd6f4; resize: none; }
 #right { flex: 1; display: flex; flex-direction: column; }
 img { image-rendering: pixelated; width: 100%; cursor: grab;
       user-select: none; -webkit-user-drag: none; }
 #bar { display: flex; gap: 8px; padding: 4px 8px; background: #11111b;
        color: #a6adc8; align-items: center; }
 button { font: inherit; background: #313244; color: #cdd6f4; border: 0;
          padding: 2px 10px; cursor: pointer; }
 button.on { background: #89b4fa; color: #11111b; }
</style>
<textarea id=src spellcheck=false>
let r = 0.8;
let c = circle(#{ radius: r });
let bar = intersection(x.abs() - 0.1, y.abs() - 0.9);
draw(difference(c, bar));
</textarea>
<div id=right>
 <div id=bar>
  <button id=b2 class=on>2d</button><button id=b3>3d</button>
  <button id=reset>reset view</button>
  <span id=status>edit to render</span>
 </div>
 <img id=out draggable=false>
</div>
<script>
const src = document.getElementById('src');
const out = document.getElementById('out');
const status = document.getElementById('status');
let timer = null, busy = false, dirty = false, lastUrl = null;
let mode = '2d';
// camera state mirroring fidget_tpu_torch.gui View2/View3
let v2 = {cx: 0, cy: 0, s: 1};
let v3 = {cx: 0, cy: 0, cz: 0, s: 1, yaw: 0, pitch: 0};
function viewQuery() {
  if (mode === '3d')
    return `view3=${v3.cx},${v3.cy},${v3.cz},${v3.s},${v3.yaw},${v3.pitch}`;
  return `view2=${v2.cx},${v2.cy},${v2.s}`;
}
async function render(quick) {
  if (busy) { dirty = true; return; }
  busy = true;
  try {
    const t0 = performance.now();
    const size = quick ? 256 : 512;
    const r = await fetch(`/render?size=${size}&mode=${mode}&` + viewQuery(),
                          {method: 'POST', body: src.value});
    if (r.ok) {
      const url = URL.createObjectURL(await r.blob());
      if (lastUrl) URL.revokeObjectURL(lastUrl);
      lastUrl = url;
      out.src = url;
      status.textContent =
        `rendered in ${(performance.now()-t0).toFixed(0)} ms`;
    } else {
      status.textContent = await r.text();
    }
  } catch (e) {
    status.textContent = String(e);
  } finally {
    busy = false;
    if (dirty) { dirty = false; render(quick); }
  }
}
src.addEventListener('input', () => {
  clearTimeout(timer); timer = setTimeout(() => render(false), 300);
});
// ---- interactive camera (View2/View3 gesture math) ----
// screen px -> world units: the +-1 world square maps onto the image,
// so one CSS px = 2 / displayed-width world units (y flipped)
function pxToWorld(dx, dy) {
  const w = out.clientWidth || 512;
  return [2 * dx / w, -2 * dy / w];
}
let drag = null;
out.addEventListener('pointerdown', (e) => {
  drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey || e.button === 2};
  out.setPointerCapture(e.pointerId);
});
out.addEventListener('contextmenu', (e) => e.preventDefault());
out.addEventListener('pointermove', (e) => {
  if (!drag) return;
  const [dwx, dwy] = pxToWorld(e.clientX - drag.x, e.clientY - drag.y);
  drag.x = e.clientX; drag.y = e.clientY;
  if (mode === '2d') {
    // TranslateHandle: the model point under the cursor follows it
    // (model = s*world + c  =>  c -= s * dworld)
    v2.cx -= v2.s * dwx; v2.cy -= v2.s * dwy;
  } else if (drag.pan) {
    // pan in the rotated frame: c -= R @ S @ dworld
    const cy = Math.cos(v3.yaw), sy = Math.sin(v3.yaw);
    const cp = Math.cos(v3.pitch), sp = Math.sin(v3.pitch);
    // R = Rz(yaw) @ Rx(pitch); world delta is (dwx, dwy, 0)
    const rx = cy * dwx - sy * (cp * dwy);
    const ry = sy * dwx + cy * (cp * dwy);
    const rz = sp * dwy;
    v3.cx -= v3.s * rx; v3.cy -= v3.s * ry; v3.cz -= v3.s * rz;
  } else {
    // RotateHandle: turntable, full width = one revolution
    v3.yaw += (2 * Math.PI) * (dwx / 2);
    v3.pitch += (2 * Math.PI) * (-dwy / 2);
    v3.pitch = Math.max(-Math.PI / 2, Math.min(Math.PI / 2, v3.pitch));
  }
  render(true);
});
function endDrag() { if (drag) { drag = null; render(false); } }
out.addEventListener('pointerup', endDrag);
out.addEventListener('pointercancel', endDrag);
out.addEventListener('wheel', (e) => {
  e.preventDefault();
  const f = Math.exp(e.deltaY * 0.001);
  const rect = out.getBoundingClientRect();
  const w = rect.width, h = rect.height;
  // cursor in world coords of the +-1 square
  const wx = 2 * (e.clientX - rect.left) / w - 1;
  const wy = 1 - 2 * (e.clientY - rect.top) / h;
  if (mode === '2d') {
    // zoom about the cursor: keep model point fixed
    v2.cx += (v2.s - v2.s * f) * wx;
    v2.cy += (v2.s - v2.s * f) * wy;
    v2.s *= f;
  } else {
    v3.s *= f;
  }
  clearTimeout(timer); timer = setTimeout(() => render(false), 150);
  render(true);
}, {passive: false});
function setMode(m) {
  mode = m;
  document.getElementById('b2').classList.toggle('on', m === '2d');
  document.getElementById('b3').classList.toggle('on', m === '3d');
  render(false);
}
document.getElementById('b2').onclick = () => setMode('2d');
document.getElementById('b3').onclick = () => setMode('3d');
document.getElementById('reset').onclick = () => {
  v2 = {cx: 0, cy: 0, s: 1};
  v3 = {cx: 0, cy: 0, cz: 0, s: 1, yaw: 0, pitch: 0};
  render(false);
};
render(false);
</script>
"""


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):  # quiet
        pass

    def _body(self) -> str:
        n = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(n).decode()

    def _send(self, code, ctype, data: bytes):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if urllib.parse.urlparse(self.path).path in ("/", "/index.html"):
            self._send(200, "text/html", _PAGE)
        else:
            self._send(404, "text/plain", b"not found")

    def do_POST(self):
        url = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(url.query)
        try:
            if url.path == "/render":
                size = int(q.get("size", ["256"])[0])
                mode = q.get("mode", ["2d"])[0]
                view = None
                if "view2" in q:
                    view = tuple(
                        round(float(x), 6)
                        for x in q["view2"][0].split(",")
                    )
                    if len(view) != 3:
                        raise ValueError("view2 expects cx,cy,scale")
                elif "view3" in q:
                    view = tuple(
                        round(float(x), 6)
                        for x in q["view3"][0].split(",")
                    )
                    if len(view) != 6:
                        raise ValueError(
                            "view3 expects cx,cy,cz,scale,yaw,pitch"
                        )
                data = self.server.app.render_png(
                    self._body(), size, mode, view=view
                )
                self._send(200, "image/png", data)
            elif url.path == "/tape":
                data = self.server.app.tape_bytes(self._body())
                self._send(200, "application/octet-stream", data)
            else:
                self._send(404, "text/plain", b"not found")
        except Exception as e:  # noqa: BLE001 — report to the client
            self._send(400, "text/plain", str(e).encode())


class EditorApp:
    """Script -> frame/tape services behind the HTTP handlers.

    Rendered frames are cached on (script, size, mode) so a debounced
    editor re-requesting an unchanged script costs nothing. Frames run
    the bucketed pipelines (specialize=False), which treat the tape as
    data, so shape edits re-render without a per-shape build. device:
    the render device (None means CUDA, and raises without a card).
    """

    def __init__(self, cache_frames: int = 32, device=None):
        from .eval.cuda import resolve_device

        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._frames: dict = {}
        self._cache_frames = cache_frames

    def _trace(self, script: str):
        from .script import eval_script

        return eval_script(script)

    def render_png(
        self, script: str, size: int, mode: str, view=None
    ) -> bytes:
        from .gui import View2, View3
        from .io.image import png_bytes
        from .render.compose import render_layers
        from .render.effects import apply_shading
        from .render.region import ImageSize, VoxelSize
        from .render.render3d import VoxelRenderer
        from .shape import Shape

        size = max(64, min(1024, size))
        if mode == "3d":
            # clamp BEFORE the cache key: sizes 257..1024 all render at
            # 256, so they must share one cache entry
            size = min(256, size)
        key = (script, size, mode, view)
        with self._lock:
            cached = self._frames.get(key)
        if cached is not None:
            return cached
        res = self._trace(script)
        with self._lock:  # one render at a time: there is one card
            if mode == "3d":
                w2m = None
                if view is not None:
                    w2m = View3(
                        np.asarray(view[:3], np.float64), view[3],
                        view[4], view[5],
                    ).world_to_model()
                n = size
                r = VoxelRenderer(
                    Shape.from_tree(res.tree).tape(), VoxelSize(n, n, n),
                    specialize=False,  # edits re-render, no per-shape build
                    device=self.device,
                )
                img = r.render(w2m, mode="normals")
                rgb = apply_shading(img.depth, img.normal, vdepth=n)
                rgb = torch.flip(rgb, dims=[0]).cpu().numpy()
            else:
                w2m = None
                if view is not None:
                    w2m = View2.from_center_and_scale(
                        view[:2], view[2]
                    ).world_to_model()
                rgb = render_layers(
                    res.shapes, ImageSize(size, size), colors=res.colors,
                    world_to_model=w2m, device=self.device,
                )
        data = png_bytes(rgb)
        with self._lock:
            # evict+insert under the lock: concurrent requests on a
            # full cache would otherwise race next(iter(...))/pop and
            # turn a valid script into a spurious KeyError 400
            while len(self._frames) >= self._cache_frames:
                self._frames.pop(next(iter(self._frames)))
            self._frames[key] = data
        return data

    def tape_bytes(self, script: str) -> bytes:
        from .compiler.bytecode import as_bytes
        from .shape import Shape

        res = self._trace(script)
        return as_bytes(Shape.from_tree(res.tree).tape())


def serve(port: int = 8080, host: str = "127.0.0.1",
          device=None) -> ThreadingHTTPServer:
    """Starts the editor service (returns the server; call
    serve_forever() or shutdown() on it)."""
    app = EditorApp(device=device)
    srv = ThreadingHTTPServer((host, port), _Handler)
    srv.app = app
    return srv


def main(port: int = 8080, host: str = "127.0.0.1", device=None) -> int:
    srv = serve(port, host, device=device)
    print(f"fidget_tpu_torch editor on http://{host}:{port}/")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0
