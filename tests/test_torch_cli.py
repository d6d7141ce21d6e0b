"""The port's application layer against fidget_tpu's, on the CPU.

`fidget_tpu_torch.cli.main([..., "--cpu"])` writes its files next to
`fidget_tpu.cli.main([..., "--cpu"])`'s, on a `.vm` model (a small
seeded stand-in exported with `Context.export`) and a `.rhai` script
(the gyroid sphere) written to `tmp_path`:

- render2d mono and render3d heightmap: PNG bytes equal;
- render2d sdf: the decoded pixels within 1 level (the colormap is the
  same numpy code on distances allclose at 1e-5, see
  test_torch_render2d.py);
- render3d shaded (+ SSAO): decoded pixels within the effects'
  tolerance (within 1 level on at least 99%, within 4 everywhere; see
  test_torch_effects.py);
- mesh: STL triangle counts equal, vertices within 1e-5.

Also: `View2` / `View3` matrices and `png_bytes` exact; without
`--cpu` and without a card the CLI exits non-zero, and `--eval
interpret` without `--cpu` is refused; `watch(once=True)`; the editor
service's `/render` and `/tape` (the tape bytes equal the
reference's); `pipeline_stats` fields equal.
"""

import math
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu import cli as ref_cli
from fidget_tpu import gui as ref_gui
from fidget_tpu.io import image as ref_image
import fidget_tpu_torch as port
from fidget_tpu_torch import cli, gui
from fidget_tpu_torch.io import image
from fidget_tpu_torch.io.image import png_pixels
from fidget_tpu_torch.scenes import (
    GYROID_SPHERE_RHAI,
    sphere_union_shape,
    standin_shape,
)


def read_stl(path):
    data = path.read_bytes()
    (n,) = struct.unpack("<I", data[80:84])
    rec = np.frombuffer(data[84:], dtype=[("d", "<f4", 12), ("attr", "<u2")])
    assert len(rec) == n
    return rec["d"][:, 3:].reshape(n, 3, 3)


def _in_centroid_order(tris):
    """Triangles sorted by their centroids (rounded to 1e-3 for the
    sort only), each rotated to start at its least vertex."""
    c = np.round(tris.mean(axis=1), 3)
    tris = tris[np.lexsort((c[:, 2], c[:, 1], c[:, 0]))]
    first = np.lexsort((tris[..., 2].T, tris[..., 1].T,
                        tris[..., 0].T), axis=0)[0]
    return np.stack([np.roll(t, -k, axis=0) for t, k in zip(tris, first)])


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    ctx = ref.Context()
    (d / "standin.vm").write_text(ctx.export(standin_shape(ctx, n=40, seed=3)))
    ctx = ref.Context()
    (d / "union.vm").write_text(ctx.export(sphere_union_shape(ctx, n=6)))
    (d / "gyroid.rhai").write_text(GYROID_SPHERE_RHAI)
    return d


def _both(tmp_path, models, argv, model, suffix):
    """Runs both CLIs with --cpu; returns the two output paths."""
    outs = []
    for name, main in (("ref", ref_cli.main), ("port", cli.main)):
        out = tmp_path / f"{name}{suffix}"
        rc = main([argv[0], str(models / model), *argv[1:], "--cpu",
                   "-o", str(out)])
        assert rc == 0
        outs.append(out)
    return outs


def test_view_matrices_exact():
    for center, scale in (([0.0, 0.0], 1.0), ([0.3, -1.25], 0.375)):
        a = gui.View2.from_center_and_scale(center, scale)
        b = ref_gui.View2.from_center_and_scale(center, scale)
        np.testing.assert_array_equal(a.world_to_model(), b.world_to_model())
    for yaw, pitch in ((0.0, 0.0), (0.7, -0.3), (math.pi, 1.2)):
        a = gui.View3(np.array([0.1, 0.2, -0.3]), 1.5, yaw, pitch)
        b = ref_gui.View3(np.array([0.1, 0.2, -0.3]), 1.5, yaw, pitch)
        np.testing.assert_array_equal(a.world_to_model(), b.world_to_model())
    # gestures: the same drags and zooms move both cameras alike
    c, d = gui.Canvas3(port.VoxelSize(100, 100, 100)), ref_gui.Canvas3(
        ref.render.region.VoxelSize(100, 100, 100))
    for canvas, mode in ((c, gui.DragMode.ROTATE), (d, ref_gui.DragMode.ROTATE)):
        canvas.begin_drag([50, 50], mode)
        canvas.drag([61, 43])
        canvas.zoom(1.25, [30, 70])
    np.testing.assert_array_equal(c.view.world_to_model(),
                                  d.view.world_to_model())


def test_png_bytes_exact():
    rng = np.random.RandomState(0)
    for shape in ((1, 1, 3), (17, 33, 3), (64, 64, 3)):
        rgb = rng.randint(0, 256, size=shape).astype(np.uint8)
        assert image.png_bytes(rgb) == ref_image.png_bytes(rgb)
        np.testing.assert_array_equal(png_pixels(image.png_bytes(rgb)), rgb)
    with pytest.raises(ValueError, match="not a PNG"):
        png_pixels(b"GIF89a" + bytes(20))


def test_ppm_bytes_exact(tmp_path):
    rgb = np.random.RandomState(1).randint(0, 256, (9, 7, 3)).astype(np.uint8)
    image.write_ppm(tmp_path / "a.ppm", rgb)
    ref_image.write_ppm(tmp_path / "b.ppm", rgb)
    assert (tmp_path / "a.ppm").read_bytes() == (tmp_path / "b.ppm").read_bytes()


@pytest.mark.parametrize("model", ["standin.vm", "gyroid.rhai"])
def test_render2d_mono_png_equal(tmp_path, models, model):
    a, b = _both(tmp_path, models, ["render2d", "-s", "128", "--mode",
                                    "mono", "--scale", "1.1"], model, ".png")
    assert b.read_bytes() == a.read_bytes()


def test_render2d_sdf_within_a_level(tmp_path, models):
    a, b = _both(tmp_path, models, ["render2d", "-s", "64", "--mode", "sdf"],
                 "standin.vm", ".png")
    diff = np.abs(png_pixels(b.read_bytes()).astype(int)
                  - png_pixels(a.read_bytes()).astype(int))
    assert diff.max() <= 1


def test_render3d_heightmap_png_equal(tmp_path, models):
    a, b = _both(tmp_path, models, ["render3d", "-s", "64", "--mode",
                                    "heightmap", "--yaw", "20"],
                 "gyroid.rhai", ".png")
    assert b.read_bytes() == a.read_bytes()


@pytest.mark.parametrize("ssao", [False, True], ids=["plain", "ssao"])
def test_render3d_shaded_within_effects_tolerance(tmp_path, models, ssao):
    argv = ["render3d", "-s", "64", "--mode", "shaded", "--pitch", "-25",
            "--yaw", "-30"] + (["--ssao"] if ssao else [])
    a, b = _both(tmp_path, models, argv, "gyroid.rhai", ".png")
    want, got = png_pixels(a.read_bytes()), png_pixels(b.read_bytes())
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.99
    assert diff.max() <= 4
    assert (got > 0).mean() > 0.1  # something was lit


@pytest.mark.parametrize("model", ["union.vm", "gyroid.rhai"])
def test_mesh_stl_equal(tmp_path, models, model):
    a, b = _both(tmp_path, models, ["mesh", "--depth", "4"], model, ".stl")
    want, got = read_stl(a), read_stl(b)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("cmd", ["render2d-unrolled", "render2d-dense",
                                 "render3d-unrolled", "mesh-unrolled"])
def test_generated_kernel_modes_match_auto(tmp_path, models, cmd):
    """`--eval unrolled` / `dense` (the plain versions of the kernels
    generated per shape, on the CPU) write what `--eval auto` writes:
    the same occupancy, depth and triangles."""
    kind, mode = cmd.split("-")
    argv, model, suffix = {
        "render2d": (["render2d", "-s", "64", "--mode", "mono"],
                     "standin.vm", ".png"),
        "render3d": (["render3d", "-s", "64", "--mode", "heightmap"],
                     "gyroid.rhai", ".png"),
        "mesh": (["mesh", "--depth", "4"], "union.vm", ".stl"),
    }[kind]
    outs = []
    for ev in ("auto", mode):
        out = tmp_path / f"{ev}{suffix}"
        assert cli.main([argv[0], str(models / model), *argv[1:], "--cpu",
                         "--eval", ev, "-o", str(out)]) == 0
        outs.append(out)
    if kind == "mesh":
        # the compiled mesher emits the same triangles in its own order
        a, b = (_in_centroid_order(read_stl(o)) for o in outs)
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
    else:
        assert outs[1].read_bytes() == outs[0].read_bytes()


def test_without_card_exits_non_zero(models, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["render2d", str(models / "standin.vm"), "-s", "64"])
    assert rc != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_interpret_without_cpu_is_refused(models, capsys):
    rc = cli.main(["render2d", str(models / "standin.vm"), "-s", "64",
                   "--eval", "interpret"])
    assert rc != 0
    assert "--cpu" in capsys.readouterr().err


def test_interpret_with_cpu_runs_the_plain_versions(tmp_path, models):
    out = tmp_path / "i.png"
    assert cli.main(["render2d", str(models / "standin.vm"), "-s", "64",
                     "--eval", "interpret", "--cpu", "-o", str(out)]) == 0
    auto = tmp_path / "a.png"
    assert cli.main(["render2d", str(models / "standin.vm"), "-s", "64",
                     "--cpu", "-o", str(auto)]) == 0
    assert out.read_bytes() == auto.read_bytes()


def test_main_module_runs(models, tmp_path):
    import subprocess
    import sys

    out = tmp_path / "m.png"
    proc = subprocess.run(
        [sys.executable, "-m", "fidget_tpu_torch", "render2d",
         str(models / "standin.vm"), "-s", "64", "--cpu", "-N", "2",
         "-o", str(out)],
        capture_output=True, text=True, timeout=300,
        cwd=str(__import__("pathlib").Path(port.__file__).parent.parent),
    )
    assert proc.returncode == 0, proc.stderr
    assert "rendered 64x64 in" in proc.stdout
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("model,mode3d", [("standin.vm", False),
                                          ("gyroid.rhai", False),
                                          ("gyroid.rhai", True)])
def test_viewer_watch_once(tmp_path, models, capsys, model, mode3d):
    from fidget_tpu_torch.viewer import watch

    out = tmp_path / "frame.png"
    rc = watch(str(models / model), size=64, mode3d=mode3d, out=str(out),
               once=True, device="cpu")
    assert rc == 0
    frame = png_pixels(out.read_bytes())
    assert frame.shape == (64, 64, 3) and frame.max() > 0
    assert "rendered in" in capsys.readouterr().out


def test_viewer_missing_file_returns_one(tmp_path):
    from fidget_tpu_torch.viewer import watch

    assert watch(str(tmp_path / "nope.vm"), once=True, device="cpu") == 1


def _post(port_no, path, data, timeout=300):
    return urllib.request.urlopen(urllib.request.Request(
        f"http://127.0.0.1:{port_no}{path}", data=data), timeout=timeout).read()


def test_editor_service():
    from fidget_tpu.serve import EditorApp as RefApp
    from fidget_tpu_torch.serve import serve

    srv = serve(port=0, device="cpu")  # ephemeral port
    port_no = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        page = urllib.request.urlopen(
            f"http://127.0.0.1:{port_no}/", timeout=30).read()
        assert b"fidget_tpu_torch viewer" in page
        script = b"draw(circle(#{ radius: 0.5 }));"
        png = _post(port_no, "/render?size=64", script)
        img = png_pixels(png)
        assert img.shape == (64, 64, 3)
        # a centered disc of radius 0.5: white at the center, black at
        # the corner
        assert (img[32, 32] == 255).all() and (img[0, 0] == 0).all()
        png2 = _post(port_no, "/render?size=64&mode=2d&view2=0.25,-0.1,0.5",
                     script)
        assert png2 != png
        png3 = _post(port_no, "/render?size=64&mode=3d&view3=0,0,0,1,0.7,0.3",
                     b"draw(sphere(#{ radius: 0.5 }));")
        assert png_pixels(png3).max() > 0
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port_no, "/render?view2=1,2", script, timeout=60)
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port_no, "/render", b"bogus((", timeout=60)
        assert e.value.code == 400
        src = GYROID_SPHERE_RHAI.encode()
        assert _post(port_no, "/tape", src) == RefApp().tape_bytes(
            GYROID_SPHERE_RHAI)
        assert _post(port_no, "/tape", script) == RefApp().tape_bytes(
            script.decode())
    finally:
        srv.shutdown()
        srv.server_close()


def test_editor_service_render_matches_compose():
    """The 2D frame of the service is `render_layers` of the script's
    drawn shapes; the reference's is the same picture."""
    from fidget_tpu.serve import EditorApp as RefApp
    from fidget_tpu_torch.serve import EditorApp

    script = ("draw_rgb(circle(#{ radius: 0.5 }), 1.0, 0.25, 0.5); "
              "draw(circle(#{ center: [0.4, 0.2], radius: 0.3 }));")
    got = EditorApp(device="cpu").render_png(script, 64, "2d")
    want = RefApp().render_png(script, 64, "2d")
    np.testing.assert_array_equal(png_pixels(got), png_pixels(want))


def test_pipeline_stats_equal():
    from fidget_tpu.render.render2d import PixelRenderer as RefRenderer
    from fidget_tpu.utils import pipeline_stats as ref_stats
    from fidget_tpu_torch.utils import pipeline_stats, timed
    from test_torch_native import ref_native_compiler

    def circle(pkg):
        ctx = pkg.Context()
        x, y = ctx.x(), ctx.y()
        return pkg.lower(ctx, [ctx.sub(
            ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y))), 0.6)])

    want = ref_stats(RefRenderer(circle(ref), ref.ImageSize(512, 512),
                                 tile_size=64, interpret=True))
    got = pipeline_stats(port.PixelRenderer(
        circle(port), port.ImageSize(512, 512), tile_size=64, device="cpu"))
    assert got == type(got)(**want.__dict__)
    assert got.n_root == 64 and got.root_active > 0
    assert str(got) == str(want)
    ctx = ref.Context()
    text = ctx.export(standin_shape(ctx, n=40, seed=3))
    view = np.array([[1.5, 0, 0.1], [0, 1.5, -0.2], [0, 0, 1]])
    want = ref_stats(RefRenderer(ref_native_compiler().compile_vm(text),
                                 ref.ImageSize(256, 256), interpret=True), view)
    got = pipeline_stats(port.PixelRenderer(
        port.native.compile_vm(text), port.ImageSize(256, 256),
        device="cpu"), view)
    assert got.__dict__ == want.__dict__
    with timed("x") as t:
        pass
    assert t["seconds"] >= 0 and t["label"] == "x"


def test_trace_writes_a_chrome_trace(tmp_path):
    from fidget_tpu_torch.utils import trace

    with trace(str(tmp_path)) as prof:
        torch.ones(8).add_(1)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert len(prof.key_averages()) > 0


def test_compose_layers_match_the_reference():
    from fidget_tpu.render.compose import render_layers as ref_layers
    from fidget_tpu_torch.render.compose import render_layers

    res_ref = ref.eval_script(
        "draw_rgb(circle(#{ radius: 0.6 }), 0.2, 0.4, 1.0); "
        "draw(x.abs() - 0.1);")
    res = port.eval_script(
        "draw_rgb(circle(#{ radius: 0.6 }), 0.2, 0.4, 1.0); "
        "draw(x.abs() - 0.1);")
    want = ref_layers(res_ref.shapes, ref.ImageSize(64, 64),
                      colors=res_ref.colors, background=(0.1, 0.0, 0.3))
    got = render_layers(res.shapes, port.ImageSize(64, 64), colors=res.colors,
                        background=(0.1, 0.0, 0.3), device="cpu")
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
