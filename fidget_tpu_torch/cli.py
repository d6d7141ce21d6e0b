"""Command-line interface: render2d / render3d / mesh / view / serve.

Mirrors the reference CLI (demos/cli/src/main.rs), as
`fidget_tpu.cli` does: loads `.vm` models through the native tape
compiler or `.rhai` scripts through the script engine, renders 2D
bitmaps (debug / mono / sdf / brute modes), 3D heightmaps / normals /
shaded images (± SSAO), or MDC meshes to STL; `-N` repeats the work and
reports the best wall time.

Every command runs on the CUDA card; `--cpu` runs it on the CPU with
the kernels' plain versions instead. Without a card and without
`--cpu`, a command exits with status 2 and says why. `--eval` picks the
pipeline: `auto` / `compiled` run the kernels on the chosen device,
`interpret` the plain versions (CPU only: it needs `--cpu`), `unrolled`
the kernels generated for the shape (2D, 3D, mesh) and `dense` (2D) the
generated kernel over every pixel.

Usage:
  python -m fidget_tpu_torch render2d model.vm -o out.png --mode sdf -s 512
  python -m fidget_tpu_torch render3d model.rhai -o out.png --mode shaded \\
      --ssao --scale 0.75 --pitch -25 --yaw -30
  python -m fidget_tpu_torch mesh model.vm -o out.stl --depth 6
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
import time

import numpy as np
import torch


def _load(path: str):
    from .native import compile_vm
    from .script import eval_script

    p = pathlib.Path(path)
    text = p.read_text()
    if p.suffix == ".rhai":
        return eval_script(text).tree
    return compile_vm(text)


def _tape(model):
    from .compiler.lower import lower
    from .compiler.tape import Tape
    from .core.context import Context
    from .core.tree import import_tree

    if isinstance(model, Tape):
        return model
    if isinstance(model, tuple):
        ctx, root = model
        return lower(ctx, [root])
    ctx = Context()
    return lower(ctx, [import_tree(ctx, model)])


def _parse_vec(s: str, n: int):
    parts = [float(v) for v in s.split(",")]
    if len(parts) == 1:
        parts = parts * n
    if len(parts) != n:
        raise argparse.ArgumentTypeError(f"expected {n} comma-separated values")
    return parts


def _sync(device: torch.device) -> None:
    """Waits for the device's queued work, so a host clock around a
    command times the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _view2(args):
    from .gui import View2

    return View2.from_center_and_scale(
        _parse_vec(args.center, 2), args.scale
    ).world_to_model()


def _view3(args):
    from .gui import View3

    v = View3.from_center_and_scale(_parse_vec(args.center, 3), args.scale)
    v.pitch = math.radians(args.pitch)
    v.yaw = math.radians(args.yaw)
    m = v.world_to_model()
    roll = math.radians(getattr(args, "roll", 0.0) or 0.0)
    if roll:
        # roll about the view axis, applied to world coords before the
        # turntable rotation (demos/cli/src/main.rs:864-881)
        cr, sr = math.cos(roll), math.sin(roll)
        rz = np.array(
            [[cr, -sr, 0, 0], [sr, cr, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
            np.float64,
        )
        m = m @ rz
    zf = getattr(args, "zflatten", 1.0) or 1.0
    if zf != 1.0:
        m = m @ np.diag([1.0, 1.0, float(zf), 1.0])
    if getattr(args, "perspective", None):
        # w-row z coefficient, like the reference camera
        # (demos/cli/src/main.rs:870-873)
        m[3, 2] = args.perspective
    return m


def _write_image(path: str, rgb: np.ndarray):
    from .io.image import write_png, write_ppm

    if path.endswith(".ppm"):
        write_ppm(path, rgb)
    else:
        write_png(path, rgb)


def _colormap_sdf(d: np.ndarray) -> np.ndarray:
    """Red outside / green inside with distance banding (the reference's
    SdfRenderMode, demos/cli/src/main.rs sdf mode)."""
    finite = np.abs(d[np.isfinite(d)])
    scale = float(finite.max()) if finite.size else 1.0
    scale = max(1e-20, scale)
    rgb = np.zeros(d.shape + (3,), np.float32)
    inside = d < 0
    rgb[..., 0] = np.where(inside, 0.2, 0.4 + 0.6 * np.abs(d) / scale)
    rgb[..., 1] = np.where(inside, 0.4 + 0.6 * np.abs(d) / scale, 0.2)
    rgb[..., 2] = 0.2
    band = 0.8 + 0.2 * np.cos(d * 64.0 * np.pi / scale)
    rgb *= band[..., None]
    return (np.clip(np.nan_to_num(rgb), 0, 1) * 255).astype(np.uint8)


def _debug_rgb(d: np.ndarray, cls: np.ndarray, lvl: np.ndarray) -> np.ndarray:
    """Color by fill class AND the cull level that proved it (the
    reference's DebugRenderMode colors by the NaN-boxed fill depth,
    fidget-raster/src/pixel.rs:176-230); fill == 0 where evaluated."""
    from .render.render2d import FILL_INSIDE, FILL_OUTSIDE

    rgb = np.zeros(d.shape + (3,), np.uint8)
    # deeper levels shift hue: root fills are darker, subtile fills
    # brighter, so the tile pyramid is visible at a glance
    inside_colors = [(0, 100, 200), (0, 170, 255), (90, 220, 255)]
    outside_colors = [(50, 50, 50), (90, 90, 90), (130, 130, 130)]
    for L in range(int(max(0, lvl.max())) + 1):
        ci = inside_colors[min(L, len(inside_colors) - 1)]
        co = outside_colors[min(L, len(outside_colors) - 1)]
        rgb[(cls == FILL_INSIDE) & (lvl == L)] = ci
        rgb[(cls == FILL_OUTSIDE) & (lvl == L)] = co
    ev = lvl < 0
    rgb[ev & (d < 0)] = (255, 255, 255)
    rgb[ev & (d >= 0)] = (20, 20, 20)
    return rgb


def run2d(args) -> int:
    from .render.region import ImageSize
    from .render.render2d import PixelRenderer

    dev = args.device
    tape = _tape(_load(args.input))
    r = PixelRenderer(tape, ImageSize(args.size, args.size), device=dev)
    mat = _view2(args)
    best = math.inf
    for _ in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        if args.mode == "brute":
            d = r.render_brute(mat)
            img = None
        elif args.eval == "unrolled":
            # tiled-unrolled path (the --eval=jit analog): interval
            # culling + block-union simplified leaf tapes with the
            # full-tape fallback, on kernels generated for the shape
            img = r.render_unrolled(
                mat, pixel_perfect=(args.mode == "sdf"), leaf="union"
            )
        elif args.eval == "dense":
            # the generated kernel over every pixel (no culling; every
            # pixel carries a true distance: the differentiable mode)
            img = r.render_dense(mat)
        else:
            img = r.render(mat, pixel_perfect=(args.mode == "sdf"))
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    print(f"rendered {args.size}x{args.size} in {best * 1e3:.2f}ms")
    if args.out:
        if img is not None:
            d = img.distance.cpu().numpy()
        if args.mode in ("mono", "brute"):
            inside = (d < 0) if img is None else img.inside().cpu().numpy()
            rgb = np.where(inside[..., None], 255, 0).astype(np.uint8)
            rgb = np.broadcast_to(rgb, inside.shape + (3,))
        elif args.mode == "sdf":
            rgb = _colormap_sdf(d)
        else:
            rgb = _debug_rgb(
                d, img.fill_class().cpu().numpy(), img.fill_level().cpu().numpy()
            )
        _write_image(args.out, rgb)
        print(f"wrote {args.out}")
    return 0


def image3d_rgb(img, mode: str, vdepth: int, *, denoise: bool = True,
                ssao: bool = False) -> torch.Tensor:
    """The picture of a 3D frame in one of `render3d`'s modes, as uint8
    [H, W, 3] on the frame's device, +y up (rows flipped). The effects
    run there; the caller copies the result to the host once."""
    from .render.effects import (
        apply_shading,
        blur_ssao,
        compute_ssao,
        denoise_normals,
    )

    depth = img.depth
    empty = (depth == 0)[..., None]
    black = torch.zeros((), dtype=torch.uint8, device=depth.device)

    def normals():
        return denoise_normals(depth, img.normal) if denoise else img.normal

    if mode == "heightmap":
        g = (depth.to(torch.float32) / vdepth * 255).to(torch.uint8)
        rgb = torch.stack([g, g, g], dim=-1)
    elif mode == "normals":
        rgb = ((normals() * 0.5 + 0.5) * 255).to(torch.uint8)
        rgb = torch.where(empty, black, rgb)
    elif mode in ("raw-occlusion", "blurred-occlusion"):
        # the reference's SSAO debug views (main.rs:498-521): the
        # occlusion map as grayscale, black where empty (main.rs:351-363)
        s = compute_ssao(depth, normals(), vdepth=vdepth)
        if mode == "blurred-occlusion":
            s = blur_ssao(s)
        s = torch.where(torch.isfinite(s), s, 0.0)
        v = torch.clamp(s * 255.0, 0, 255).to(torch.uint8)
        rgb = torch.where(empty, black, torch.stack([v, v, v], dim=-1))
    else:  # shaded
        rgb = apply_shading(depth, normals(), vdepth=vdepth, ssao=ssao)
    # flip vertically so +y is up in the written image
    return torch.flip(rgb, dims=[0])


def run3d(args) -> int:
    from .render.region import VoxelSize
    from .render.render3d import VoxelRenderer

    dev = args.device
    tape = _tape(_load(args.input))
    n = args.size
    kw = {}
    if args.eval == "unrolled":
        # the compiled 3D frame (the --eval=jit analog): generated
        # interval proofs + whole-tape voxel leaf, no interpreter
        kw = dict(leaf="unrolled", proofs="unrolled")
    r = VoxelRenderer(tape, VoxelSize(n, n, n), device=dev, **kw)
    mat = _view3(args)
    mode = "heightmap" if args.mode == "heightmap" else "normals"
    best = math.inf
    for _ in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        img = r.render(mat, mode=mode)
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    print(f"rendered {n}^3 in {best * 1e3:.2f}ms")
    if args.out:
        rgb = image3d_rgb(img, args.mode, n, denoise=not args.no_denoise,
                          ssao=args.ssao)
        _write_image(args.out, rgb.cpu().numpy())
        print(f"wrote {args.out}")
    return 0


def run_mesh(args) -> int:
    from .mesh import Settings, build_mesh

    tape = _tape(_load(args.input))
    mat = _view3(args)  # identity when all camera flags are defaults
    best = math.inf
    mesh = None
    for _ in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        mesh = build_mesh(
            tape,
            Settings(
                depth=args.depth, world_to_model=mat,
                collapse=not args.no_collapse, device=args.device,
                eval="unrolled" if args.eval == "unrolled" else "interp",
            ),
        )
        best = min(best, time.perf_counter() - t0)
    print(
        f"meshed depth {args.depth}: {len(mesh.vertices)} vertices, "
        f"{len(mesh.triangles)} triangles in {best * 1e3:.2f}ms"
    )
    if args.out:
        if str(args.out).lower().endswith(".obj"):
            mesh.write_obj(args.out)
        else:
            mesh.write_stl(args.out)
        print(f"wrote {args.out}")
    return 0


def run_serve(args) -> int:
    from .serve import main as serve_main

    return serve_main(args.port, args.host, device=args.device)


def run_view(args) -> int:
    from .viewer import watch

    return watch(
        args.input, size=args.size, mode3d=args.mode3d, out=args.out,
        once=args.once, device=args.device,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fidget_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    cpu_help = ("run on the host CPU with the kernels' plain versions "
                "(without it, the command runs on the CUDA card)")

    def common(p, three_d: bool):
        p.add_argument("--cpu", action="store_true", help=cpu_help)
        p.add_argument("input", help=".vm or .rhai model file")
        p.add_argument("-o", "--out", help="output file")
        p.add_argument("-N", "--repeat", type=int, default=1,
                       help="repeat for benchmarking; report best time")
        p.add_argument("--scale", type=float, default=1.0)
        p.add_argument("--center", default="0")
        p.add_argument("--eval", default="auto",
                       choices=["auto", "interpret", "compiled",
                                "unrolled", "dense"],
                       help="evaluator: 'auto' / 'compiled' run the "
                            "interpreter kernels on the chosen device, "
                            "'interpret' their plain versions (needs "
                            "--cpu), 'unrolled' = interval culling + "
                            "the whole tape as kernels generated for "
                            "the shape, the closest 'jit' analog, "
                            "fastest steady-state, slow first build "
                            "(2D, 3D, mesh), or (2D) 'dense' = the "
                            "generated kernel over every pixel "
                            "(differentiable, no culling)")
        if three_d:
            p.add_argument("--pitch", type=float, default=0.0,
                           help="camera pitch (degrees)")
            p.add_argument("--yaw", type=float, default=0.0,
                           help="camera yaw (degrees)")

    p2 = sub.add_parser("render2d", help="2D bitmap render")
    common(p2, False)
    p2.add_argument("-s", "--size", type=int, default=512)
    p2.add_argument("--mode", default="mono",
                    choices=["debug", "mono", "sdf", "brute"])
    p2.set_defaults(fn=run2d)

    p3 = sub.add_parser("render3d", help="3D heightmap/normals/shaded render")
    common(p3, True)
    p3.add_argument("-s", "--size", type=int, default=512)
    p3.add_argument("--mode", default="shaded",
                    choices=["heightmap", "normals", "shaded",
                             "raw-occlusion", "blurred-occlusion"])
    p3.add_argument("--ssao", action="store_true",
                    help="apply SSAO to a shaded image")
    p3.add_argument("--no-denoise", action="store_true",
                    help="skip denoising of normals")
    p3.add_argument("--roll", type=float, default=0.0,
                    help="camera roll about the view axis (degrees)")
    p3.add_argument("--zflatten", type=float, default=1.0,
                    help="flatten values on the Z axis to prevent "
                         "screen clipping")
    p3.add_argument("--perspective", type=float, default=None,
                    help="perspective strength (omit for isometric)")
    p3.set_defaults(fn=run3d)

    pm = sub.add_parser("mesh", help="MDC mesh to STL")
    common(pm, True)
    pm.add_argument("--depth", type=int, default=5)
    pm.add_argument("--no-collapse", action="store_true",
                    help="disable adaptive cell merging (uniform leaves)")
    pm.set_defaults(fn=run_mesh)

    pv = sub.add_parser("view", help="live-reload viewer (terminal)")
    pv.add_argument("--cpu", action="store_true", help=cpu_help)
    pv.add_argument("input", help=".vm or .rhai model file")
    pv.add_argument("-o", "--out", help="PNG updated on each reload")
    pv.add_argument("-s", "--size", type=int, default=256)
    pv.add_argument("--mode3d", action="store_true")
    pv.add_argument("--once", action="store_true",
                    help="render once and exit (no watching)")
    pv.set_defaults(fn=run_view)

    psv = sub.add_parser("serve", help="HTTP editor/viewer service")
    psv.add_argument("--cpu", action="store_true", help=cpu_help)
    psv.add_argument("--port", type=int, default=8080)
    psv.add_argument("--host", default="127.0.0.1")
    psv.set_defaults(fn=run_serve)

    args = ap.parse_args(argv)
    from .eval.cuda import resolve_device

    if getattr(args, "eval", "auto") == "interpret" and not args.cpu:
        print(f"{ap.prog}: --eval interpret runs the plain versions, which "
              "run on the CPU only: add --cpu", file=sys.stderr)
        return 2
    try:
        args.device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"{ap.prog}: {e} (the CLI's --cpu)", file=sys.stderr)
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
