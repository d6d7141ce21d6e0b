#!/usr/bin/env python3
"""Where the interpreter kernels' time goes on one CUDA card.

Captures the inputs that the 2D main path of `chip_smoke.py` hands to
`interp_float` (K3) and `interp_interval` (K1) under the bucketed and
the two-level (128, 32) bindings, then, for the kernel sources of this
tree and of every `--variant NAME=DIR` (a directory holding a full
copy of `fidget_tpu_torch/csrc` with an experiment edited in), builds
them and times both kernels on those inputs by CUDA events, in turns
(tree, variants..., tree). A variant must keep the C interface of the
tree's sources. For each build it also writes the disassembly
(`cuobjdump -sass`) and nvcc's `-Xptxas -v` log of the two kernels to
`<out>/<name>/` (default `probe_out/`), where the instructions of one
tape row can be counted per opcode.

    python3 probe_kernels.py [--variant NAME=DIR ...] [--reps 20] [--out DIR]

A variant may compute wrong values (an ablation that drops the
arithmetic, say): results are compared with the tree's and the
agreement is reported, not required.

    python3 probe_kernels.py --frames-against DIR [--rounds 30]

instead times whole frames of this tree against those of another
checkout of the repository under DIR (its `fidget_tpu_torch` is
imported beside the tree's under another name and builds its own
kernels): warm `PixelRenderer.render()` at 1024^2 under the four tape
bindings and the 512^3 gyroid normals frame, one frame of each side by
turns, the side that goes first alternating, on the host clock around
a synchronized frame. Both sides see the same drift of a shared host,
which two separate runs do not.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
STEMS = ("interp_float", "interp_interval")


def capture_inputs(port, cs, render2d):
    """{label: (kernel name, args, kwargs)} from one frame of the
    bucketed binding and one of the two-level binding."""
    from fidget_tpu_torch.scenes import standin_shape

    ctx = port.Context()
    tape = port.lower(ctx, [standin_shape(ctx)])
    size = port.ImageSize(cs.SIZE, cs.SIZE)
    calls = {}
    where = lambda a: "root" if a[0].shape[0] == 1 else "subtiles"
    for label, opts in (("bucketed", {}),
                        ("two-level", dict(tile_sizes=(128, 32)))):
        r = port.PixelRenderer(tape, size, **opts)
        store = {}
        targets = [
            (render2d, "interp_interval", lambda a, k: "interp_interval@" + where(a)),
            (render2d, "interp_float", lambda a, k: "interp_float@leaf"),
        ]
        with cs.capture_kernel_inputs(targets, store):
            r.render(cs.FRAMES[0])
        torch.cuda.synchronize()
        for key, (args, kwargs) in store.items():
            calls[f"{label} {key}"] = (key.split("@")[0], args, kwargs)
    return calls


def use_sources(cuda, csrc):
    """Points the loader at another source directory."""
    cuda.CSRC = pathlib.Path(csrc).resolve()
    cuda._LIBS.clear()


def dump(cuda, name, out_root):
    """Disassembly and ptxas logs of the two kernels of the current
    sources, into `out_root/name`."""
    out = out_root / name
    out.mkdir(parents=True, exist_ok=True)
    build = cuda.build()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for stem in STEMS:
        shutil.copy(build / f"{stem}.log", out / f"{stem}.log")
        sass = subprocess.run(
            [tool, "-sass", str(build / f"lib{stem}.so")],
            capture_output=True, text=True,
        )
        (out / f"{stem}.sass").write_text(sass.stdout + sass.stderr)
        for line in (build / f"{stem}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name} {stem}: {line.strip()}", flush=True)


def load_package(root, name):
    """Imports `root/fidget_tpu_torch` as the top-level package `name`
    (the package imports itself only relatively)."""
    pkg_dir = pathlib.Path(root).resolve() / "fidget_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py", submodule_search_locations=[str(pkg_dir)]
    )
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def frames_in_turns(cs, sides, rounds):
    """Warm frames of every binding on each side by turns; `sides` maps
    a label to an imported package."""
    frames = {}
    for side, pkg in sides.items():
        scenes = importlib.import_module(pkg.__name__ + ".scenes")
        ctx = pkg.Context()
        tape = pkg.lower(ctx, [scenes.standin_shape(ctx)])
        size = pkg.ImageSize(cs.SIZE, cs.SIZE)
        view = cs.FRAMES[1]
        std = pkg.PixelRenderer(tape, size)
        spec = pkg.PixelRenderer(tape, size, specialize=True)
        two = pkg.PixelRenderer(tape, size, tile_sizes=(128, 32))
        mat, vec = std._mat4(view), std._var_vec(None)
        vox = pkg.VoxelRenderer(
            scenes.gyroid_sphere(pkg),
            pkg.VoxelSize(cs.SIZE3, cs.SIZE3, cs.SIZE3), tile_size=64,
            sub_size=16,
        )
        view3 = cs.VIEWS3[1][1]
        frames[side] = {
            "standard": lambda r=std: r.render(view),
            "coded": lambda r=std, m=mat, v=vec: r._frame(
                m, 0.0, v, leaf_coded=True),
            "specialized": lambda r=spec: r.render(view),
            "two-level": lambda r=two: r.render(view),
            "3D normals 512^3": lambda r=vox: r.render(view3),
        }
        for fn in frames[side].values():
            fn()
            fn()
        torch.cuda.synchronize()
    labels = list(next(iter(frames.values())))
    wall = {(label, side): [] for label in labels for side in sides}
    order = list(sides)
    for rnd in range(rounds):
        for label in labels:
            for side in order if rnd % 2 == 0 else order[::-1]:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                frames[side][label]()
                torch.cuda.synchronize()
                wall[label, side].append((time.perf_counter() - t0) * 1e3)
    a, b = order
    for label in labels:
        wa, wb = np.array(wall[label, a]), np.array(wall[label, b])
        print(f"{label:>18} | {a} median {np.median(wa):8.3f} min "
              f"{wa.min():8.3f} | {b} median {np.median(wb):8.3f} min "
              f"{wb.min():8.3f} ms | {a} faster in {int((wa < wb).sum())} of "
              f"{rounds} rounds", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=pathlib.Path, default=ROOT / "probe_out")
    ap.add_argument("--frames-against", type=pathlib.Path, default=None)
    ap.add_argument("--rounds", type=int, default=30)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import fidget_tpu_torch as port
    from fidget_tpu_torch.eval import cuda, interp
    from fidget_tpu_torch.render import render2d

    print(cs.phase_device(), flush=True)
    for tool in ("ncu", "nsys", "cuobjdump", "nvdisasm"):
        print(f"{tool}: {shutil.which(tool) or 'not on PATH'}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print("SM clock now / max:", smi.stdout.strip(), flush=True)
    if opts.frames_against is not None:
        other = load_package(opts.frames_against, "fidget_tpu_torch_other")
        frames_in_turns(cs, {"tree": port, "other": other}, opts.rounds)
        return 0

    tree = cuda.CSRC
    calls = capture_inputs(port, cs, render2d)
    for label, (name, args, kwargs) in calls.items():
        lens = args[3]
        print(f"{label}: arena {tuple(args[0].shape)}, planes "
              f"{tuple(args[4].shape)}, {int(lens.clamp(min=0).sum())} rows, "
              f"{ {k: v for k, v in kwargs.items() if k != 'op_order'} }",
              flush=True)
    builds = [("tree", tree)]
    for spec in opts.variant:
        vname, _, vdir = spec.partition("=")
        builds.append((vname, ROOT / vdir))
    builds.append(("tree again", tree))
    fns = {"interp_float": interp.interp_float,
           "interp_interval": interp.interp_interval}
    reference = {}
    for bname, csrc in builds:
        use_sources(cuda, csrc)
        dump(cuda, bname.replace(" ", "_"), opts.out)
        for label, (name, args, kwargs) in calls.items():
            fn = fns[name]
            got = fn(*args, **kwargs)
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            if label not in reference:
                reference[label] = got
            same = all(
                torch.equal(g.view(torch.int32), w.view(torch.int32))
                for g, w in zip(got, reference[label])
            )
            ms = cs.time_cuda(lambda: fn(*args, **kwargs), opts.reps)
            print(f"{bname:>14} | {label:<34} {ms:8.4f} ms  "
                  f"{'equal to tree' if same else 'DIFFERS from tree'}",
                  flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print("SM clock / power after:", smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
