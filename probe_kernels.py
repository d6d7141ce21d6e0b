#!/usr/bin/env python3
"""Where the interpreter kernels' time goes on one CUDA card.

Captures the inputs that the main paths of `chip_smoke.py` hand to
`interp_float` (K3), `interp_interval` (K1), `liveness_codes` (K2),
`interp_float_coded` (K6), `interp_grad` (K4) and `interp_voxel_depth`
(K5): the 2D bucketed binding (K1, K2 and K3 at the root tiles and the
leaf), its coded leaf (K6 at the tape's registers, and again at the
bucket's nf 64), the two-level (128, 32) binding (K1 and K2 at the root
under the shape's `op_order` and per instance at the subtiles, K3 over
the leaves) and the 512^3 gyroid frame (K2 shared and per instance; K4
over the normals and K5 on its heaviest stratum, at the tape's
registers and again at the bucket's nf 64), and the interleave probe's
variants on the reference's tapes (`fidget_tpu_torch.demos.
exp_interleave`: K3 on 256 instances, the two-stream kernel on 128 at
its geometry's lanes a thread and at 4). Then, for this tree and for every
`--variant NAME=DIR`, it times each kernel on those inputs by CUDA
events, in turns (tree, variants..., tree). DIR is either a full copy
of `fidget_tpu_torch/csrc` with an experiment edited in (built and
called through this tree's wrappers, so it must keep their C
interface), or the root of another checkout of the repository (its
`fidget_tpu_torch` is imported beside this tree's and called through
its own wrappers: the parent commit, say). For each build it also
writes the disassembly (`cuobjdump -sass`) and nvcc's `-Xptxas -v` log
of the six kernels and P2 to `<out>/<name>/` (default `probe_out/`), where
the instructions of one tape row can be counted per opcode. Last, it
times K4 and K5 of this tree at each number of lanes a thread they can
take (`cuda.GRAD_LANES`, `cuda.VOXEL_LANES`).

    python3 probe_kernels.py [--variant NAME=DIR ...] [--reps 20] [--out DIR]

A variant may compute wrong values (an ablation that drops the
arithmetic, say): results are compared with the tree's and the
agreement is reported, not required.

    python3 probe_kernels.py --frames-against DIR [--rounds 30]

instead times whole frames of this tree against those of another
checkout of the repository under DIR (its `fidget_tpu_torch` is
imported beside the tree's under another name and builds its own
kernels): warm `PixelRenderer.render()` at 1024^2 under the four tape
bindings, the 512^3 gyroid normals frame and the four compiled 2D
frames (`render_unrolled` with the union leaf, the full leaf under
both culls, and `render_dense`), one frame of each side by
turns, the side that goes first alternating, on the host clock around
a synchronized frame. Both sides see the same drift of a shared host,
which two separate runs do not.

    python3 probe_kernels.py --unrolled [--variant NAME=DIR ...] [--guard]

instead works on the two kernels generated per tape, U1 and U2
(eval/unrolled_cuda.py): it builds the kernels of `chip_smoke.py`'s
phase 6c cold, for this tree and for each checkout DIR (the parent,
or an edited copy of this checkout under `_archive/` that tries
another emitter or template), printing each batch's wall time and its
slowest steps; captures the U1 and U2 calls of one frame of each
compiled mode (union leaf, full leaf under the unrolled and the
interpreter cull, dense) at the first view; times the tree's and
every DIR's kernels on them by turns; and last the dense frame through
the stand-in at 100, 200 and 400 circles (its full 800 is the tree's):
time against issue floor by program length.
Each line gives the SASS instructions a row and lane by class
(`cuobjdump -sass`) with the issue and MUFU floors they give
(`chip_smoke.unrolled_floors`). `--guard` first runs `chip_smoke.py`'s
unrolled guard (phase 6e) on every DIR's kernels, then on the tree's.

    python3 probe_kernels.py --interleave [--variant NAME=DIR ...]

instead works on the interleave probe alone (P2, csrc/interleave.cu):
variant A (K3 on the reference's 256 instances) and variant B (the
two-stream kernel on 128) at the geometry's lanes a thread and at 4, 2
and 1, for this tree and every DIR (a csrc copy or a checkout, as
above), timed by CUDA events in `--rounds-unrolled` rounds by turns,
the order reversed every other round; medians and minima per build,
B's agreement with the tree's, and per build the static SASS of each
instance of the two-stream kernel by class (`cuobjdump -sass`, the
listing written to `<out>/<name>/interleave.sass`, where a row's path
can be read), with its registers.

    python3 probe_kernels.py --mesher [--variant NAME=DIR ...]

instead works on the compiled mesher's kernels (mesh/fused.py, phase
11b of `chip_smoke.py`): from warm depth-8 builds of the sphere union
and the gyroid sphere under `chip_smoke.MESH_VIEW` it captures the
inputs of the edge core and of every level core, then times by turns
(`--rounds-unrolled` rounds, the order reversed every other round)
this tree's and each checkout DIR's (the parent, its `fidget_tpu_torch`
imported beside the tree's) edge core (the tree's with the crossing
list it builds in the chain) and level cores on them by CUDA events,
with the profiler's device time a kernel inside one call of each; the
leaf core and a build's collapse rounds likewise (`table_probe`: the
tree's on U1-P's sign table, with device ms and device ops a call);
then
U2-B's level kernel of this tree at each (block, register cap) of
BOX_VARIANTS on the union's and gyroid's largest level, with each
variant's ptxas registers and spills (and the 7,203-op stand-in's);
last, whole depth-8 builds of both scenes, each side in both eval
modes, by turns (host clock, synchronized).

    python3 probe_kernels.py --compiled3d [--variant NAME=DIR ...]

instead works on the compiled 3D frame's kernels (U1-3D, U2-3D;
`chip_smoke.py` phase 9b): for this tree and each checkout DIR (the
parent, its `fidget_tpu_torch` imported beside the tree's) it builds the
512^3 gyroid sphere's frames (bucketed, per-shape, unrolled leaf, leaf +
proofs) and the 128^3 sphere union's compiled frame, captures the U1-3D
and U2-3D calls of one frame of the compiled ones (this tree: one
`unrolled_proofs3` and a `unrolled_voxel_fold` a stratum; the parent: 1
+ ntz `unrolled_interval3` and a `unrolled_voxel_depth` and
`stratum_fold` a stratum) and times each side's U2-3D and U1-3D work of
a frame by turns (CUDA events, `--rounds-unrolled` rounds) with the
profiler's device time by kernel; then the tree's U2-3D at every layout
of PROOFS3_WARPS (with ptxas spills and linked registers, also at the
7,203-op stand-in's) and U1-3D at every group of VOXEL_GROUPS on the
same inputs; last, whole frames of every side by turns (host clock,
synchronized), equal to the tree's, with busy share and device ops a
frame.

    python3 probe_kernels.py --unrolled-builds

instead builds the kernels generated for the 2D stand-in
(eval/unrolled_cuda.py: U1 of the full tape and of the union plan of
`chip_smoke.py`'s phase 6c, U2 with each epilogue) cold, one kernel at
a time, each into an empty build directory under `--out`: the wall time
of its nvcc steps, the ptxas compile time its logs report, and a
second, cached build; then the union kernel once more as a single
translation unit without -rdc (the programs and the kernel in one
file), the alternative to one unit a program.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import inspect
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
STEMS = ("interp_float", "interp_interval", "liveness", "interp_float_coded",
         "interp_grad", "interp_voxel_depth", "interleave")
#: kernel name -> (module under fidget_tpu_torch, wrapper)
WRAPPERS = {
    "interp_float": ("eval.interp", "interp_float"),
    "interp_interval": ("eval.interp", "interp_interval"),
    "liveness_codes": ("eval.simplify_device", "liveness_codes"),
    "interp_float_coded": ("eval.interp", "interp_float_coded"),
    "interp_grad": ("eval.interp", "interp_grad"),
    "interp_voxel_depth": ("eval.interp", "interp_voxel_depth"),
    "interp_float2": ("demos.exp_interleave", "interp_float2"),
}


def capture_inputs(port, cs, render2d, render3d, simplify_device):
    """{label: (kernel name, args, kwargs)} from one frame of each
    binding: bucketed, coded leaf, two-level, and the 3D gyroid."""
    from fidget_tpu_torch.scenes import gyroid_sphere, standin_shape

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
            (render2d, "liveness_codes", lambda a, k: "liveness_codes@root"),
            (simplify_device, "liveness_codes",
             lambda a, k: "liveness_codes@" + where(a)),
        ]
        with cs.capture_kernel_inputs(targets, store):
            r.render(cs.FRAMES[0])
        torch.cuda.synchronize()
        for key, (args, kwargs) in store.items():
            calls[f"{label} {key}"] = (key.split("@")[0], args, kwargs)
        if label == "bucketed":
            # the root's K2 at the tape's registers (one mask word a lane)
            args, kwargs = store["liveness_codes@root"]
            calls[f"{label} liveness_codes@root nf {r._nf_regs}"] = (
                "liveness_codes", args, dict(kwargs, nf=r._nf_regs))
            store = {}
            targets = [(render2d, "interp_float_coded",
                        lambda a, k: "interp_float_coded@leaf")]
            with cs.capture_kernel_inputs(targets, store):
                r._frame(r._mat4(cs.FRAMES[0]), 0.0, r._var_vec(None),
                         leaf_coded=True)
            args, kwargs = store["interp_float_coded@leaf"]
            calls["coded interp_float_coded@leaf"] = (
                "interp_float_coded", args, kwargs)
            calls["coded interp_float_coded@leaf nf 64"] = (
                "interp_float_coded", args, dict(kwargs, nf=r.nf_b))
    vox = port.VoxelRenderer(
        gyroid_sphere(port), port.VoxelSize(cs.SIZE3, cs.SIZE3, cs.SIZE3),
        tile_size=64, sub_size=16, specialize=False,
    )
    store = {}
    targets = [
        (render2d, "liveness_codes", lambda a, k: "liveness_codes@root"),
        (simplify_device, "liveness_codes",
         lambda a, k: "liveness_codes@instances"),
        (render3d, "interp_grad", lambda a, k: "interp_grad@normals"),
        (render3d, "interp_voxel_depth",
         lambda a, k: "interp_voxel_depth@voxels"),
    ]
    with cs.capture_kernel_inputs(targets, store):
        vox.render(cs.VIEWS3[0][1])
    torch.cuda.synchronize()
    for key, (args, kwargs) in store.items():
        calls[f"3D {key}"] = (key.split("@")[0], args, kwargs)
        if key.startswith(("interp_grad", "interp_voxel_depth")):
            calls[f"3D {key} nf {vox.nf_b}"] = (
                key.split("@")[0], args, dict(kwargs, nf=vox.nf_b))
    # the interleave probe's variants A and B on the reference's tapes
    from fidget_tpu_torch.demos import exp_interleave as p2

    ref = p2.reference_inputs(torch.device("cuda"))
    calls["probe interp_float@reference"] = ("interp_float", ref, dict(
        nf=p2.NF_REF, n_inputs=p2.V_REF, n_outputs=1, s0=p2.S0_REF))
    for r in (0, 4):  # the geometry's choice, then K3's lanes a thread
        label = "probe interp_float2@reference" + (f" lanes {r}" if r else "")
        calls[label] = ("interp_float2", p2.split_streams(*ref),
                        dict(nf=p2.NF_REF, s0=p2.S0_REF, lanes_per_thread=r))
    return calls


def device_note(cs, fn, name, args, kwargs, label):
    """The profiler's device time of a 3D call's kernel, whose
    CUDA-event time can be the host's enqueue at these sizes."""
    if not label.startswith("3D interp_"):
        return ""
    dms = cs.device_ms(lambda: fn(*args, **kwargs), name + "_kernel")
    return "" if dms is None else f", device {dms:.4f} ms"


def lanes_a_thread(cs, cuda, calls, reps):
    """K4 and K5 of this tree at each number of lanes a thread they may
    take, on the 3D path's inputs."""
    for label, (name, args, kwargs) in calls.items():
        if not label.startswith("3D interp_grad@") and not label.startswith(
                "3D interp_voxel_depth@"):
            continue
        attr = "GRAD_LANES" if name == "interp_grad" else "VOXEL_LANES"
        fn = getattr(importlib.import_module("fidget_tpu_torch.eval.interp"),
                     name)
        saved = getattr(cuda, attr)
        want = fn(*args, **kwargs)
        for r in ((2, 1) if name == "interp_grad" else (4, 2, 1)):
            setattr(cuda, attr, (r,))
            cuda.launch_geometry.cache_clear()
            got = fn(*args, **kwargs)
            same = torch.equal(got.view(torch.int32), want.view(torch.int32))
            ms = cs.time_cuda(lambda: fn(*args, **kwargs), reps)
            g = cuda.launch_geometry(
                name, nf=kwargs["nf"], lanes=args[4].shape[-2] * 128,
                T=args[4].shape[0], sub=kwargs.get("sub", 0))
            print(f"{'lanes ' + str(r):>14} | {label:<34} {ms:8.4f} ms  "
                  f"{g.smem} B shared, {g.blocks} blocks, "
                  f"{'equal' if same else 'DIFFERS'}"
                  f"{device_note(cs, fn, name, args, kwargs, label)}",
                  flush=True)
        setattr(cuda, attr, saved)
        cuda.launch_geometry.cache_clear()



def use_sources(cuda, csrc):
    """Points the loader at another source directory."""
    cuda.CSRC = pathlib.Path(csrc).resolve()
    cuda._LIBS.clear()


def dump(cuda, name, out_root):
    """Disassembly and ptxas logs of the kernels of the current sources,
    into `out_root/name`."""
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
        # the bucketed 3D frame on every side: a checkout from before
        # `specialize` existed renders only that one
        bucketed = ({"specialize": False} if "specialize" in
                    inspect.signature(pkg.VoxelRenderer).parameters else {})
        vox = pkg.VoxelRenderer(
            scenes.gyroid_sphere(pkg),
            pkg.VoxelSize(cs.SIZE3, cs.SIZE3, cs.SIZE3), tile_size=64,
            sub_size=16, **bucketed,
        )
        view3 = cs.VIEWS3[1][1]
        frames[side] = {
            "standard": lambda r=std: r.render(view),
            "coded": lambda r=std, m=mat, v=vec: r._frame(
                m, 0.0, v, leaf_coded=True),
            "specialized": lambda r=spec: r.render(view),
            "two-level": lambda r=two: r.render(view),
            "3D normals 512^3": lambda r=vox: r.render(view3),
            "unrolled union": lambda r=std: r.render_unrolled(
                view, leaf="union"),
            "unrolled full": lambda r=std: r.render_unrolled(view,
                                                             leaf="full"),
            "unrolled full-interp": lambda r=std: r.render_unrolled(
                view, leaf="full", cull="interp"),
            "dense": lambda r=std: r.render_dense(view),
        }
        for fn in frames[side].values():
            fn()
            _wait_refresh(pkg, std)
            fn()
            _wait_refresh(pkg, std)
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


def unrolled_builds(cs, port, out):
    """Cold builds of the stand-in's generated kernels, one kernel at a
    time (see the module doc)."""
    import re
    import tempfile

    from fidget_tpu_torch.compiler.unions import build_union_plan
    from fidget_tpu_torch.eval import cuda
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.render import unrolled2d as u2
    from fidget_tpu_torch.scenes import standin_shape

    ctx = port.Context()
    tape = port.lower(ctx, [standin_shape(ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(cs.SIZE, cs.SIZE))
    T0 = cs.UNROLLED_T0
    n0x = cs.SIZE // T0
    plan = build_union_plan(tape, T0, n0x, n0x, r._mat4(cs.FRAMES[0]), 0.0,
                            r._var_vec(None), r.axis_of,
                            block_px=cs.UNROLLED_BLOCK)
    st = u2.state(r)
    union = u2.union_tables(r, plan, max(128, -(-(n0x * n0x // 64) // 128)
                                         * 128)).kernel
    kernels = {"U1 full": st.float_full, "U1 union": union,
               **{f"U2 {e}": st.interval(e) for e in uc.EPILOGUES}}

    def ptxas_ms(d):
        times = [float(m) for p in pathlib.Path(d).rglob("*.log")
                 for m in re.findall(r"Compile time = ([0-9.]+) ms",
                                     p.read_text())]
        return sum(times), max(times, default=0.0)

    out.mkdir(parents=True, exist_ok=True)
    root = cuda.BUILD_ROOT
    try:
        for label, k in kernels.items():
            with tempfile.TemporaryDirectory(dir=out) as d:
                cuda.BUILD_ROOT = pathlib.Path(d)
                k._unit = None
                t0 = time.perf_counter()
                steps = uc.build_kernels([k])
                cold = time.perf_counter() - t0
                t0 = time.perf_counter()
                again = uc.build_kernels([k])
                cached = time.perf_counter() - t0
                total, most = ptxas_ms(d)
                print(f"{label}: {len(steps)} nvcc steps, cold {cold:.1f} s "
                      f"wall; ptxas {total / 1e3:.1f} s in all, "
                      f"{most / 1e3:.1f} s at most in one unit; cached "
                      f"{cached:.3f} s ({len(again)} steps)", flush=True)
            k._unit = None
        with tempfile.TemporaryDirectory(dir=out) as d:
            unit = union.unit()
            progs = {o.key: o.source for o in unit.objects}
            src = pathlib.Path(d) / "union_one_unit.cu"
            src.write_text("".join(progs.values()) + unit.source)
            cmd = [cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC),
                   "-o", str(pathlib.Path(d) / "lib.so"), str(src)]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            (pathlib.Path(d) / "one.log").write_text(res.stdout + res.stderr)
            total, _ = ptxas_ms(d)
            print(f"U1 union as one translation unit ({len(progs)} programs, "
                  f"no -rdc): nvcc exit {res.returncode}, {wall:.1f} s wall, "
                  f"ptxas {total / 1e3:.1f} s", flush=True)
    finally:
        cuda.BUILD_ROOT = root


#: the compiled frames' modes whose U1 / U2 calls `--unrolled` captures
UNROLLED_MODES = {
    "union": dict(leaf="union"),
    "full": dict(leaf="full"),
    "full-interp": dict(leaf="full", cull="interp"),
    "dense": None,
}


def _wait_refresh(pkg, r):
    u2 = importlib.import_module(pkg.__name__ + ".render.unrolled2d")
    st = u2.state(r)
    while any(st.refreshing.values()):
        time.sleep(0.2)


def _phase_6c(cs, pkg):
    """The stand-in's renderer with chip_smoke's union plan installed,
    and the kernels phase 6c builds (U1 full and union, U2 proofs and
    violation, U1 of the parametrized stand-in), of package `pkg`."""
    scenes = importlib.import_module(pkg.__name__ + ".scenes")
    unions = importlib.import_module(pkg.__name__ + ".compiler.unions")
    u2 = importlib.import_module(pkg.__name__ + ".render.unrolled2d")
    ctx = pkg.Context()
    tape = pkg.lower(ctx, [scenes.standin_shape(ctx)])
    size = pkg.ImageSize(cs.SIZE, cs.SIZE)
    r = pkg.PixelRenderer(tape, size)
    T0, n0 = cs.UNROLLED_T0, cs.SIZE // cs.UNROLLED_T0
    plan = unions.build_union_plan(tape, T0, n0, n0, r._mat4(cs.FRAMES[0]),
                                   0.0, r._var_vec(None), r.axis_of,
                                   block_px=cs.UNROLLED_BLOCK)
    st = u2.state(r)
    st.plans[(T0, cs.UNROLLED_BLOCK)] = plan
    fb_cap = max(128, -(-(n0 * n0 // 64) // 128) * 128)
    ctx = pkg.Context()
    shift, grow = pkg.Var.new(), pkg.Var.new()
    ptape = pkg.lower(ctx, [scenes.param_standin_shape(
        ctx, ctx.input(shift), ctx.input(grow))])
    rp = pkg.PixelRenderer(ptape, size)
    kernels = [st.float_full, u2.union_tables(r, plan, fb_cap).kernel,
               st.interval("proofs"), st.interval("violation"),
               u2.state(rp).float_full]
    return r, kernels


def _step_kinds(kernels, steps):
    """The build steps' finishing times (s) by kind and kernel: kernel
    units, their links, and the objects they call."""
    names = ["U1 full", "U1 union", "U2 proofs", "U2 violation",
             "U1 full (parametrized)"]
    label = {}
    for name, k in zip(names, kernels):
        u = k.unit()
        label[u.key] = f"{name} kernel unit ({len(u.source) // 1024} KiB)"
        label[u.key + ":link"] = f"{name} link"
        for o in u.objects:
            label.setdefault(o.key, f"{name} object "
                                    f"({len(o.source) // 1024} KiB)")
    done = sorted(steps.items(), key=lambda kv: kv[1])
    return "; ".join(f"{label.get(k, k)} {v:.1f}" for k, v in done[-8:])


def _time_runs(cs, runs, opts, what):
    """Times each run (variant, module, mode, kernel name, kernel, args,
    kwargs) by CUDA events, every run once a round, in reversed order
    every other round; prints each with its agreement with the first run
    of its mode and its SASS counts and floors."""
    want = {}
    sames = []
    for vlabel, mod, mode, name, k, args, kwargs in runs:
        got = getattr(mod, name)(*args, **kwargs)
        torch.cuda.synchronize()
        key = (mode, name)
        got = got if isinstance(got, tuple) else (got,)
        want.setdefault(key, got)
        sames.append(all((g is None and w is None) or torch.equal(
            g.view(torch.int32) if g.dtype == torch.float32 else g,
            w.view(torch.int32) if w.dtype == torch.float32 else w)
            for g, w in zip(got, want[key])))
    times = [[] for _ in runs]
    order = list(range(len(runs)))
    for rnd in range(opts.rounds_unrolled):
        for i in (order if rnd % 2 == 0 else order[::-1]):
            vlabel, mod, mode, name, k, args, kwargs = runs[i]
            fn = getattr(mod, name)
            times[i].append(cs.time_cuda(lambda: fn(*args, **kwargs),
                                         opts.reps))
    for i, (vlabel, mod, mode, name, k, args, kwargs) in enumerate(runs):
        ms = np.array(times[i])
        _, _, _, ops, _ = cs._unrolled_bound(
            name, args, kwargs, getattr(mod, name)(*args, **kwargs))
        fl = cs.unrolled_floors(k, ops if name == "unrolled_float"
                                else ops // 2)
        fl_s = ("SASS not measured" if fl is None else
                f"{fl['sass_per_row']:.3f} SASS/row-lane "
                f"({fl['mufu_per_row']:.3f} MUFU) issue floor "
                f"{fl['issue_floor_ms']:.4f} ms, MUFU floor "
                f"{fl['mufu_floor_ms']:.4f} ms, {fl['sass']}")
        extra = (f", {k.schedule().k} warps, {k.schedule().n_stages} "
                 f"stages, {k.schedule().n_slots} slots"
                 if hasattr(k, "schedule") else "")
        print(f"{what} {name} {mode:>11} | {vlabel:<30} median "
              f"{np.median(ms):.4f} min {ms.min():.4f} ms ({len(ms)} "
              f"rounds){extra}; "
              f"{'equal to first' if sames[i] else 'DIFFERS from first'}; "
              f"{fl_s}", flush=True)


def unrolled_probe(cs, port, others, opts):
    """`--unrolled` (see the module doc); `others` maps each variant's
    name to its checkout's package."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.render import unrolled2d as u2

    sides = {"tree": port, **others}
    if opts.guard:
        for side, pkg in reversed(list(sides.items())):
            cs.phase_unrolled_guard(pkg, label=side)
    r = None
    for side, pkg in sides.items():
        ouc = importlib.import_module(pkg.__name__ + ".eval.unrolled_cuda")
        rr, kernels = _phase_6c(cs, pkg)
        cold = not any(k.unit().lib.exists() for k in kernels)
        t0 = time.perf_counter()
        steps = ouc.build_kernels(kernels)
        print(f"phase 6c build | {side}: {len(steps)} nvcc steps, "
              f"{time.perf_counter() - t0:.1f} s wall "
              f"({'cold' if cold else 'NOT cold'})", flush=True)
        print(f"phase 6c build | {side}: " + _step_kinds(kernels, steps),
              flush=True)
        if side == "tree":
            r = rr
    # the U1 / U2 calls of one frame of each mode, at the first view
    calls = {}
    saved = {n: getattr(u2, n) for n in cs.UNROLLED_KERNELS}
    current = [None]

    def recorder(name):
        def call(*args, **kwargs):
            calls[(current[0], name)] = (args, kwargs)
            return saved[name](*args, **kwargs)
        return call

    for n in cs.UNROLLED_KERNELS:
        setattr(u2, n, recorder(n))
    try:
        for mode, kw in UNROLLED_MODES.items():
            current[0] = mode
            (r.render_dense(cs.FRAMES[0]) if kw is None
             else r.render_unrolled(cs.FRAMES[0], **kw))
            _wait_refresh(port, r)
    finally:
        for n, f in saved.items():
            setattr(u2, n, f)
    torch.cuda.synchronize()
    # variants: (label, package's unrolled_cuda, kernel like the tree's)
    variants = [("tree", uc, lambda k: k)]
    for name, pkg in others.items():
        puc = importlib.import_module(pkg.__name__ + ".eval.unrolled_cuda")

        def make(k, puc=puc):
            if hasattr(k, "tapes"):
                return puc.FloatKernel(k.tapes, k.axis_of, k.V)
            return puc.IntervalKernel(k.tape, k.axis_of, k.V, k.epilogue)

        variants.append((name, puc, make))
    # the dense frame through stand-ins of growing length (n circles)
    scenes = importlib.import_module("fidget_tpu_torch.scenes")
    dense_args = calls[("dense", "unrolled_float")]
    prefixes = {}
    for n_c in (100, 200, 400):
        ctx = port.Context()
        pt = port.lower(ctx, [scenes.standin_shape(ctx, n=n_c)])
        prefixes[len(pt) - 1] = uc.FloatKernel([pt], r.axis_of, r.n_inputs)
    runs = [(vlabel, mod, mode, name, k, (k,) + tuple(args[1:]), kwargs)
            for vlabel, mod, make in variants
            for (mode, name), (args, kwargs) in calls.items()
            for k in [make(args[0])]]
    _time_runs(cs, runs, opts, "main")
    t0 = time.perf_counter()
    steps = uc.build_kernels(list(prefixes.values()))
    print(f"prefix builds: {len(prefixes)} kernels, {len(steps)} steps, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    args, kwargs = dense_args
    for n, k in prefixes.items():
        a = (k,) + tuple(args[1:])
        uc.unrolled_float(*a, **kwargs)
        ms = [cs.time_cuda(lambda: uc.unrolled_float(*a, **kwargs), opts.reps)
              for _ in range(3)]
        pix = args[1].shape[0] * kwargs["pp"]
        fl = cs.unrolled_floors(k, pix * (n + 1))
        print(f"unrolled_float dense stand-in | {n + 1:>5} rows: median "
              f"{np.median(ms):.4f} ms, "
              f"{np.median(ms) * 1e6 / (pix * (n + 1)) * 1e3:.4f} ps a "
              f"row-pixel"
              + ("" if fl is None else
                 f"; issue floor {fl['issue_floor_ms']:.4f} ms, "
                 f"{fl['sass_per_row']:.2f} SASS/row-pixel"), flush=True)


def sass_by_function(cs, text):
    """{function: {class: instructions}} of a `cuobjdump -sass` listing,
    by `chip_smoke.SASS_CLASSES` (NOPs not counted), with their total."""
    import re

    out = {}
    counts = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            counts = out[m.group(1)] = dict.fromkeys(
                [*cs.SASS_CLASSES, "rest", "total"], 0)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?"
                      r"([A-Z0-9_]+)", line)
        if m and counts is not None and m.group(1) != "NOP":
            counts[next((k for k, ops in cs.SASS_CLASSES.items()
                         if m.group(1) in ops), "rest")] += 1
            counts["total"] += 1
    return out


def interleave_probe(cs, port, cuda, opts):
    """`--interleave` (see the module doc)."""
    from fidget_tpu_torch.demos import exp_interleave as p2

    dev = torch.device("cuda")
    ref = p2.reference_inputs(dev)
    args_b = p2.split_streams(*ref)
    calls = [("A", "interp_float", ("eval.interp", "interp_float"), ref,
              dict(nf=p2.NF_REF, n_inputs=p2.V_REF, n_outputs=1,
                   s0=p2.S0_REF))]
    for r in (0, 4, 2, 1):
        calls.append((f"B lanes {r or 'geometry'}", "interp_float2",
                      ("demos.exp_interleave", "interp_float2"), args_b,
                      dict(nf=p2.NF_REF, s0=p2.S0_REF, lanes_per_thread=r)))
    builds = [("tree", port, cuda.CSRC)]
    for spec in opts.variant:
        vname, _, vdir = spec.partition("=")
        vdir = ROOT / vdir
        if (vdir / "fidget_tpu_torch").is_dir():
            builds.append((vname, load_package(vdir,
                                               "fidget_tpu_torch_" + vname),
                           None))
        else:
            builds.append((vname, port, vdir))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def activate(pkg, csrc):
        bcuda = importlib.import_module(pkg.__name__ + ".eval.cuda")
        if csrc is not None:
            use_sources(bcuda, csrc)
        return bcuda

    fns = {}
    want = {}
    for bname, pkg, csrc in builds:
        bcuda = activate(pkg, csrc)
        out = bcuda.build()
        lib = out / "libinterleave.so"
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True).stdout
        res = subprocess.run([tool, "-res-usage", str(lib)],
                             capture_output=True, text=True).stdout
        d = opts.out / bname.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        (d / "interleave.sass").write_text(sass)
        print(f"{bname:>10} | registers: " + "; ".join(
            line.strip() for line in res.splitlines() if "REG:" in line),
            flush=True)
        for fname, counts in sass_by_function(cs, sass).items():
            print(f"{bname:>10} | SASS {fname}: {counts}", flush=True)
        for label, name, (mod, wrapper), args, kwargs in calls:
            fn = getattr(importlib.import_module(f"{pkg.__name__}.{mod}"),
                         wrapper)
            fns[(bname, label)] = fn
            got = fn(*args, **kwargs)
            torch.cuda.synchronize()
            key = name
            if key not in want:
                want[key] = got
            same = bool(((got.view(torch.int32) == want[key].view(
                torch.int32)) | (torch.isnan(got) & torch.isnan(
                    want[key]))).all())
            print(f"{bname:>10} | {label:<22} "
                  f"{'equal to tree' if same else 'DIFFERS from tree'}",
                  flush=True)
    times = {k: [] for k in fns}
    order = list(range(len(builds)))
    for rnd in range(opts.rounds_unrolled):
        for i in (order if rnd % 2 == 0 else order[::-1]):
            bname, pkg, csrc = builds[i]
            activate(pkg, csrc)
            for label, name, _, args, kwargs in calls:
                fn = fns[(bname, label)]
                times[(bname, label)].append(cs.time_cuda(
                    lambda: fn(*args, **kwargs), opts.reps))
    steps = ref[0].shape[0] * ref[0].shape[1]
    for (bname, label), ms in times.items():
        ms = np.array(ms)
        print(f"{bname:>10} | {label:<22} median {np.median(ms):.4f} min "
              f"{ms.min():.4f} ms ({len(ms)} rounds of {opts.reps}), "
              f"{np.median(ms) / steps * 1e6:.4f} ns a row", flush=True)
    activate(port, cuda.CSRC)


#: U2-B's (threads a block, nvcc flags) that `--mesher` times
BOX_VARIANTS = [(block, (f"-maxrregcount={regs}",) if regs else ())
                for block in (64, 128, 256) for regs in (64, 128, None)]


def _device_split(fn, names):
    """Device ms of one call of fn by kernel: each of `names` (matched
    within the profiler's kernel names), the rest as "other"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        out = {n: 0.0 for n in names}
        out["other"] = 0.0
        for e in prof.key_averages():
            t = e.self_device_time_total / 1e3
            if t <= 0:
                continue
            hit = next((n for n in names if n in e.key), "other")
            out[hit] += t
        if sum(out.values()) > 0:
            return out
    return None


def mesher_probe(cs, port, others, opts):
    """`--mesher` (see the module doc); `others` maps each checkout's
    name to its package."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.mesh import fused

    dev = torch.device(getattr(opts, "device", "cuda"))
    sides = {"tree": port, **others}

    def settings(pkg, mode="unrolled"):
        kw = {"eval": "unrolled"} if mode == "unrolled" else {}
        return pkg.MeshSettings(depth=cs.MESH_DEPTH,
                                world_to_model=cs.MESH_VIEW, device=dev, **kw)

    scenes = {side: cs._mesh_scenes(pkg) for side, pkg in sides.items()}
    evs = {}
    for side, pkg in sides.items():
        for tag, _, scene in scenes[side]:
            t0 = time.perf_counter()
            pkg.build_mesh(scene, settings(pkg))  # builds the kernels
            pkg.build_mesh(scene, settings(pkg, "interp"))
            tape = scene.tape() if isinstance(scene, pkg.Shape) else scene
            evs[side, tag] = importlib.import_module(
                pkg.__name__ + ".mesh")._get_evaluator(tape, dev, True)
            print(f"mesher | {side} {tag}: first builds "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    cap = {}
    saved = (fused.edges_core, fused.level_core)
    for tag, _, scene in scenes["tree"]:
        cap[tag] = {"levels": []}

        def rec_edges(*a, tag=tag):
            cap[tag]["edges"] = a
            return saved[0](*a)

        def rec_level(*a, tag=tag):
            cap[tag]["levels"].append(a)
            return saved[1](*a)

        fused.edges_core, fused.level_core = rec_edges, rec_level
        try:
            port.build_mesh(scene, settings(port))
        finally:
            fused.edges_core, fused.level_core = saved
        ea = cap[tag]["edges"]
        print(f"mesher | {tag}: {int(ea[3])} surface cells, cs {ea[7]}, "
              f"{int(ea[11][3])} crossing slots of {ea[11][0].shape[0]}; "
              f"levels live " + "/".join(str(int(a[2])) for a in
                                          cap[tag]["levels"]), flush=True)

    def edge_fn(side, tag):
        pkg_fused = importlib.import_module(sides[side].__name__
                                            + ".mesh.fused")
        ev = evs[side, tag]
        a = cap[tag]["edges"]
        if side == "tree":
            ccap = a[11][0].shape[0]
            return lambda: pkg_fused.edges_core(
                ev, *a[1:11], pkg_fused.crossing_list(a[1], a[2], a[3],
                                                      ccap))
        return lambda: pkg_fused.edges_core(ev, *a[1:11])

    def level_fn(side, tag):
        pkg_fused = importlib.import_module(sides[side].__name__
                                            + ".mesh.fused")
        ev = evs[side, tag]
        return lambda: [pkg_fused.level_core(ev, *a[1:])
                        for a in cap[tag]["levels"]]

    names_e = ["fidget_unrolled_edges", "fidget_unrolled_points",
               "interp_grad_kernel"]
    names_l = ["fidget_unrolled_level", "fidget_unrolled_interval_boxes"]
    for tag in cap:
        for side in sides:
            for what, fn, names in (("edge core", edge_fn(side, tag), names_e),
                                    ("levels", level_fn(side, tag), names_l)):
                split = _device_split(fn, names)
                print(f"mesher | {tag} {what} | {side}: device ms a call "
                      + (", ".join(f"{k} {v:.4f}" for k, v in split.items())
                         if split else "not recorded"), flush=True)
        times = {(side, what): [] for side in sides
                 for what in ("edge core", "levels")}
        order = list(sides)
        for rnd in range(opts.rounds_unrolled):
            for side in (order if rnd % 2 == 0 else order[::-1]):
                times[side, "edge core"].append(
                    cs.time_cuda(edge_fn(side, tag), 5))
                times[side, "levels"].append(
                    cs.time_cuda(level_fn(side, tag), 5))
        for (side, what), v in times.items():
            print(f"mesher | {tag} {what} by turns | {side}: median "
                  f"{np.median(v):.4f} ms, min {min(v):.4f} ms over "
                  f"{len(v)} rounds (CUDA events, 5 calls each)", flush=True)

    # the leaf core and the collapse rounds (U1-P's sign table on the
    # tree, the dense corners and lattices on a checkout), by turns
    table_probe(cs, sides, scenes, settings, evs, opts)

    # U2-B variants on the largest level
    ctx = port.Context()
    from fidget_tpu_torch.scenes import standin_shape

    standin = port.lower(ctx, [standin_shape(ctx)])
    kinds = {v.kind: i for v, i in standin.var_map.items()}
    variants = {}
    for tag in cap:
        ev = evs["tree", tag]
        for block, flags in BOX_VARIANTS:
            variants[tag, block, flags] = uc.BoxesKernel(
                ev.tape, ev.axis_of, ev.n_inputs, block=block, flags=flags)
    for block, flags in BOX_VARIANTS:
        if block == uc.BOX_BLOCK:
            variants["standin", block, flags] = uc.BoxesKernel(
                standin, kinds, len(kinds), block=block, flags=flags)
    t0 = time.perf_counter()
    steps = uc.build_kernels(list(variants.values()))
    print(f"mesher | U2-B variants: {len(steps)} nvcc steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def regs(k, symbol):
        """The registers of `symbol` in k's linked library, its callees
        included (cuobjdump -res-usage)."""
        out = subprocess.run([tool, "-res-usage", str(k.unit().lib)],
                             capture_output=True, text=True).stdout
        lines = out.splitlines()
        for i, line in enumerate(lines[:-1]):
            if symbol in line:
                return lines[i + 1].strip()
        return "not found"

    for key, k in variants.items():
        lines, spill = cs._ptxas_lines(k.unit())
        print(f"mesher | U2-B {key}: spill bytes {spill}; linked "
              f"{regs(k, 'fidget_unrolled_level')}", flush=True)
    for tag in cap:
        k = fused._kernels(evs["tree", tag])["edges"]
        print(f"mesher | U1-P edges {tag}: spill bytes "
              f"{cs._ptxas_lines(k.unit())[1]}; linked "
              f"{regs(k, 'fidget_unrolled_edges')}", flush=True)
    for tag in cap:
        a = max(cap[tag]["levels"], key=lambda a: int(a[2]))
        kern0, keys, n_in, _, _, h_child, pos, neg, off3, vv, _ = (
            None, *a[1:])
        want = uc.level_active(fused._kernels(evs["tree", tag])["boxes"],
                               keys, n_in, h_child, pos, neg, off3, vv)
        ms = {key: [] for key in variants if key[0] == tag}
        keys_v = list(ms)
        for rnd in range(opts.rounds_unrolled):
            for key in (keys_v if rnd % 2 == 0 else keys_v[::-1]):
                fn = (lambda k=variants[key]: uc.level_active(
                    k, keys, n_in, h_child, pos, neg, off3, vv))
                if rnd == 0:
                    got = fn()
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        print(f"mesher | U2-B {key} DIFFERS", flush=True)
                ms[key].append(cs.time_cuda(fn, 20))
        for key, v in ms.items():
            print(f"mesher | U2-B level by turns | {tag}, {int(n_in) * 8} "
                  f"boxes, block {key[1]}, flags {key[2]}: median "
                  f"{np.median(v):.4f} ms, min {min(v):.4f}", flush=True)

    # whole builds by turns
    builds = {}
    order = [(side, tag, mode) for side in sides for tag in cap
             for mode in ("unrolled", "interp")]
    for rnd in range(opts.rounds_unrolled):
        for side, tag, mode in (order if rnd % 2 == 0 else order[::-1]):
            pkg = sides[side]
            scene = next(s for t, _, s in scenes[side] if t == tag)
            clock = importlib.import_module(
                pkg.__name__ + ".mesh")._StageClock(True, dev, echo=False)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pkg.build_mesh(scene, settings(pkg, mode), clock=clock)
            torch.cuda.synchronize()
            builds.setdefault((side, tag, mode), []).append(
                ((time.perf_counter() - t0) * 1e3, cs._stage_table(
                    clock.stages)))
    for (side, tag, mode), runs in builds.items():
        tot = [t for t, _ in runs]
        k = int(np.argsort(tot)[len(tot) // 2])
        print(f"mesher | build by turns | {tag} {mode} | {side}: median "
              f"{np.median(tot):.1f} ms, min {min(tot):.1f} ms over "
              f"{len(tot)}; stages of the median (ms): " + ", ".join(
                  f"{s} {v:.1f}" for s, v in runs[k][1].items()), flush=True)


def table_probe(cs, sides, scenes, settings, evs, opts):
    """`--mesher`'s leaf core and collapse rounds: the tree's leaf core
    (`leaf_core` with a table of its own) and a build's collapse rounds
    (`merge_core` round after round, from the table the leaf core left,
    each round at its own slab) captured from a warm depth-8 build of
    each scene, replayed on each side (a checkout's own `leaf_core` and
    `merge_core` on the same inputs and store), by turns by CUDA events
    (host clock of enqueue included: these cores are host-bound), and
    once under the profiler: device ms a call, device ops a call, the
    heaviest kernels."""
    from fidget_tpu_torch.mesh import fused

    port = sides["tree"]
    caps = {}
    saved = (fused.leaf_core, fused.merge_core)
    for tag, _, scene in scenes["tree"]:
        cap = caps[tag] = {"rounds": []}

        def rec_leaf(*a, cap=cap):
            cap["leaf"] = a[:9]
            return saved[0](*a)

        def rec_merge(store, mvid, pb3, ps, kcap, n_cand, cap=cap):
            if not cap["rounds"]:
                cap["table"] = store.table.clone()
            cap["rounds"].append((store, mvid, pb3, ps, kcap, n_cand,
                                  store.ext_base))
            return saved[1](store, mvid, pb3, ps, kcap, n_cand)

        fused.leaf_core, fused.merge_core = rec_leaf, rec_merge
        try:
            port.build_mesh(scene, settings(port))
        finally:
            fused.leaf_core, fused.merge_core = saved
        rounds = cap["rounds"]
        print(f"mesher | {tag}: leaf core over {int(cap['leaf'][2])} of "
              f"{cap['leaf'][1].shape[0]} cells; {len(rounds)} collapse "
              f"rounds of " + "/".join(str(r[5]) for r in rounds)
              + " candidates", flush=True)

    def leaf_fn(side, tag):
        pkg_fused = importlib.import_module(sides[side].__name__
                                            + ".mesh.fused")
        a = caps[tag]["leaf"]
        ev = evs[side, tag]
        return lambda: pkg_fused.leaf_core(ev, *a[1:])

    def rounds_fn(side, tag):
        pkg_fused = importlib.import_module(sides[side].__name__
                                            + ".mesh.fused")
        rounds = caps[tag]["rounds"]
        store = object.__new__(pkg_fused.DeviceVertexStore)
        store.__dict__.update(rounds[0][0].__dict__)
        store.ev = evs[side, tag]
        table0 = caps[tag]["table"]

        def run():
            store.table = table0.clone()
            for _, mvid, pb3, ps, kcap, n_cand, base in rounds:
                store.ext_base = base
                if side == "tree":
                    pkg_fused.merge_core(store, mvid, pb3, ps, kcap, n_cand)
                else:
                    pkg_fused.merge_core(store, mvid, pb3, ps, kcap)
        return run

    for tag in caps:
        fns = {}
        for side in sides:
            fns[f"leaf core | {side}"] = leaf_fn(side, tag)
            fns[f"collapse rounds | {side}"] = rounds_fn(side, tag)
        for label, fn in fns.items():
            busy = cs._device_busy(fn, 3)
            if busy is None:
                print(f"mesher | {tag} {label}: no device time recorded",
                      flush=True)
                continue
            ms, wall, ops, top = busy
            print(f"mesher | {tag} {label}: device {ms:.4f} ms a call, "
                  f"{ops:.1f} device ops a call, wall {wall:.3f} ms under "
                  f"the profiler; heaviest "
                  + ", ".join(f"{k} {t:.4f} ms x{c:.1f}" for k, t, c in top),
                  flush=True)
        times = _by_turns(cs, fns, opts.rounds_unrolled, reps=3)
        for label, v in times.items():
            print(f"mesher | {tag} {label} by turns: median "
                  f"{np.median(v):.4f} ms, min {min(v):.4f} ms over "
                  f"{len(v)} rounds (CUDA events, 3 calls each)", flush=True)
    # the tree's table after each scene's leaf core and rounds
    for tag in caps:
        t = caps[tag]["table"]
        print(f"mesher | {tag}: the table after the leaf core holds "
              f"{int(t.count[1])} keys in {t.slots.numel()} slots",
              flush=True)


def _linked_regs(k, symbol):
    """The registers of `symbol` in k's linked library, its callees
    included (cuobjdump -res-usage)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-res-usage", str(k.unit().lib)],
                         capture_output=True, text=True).stdout
    lines = out.splitlines()
    for i, line in enumerate(lines[:-1]):
        if symbol in line:
            return lines[i + 1].strip()
    return "not found"


def _by_turns(cs, fns, rounds, reps=5):
    """CUDA-event ms of each of `fns` (label -> fn) over `rounds` rounds
    by turns, the order reversed every other round: {label: [ms]}."""
    times = {label: [] for label in fns}
    order = list(fns)
    for rnd in range(rounds):
        for label in (order if rnd % 2 == 0 else order[::-1]):
            times[label].append(cs.time_cuda(fns[label], reps))
    return times


def _print_turns(tag, times, unit="ms"):
    for label, v in times.items():
        print(f"compiled3d | {tag} by turns | {label}: median "
              f"{np.median(v):.4f} {unit}, min {min(v):.4f} over {len(v)} "
              f"rounds", flush=True)


def compiled3d_probe(cs, port, others, opts):
    """`--compiled3d` (see the module doc); `others` maps each checkout's
    name to its package (the parent: per-stratum U2-3D launches and
    U1-3D candidates with the fold in torch ops)."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    sides = {"tree": port, **others}
    view = cs.VIEWS3[1][1]
    frames, kernels, rends = {}, {}, {}
    for side, pkg in sides.items():
        scenes = importlib.import_module(pkg.__name__ + ".scenes")
        ctx = pkg.Context()
        union = pkg.lower(ctx, [scenes.sphere_union_shape(ctx)])
        big = pkg.VoxelSize(cs.SIZE3, cs.SIZE3, cs.SIZE3)
        g = dict(tile_size=64, sub_size=16)
        rs = {
            "gyroid bucketed": pkg.VoxelRenderer(
                scenes.gyroid_sphere(pkg), big, specialize=False, **g),
            "gyroid per-shape": pkg.VoxelRenderer(scenes.gyroid_sphere(pkg),
                                                  big, **g),
            "gyroid unrolled leaf": pkg.VoxelRenderer(
                scenes.gyroid_sphere(pkg), big, leaf="unrolled", **g),
            "gyroid leaf+proofs": pkg.VoxelRenderer(
                scenes.gyroid_sphere(pkg), big, leaf="unrolled",
                proofs="unrolled", **g),
            "union compiled": pkg.VoxelRenderer(
                union, pkg.VoxelSize(128, 128, 128), tile_size=32,
                sub_size=16, leaf="unrolled", proofs="unrolled"),
        }
        puc = importlib.import_module(pkg.__name__ + ".eval.unrolled_cuda")
        ks = [k for r in rs.values() for k in r._generated_kernels()]
        t0 = time.perf_counter()
        puc.build_kernels(ks)
        print(f"compiled3d | {side}: {len(ks)} generated kernels built in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for label, r in rs.items():
            v = None if label.startswith("union") else view
            r.render(v)
            r.render(v)  # settled, with its strata schedule
            frames[side, label] = (lambda r=r, v=v: r.render(v))
        rends[side] = rs
        kernels[side] = ks
    torch.cuda.synchronize()

    # one frame's U1-3D and U2-3D calls on each side
    calls = {}
    for side, pkg in sides.items():
        r3d = importlib.import_module(pkg.__name__ + ".render.render3d")
        new = hasattr(r3d, "unrolled_voxel_fold")
        names = (("unrolled_proofs3", "unrolled_voxel_fold") if new
                 else ("unrolled_interval3", "unrolled_voxel_depth"))
        for label in ("gyroid leaf+proofs", "union compiled"):
            rec = {n: [] for n in (*names, "stratum_fold")}
            saved = {n: getattr(r3d, n) for n in names}
            saved_fold = getattr(r3d._Pipeline3, "stratum_fold", None)

            def wrap(n):
                def call(*a, **kw):
                    if n == "unrolled_voxel_fold":
                        rec[n].append(((*a[:5], a[5].clone()), kw))
                    else:
                        rec[n].append((a, kw))
                    return saved[n](*a, **kw)
                return call

            def fold(self, floor, dcand, idx, **kw):
                rec["stratum_fold"].append((self, floor.clone(), idx, kw))
                return saved_fold(self, floor, dcand, idx, **kw)

            for n in names:
                setattr(r3d, n, wrap(n))
            if not new:
                r3d._Pipeline3.stratum_fold = fold
            try:
                frames[side, label]()
            finally:
                for n, f in saved.items():
                    setattr(r3d, n, f)
                if not new:
                    r3d._Pipeline3.stratum_fold = saved_fold
            torch.cuda.synchronize()
            calls[side, label] = (new, rec)
            print(f"compiled3d | {side} {label}: "
                  + ", ".join(f"{n} x{len(v)}" for n, v in rec.items()),
                  flush=True)

    def work(side, label, which):
        """The U2-3D (`which` "proofs") or U1-3D ("leaf") work of one
        frame on `side`, as its glue launches it."""
        puc = importlib.import_module(sides[side].__name__
                                      + ".eval.unrolled_cuda")
        new, rec = calls[side, label]
        if which == "proofs":
            n = "unrolled_proofs3" if new else "unrolled_interval3"
            fn = getattr(puc, n)
            return lambda: [fn(*a, **kw) for a, kw in rec[n]]
        if new:
            return lambda: [puc.unrolled_voxel_fold(*a, **kw)
                            for a, kw in rec["unrolled_voxel_fold"]]
        pairs = list(zip(rec["unrolled_voxel_depth"], rec["stratum_fold"]))
        return lambda: [
            geo.stratum_fold(floor, puc.unrolled_voxel_depth(*a, **kw), idx,
                             **fkw)
            for (a, kw), (geo, floor, idx, fkw) in pairs]

    names = ["fidget_unrolled_voxel_depth", "fidget_unrolled_interval"]
    for label in ("gyroid leaf+proofs", "union compiled"):
        for which in ("proofs", "leaf"):
            fns = {side: work(side, label, which) for side in sides}
            for side, fn in fns.items():
                split = _device_split(fn, names)
                print(f"compiled3d | {label} {which} | {side}: device ms a "
                      f"frame's work: " + (", ".join(
                          f"{k} {v:.4f}" for k, v in split.items())
                          if split else "not recorded"), flush=True)
            _print_turns(f"{label} {which}", _by_turns(
                cs, fns, opts.rounds_unrolled))

    # the layouts of U2-3D and the groups of U1-3D on the tree's inputs
    ctx = port.Context()
    from fidget_tpu_torch.scenes import standin_shape

    standin = port.lower(ctx, [standin_shape(ctx)])
    kinds = {v.kind: i for v, i in standin.var_map.items()}
    variants = {}
    for label in ("gyroid leaf+proofs", "union compiled"):
        r = rends["tree"][label]
        for k in uc.PROOFS3_WARPS:
            variants[label, k] = uc.Interval3Kernel(r.tape, r.axis_of,
                                                    r.n_inputs, warps=k)
    for k in uc.PROOFS3_WARPS:
        variants["stand-in", k] = uc.Interval3Kernel(standin, kinds,
                                                     len(kinds), warps=k)
    t0 = time.perf_counter()
    steps = uc.build_kernels(list(variants.values()))
    print(f"compiled3d | U2-3D layouts: {len(steps)} nvcc steps in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for key, k in variants.items():
        spill = cs._ptxas_lines(k.unit())[1]
        print(f"compiled3d | U2-3D {key[0]} k={key[1]} (schedule k "
              f"{k.schedule().k}, {k.schedule().n_stages} stages, "
              f"{k.schedule().n_slots} slots): spill bytes {spill}; linked "
              f"{_linked_regs(k, 'fidget_unrolled_interval')}", flush=True)
    for label in ("gyroid leaf+proofs", "union compiled"):
        r = rends["tree"][label]
        print(f"compiled3d | U1-3D {label}: spill bytes "
              f"{cs._ptxas_lines(r._voxel_kernel.unit())[1]}; linked "
              f"{_linked_regs(r._voxel_kernel, 'fidget_unrolled_voxel_depth')}",
              flush=True)
        _, rec = calls["tree", label]
        (a, kw), = rec["unrolled_proofs3"]
        want = uc.unrolled_proofs3(*a, **kw)
        fns = {}
        for k in uc.PROOFS3_WARPS:
            kk = variants[label, k]
            got = uc.unrolled_proofs3(kk, *a[1:], **kw)
            same = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
            fn = (lambda kk=kk: uc.unrolled_proofs3(kk, *a[1:], **kw))
            dms = cs.device_ms(fn, "fidget_unrolled_interval")
            print(f"compiled3d | U2-3D {label} k={k}: "
                  f"{'equal' if same else 'DIFFERS'}; device {dms} ms",
                  flush=True)
            fns[f"k={k}"] = fn
        _print_turns(f"U2-3D layouts {label}", _by_turns(
            cs, fns, opts.rounds_unrolled, reps=20))
        folds = rec["unrolled_voxel_fold"]
        sub = folds[0][1]["sub"]
        want = [uc.unrolled_voxel_fold(*f[:5], f[5].clone(), **kw)
                for f, kw in folds]
        fns = {}
        for G in uc.VOXEL_GROUPS:
            if G > sub:
                continue
            got = [uc.unrolled_voxel_fold(*f[:5], f[5].clone(),
                                          **{**kw, "group": G})
                   for f, kw in folds]
            same = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
            fn = (lambda G=G: [uc.unrolled_voxel_fold(*f, **{**kw, "group": G})
                               for f, kw in folds])
            dms = cs.device_ms(fn, "fidget_unrolled_voxel_depth", reps=5)
            caps = [f[1].shape[0] for f, _ in folds]
            print(f"compiled3d | U1-3D {label} group {G} (rule: "
                  f"{[uc.voxel_group(c, sub) for c in caps]} over caps "
                  f"{caps}): {'equal' if same else 'DIFFERS'}; device "
                  f"{dms} ms a launch", flush=True)
            fns[f"G={G}"] = fn
        _print_turns(f"U1-3D groups {label} (a frame's strata)", _by_turns(
            cs, fns, opts.rounds_unrolled))

    # whole frames by turns
    labels = list(rends["tree"])
    for label in labels:
        if len(sides) > 1:
            imgs = {side: frames[side, label]() for side in sides}
            ref = imgs["tree"]
            for side, img in imgs.items():
                same = torch.equal(img.depth, ref.depth) and (
                    img.normal is None or torch.equal(img.normal, ref.normal))
                print(f"compiled3d | frame {label} | {side}: "
                      f"{'equal to the tree' if same else 'DIFFERS'}",
                      flush=True)
    wall = {(side, label): [] for side in sides for label in labels}
    order = [(side, label) for label in labels for side in sides]
    for rnd in range(opts.rounds_unrolled):
        for key in (order if rnd % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            frames[key]()
            torch.cuda.synchronize()
            wall[key].append((time.perf_counter() - t0) * 1e3)
    for (side, label), v in wall.items():
        busy = cs._device_busy(frames[side, label], 3)
        extra = ("busy not recorded" if busy is None else
                 f"busy {busy[0]:.3f} ms ({100 * busy[0] / np.median(v):.1f}%"
                 f" of the median), {busy[2]:.0f} device ops a frame")
        print(f"compiled3d | frame by turns | {label} | {side}: median "
              f"{np.median(v):.3f} ms, min {min(v):.3f} over {len(v)} "
              f"(host clock, synchronized); {extra}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=pathlib.Path, default=ROOT / "probe_out")
    ap.add_argument("--frames-against", type=pathlib.Path, default=None)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--unrolled-builds", action="store_true")
    ap.add_argument("--unrolled", action="store_true")
    ap.add_argument("--guard", action="store_true")
    ap.add_argument("--interleave", action="store_true")
    ap.add_argument("--rounds-unrolled", type=int, default=5)
    ap.add_argument("--mesher", action="store_true")
    ap.add_argument("--compiled3d", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import fidget_tpu_torch as port
    from fidget_tpu_torch.eval import cuda
    from fidget_tpu_torch.render import render2d

    print(cs.phase_device(), flush=True)
    for tool in ("ncu", "nsys", "cuobjdump", "nvdisasm"):
        print(f"{tool}: {shutil.which(tool) or 'not on PATH'}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print("SM clock now / max:", smi.stdout.strip(), flush=True)
    if opts.unrolled_builds:
        unrolled_builds(cs, port, opts.out)
        return 0
    if opts.interleave:
        interleave_probe(cs, port, cuda, opts)
        return 0
    if opts.compiled3d:
        others = {}
        for spec in opts.variant:
            vname, _, vdir = spec.partition("=")
            others[vname] = load_package(ROOT / vdir,
                                         "fidget_tpu_torch_" + vname)
        cuda.build()
        compiled3d_probe(cs, port, others, opts)
        return 0
    if opts.mesher:
        others = {}
        for spec in opts.variant:
            vname, _, vdir = spec.partition("=")
            others[vname] = load_package(ROOT / vdir,
                                         "fidget_tpu_torch_" + vname)
        cuda.build()
        mesher_probe(cs, port, others, opts)
        return 0
    if opts.unrolled:
        others = {}
        for spec in opts.variant:
            vname, _, vdir = spec.partition("=")
            others[vname] = load_package(ROOT / vdir,
                                         "fidget_tpu_torch_" + vname)
        cuda.build()
        unrolled_probe(cs, port, others, opts)
        return 0
    if opts.frames_against is not None:
        other = load_package(opts.frames_against, "fidget_tpu_torch_other")
        frames_in_turns(cs, {"tree": port, "other": other}, opts.rounds)
        return 0

    from fidget_tpu_torch.eval import simplify_device
    from fidget_tpu_torch.render import render3d

    tree = cuda.CSRC
    calls = capture_inputs(port, cs, render2d, render3d, simplify_device)
    for label, (name, args, kwargs) in calls.items():
        lens = args[{"liveness_codes": 2, "interp_float2": 6}.get(name, 3)]
        planes = {"liveness_codes": 3, "interp_float_coded": 5,
                  "interp_float2": 7}.get(name, 4)
        print(f"{label}: arena {tuple(args[0].shape)}, planes "
              f"{tuple(args[planes].shape)}, {int(lens.clamp(min=0).sum())} "
              f"rows, { {k: v for k, v in kwargs.items() if k != 'op_order'} }"
              f"{', op_order' if kwargs.get('op_order') else ''}", flush=True)
    builds = [("tree", port, tree)]
    for spec in opts.variant:
        vname, _, vdir = spec.partition("=")
        vdir = ROOT / vdir
        if (vdir / "fidget_tpu_torch").is_dir():
            pkg = load_package(vdir, "fidget_tpu_torch_" + vname)
            builds.append((vname, pkg, None))
        else:
            builds.append((vname, port, vdir))
    builds.append(("tree again", port, tree))
    reference = {}
    for bname, pkg, csrc in builds:
        bcuda = importlib.import_module(pkg.__name__ + ".eval.cuda")
        if csrc is not None:
            use_sources(bcuda, csrc)
        dump(bcuda, bname.replace(" ", "_"), opts.out)
        for label, (name, args, kwargs) in calls.items():
            mod, wrapper = WRAPPERS[name]
            try:
                fn = getattr(importlib.import_module(f"{pkg.__name__}.{mod}"),
                             wrapper)
            except ModuleNotFoundError:  # a checkout from before the probe
                print(f"{bname:>14} | {label:<34} not in this checkout")
                continue
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
                  f"{'equal to tree' if same else 'DIFFERS from tree'}"
                  f"{device_note(cs, fn, name, args, kwargs, label)}",
                  flush=True)
    lanes_a_thread(cs, cuda, calls, opts.reps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print("SM clock / power after:", smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
