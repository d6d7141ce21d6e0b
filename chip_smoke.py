#!/usr/bin/env python3
"""Bring-up check of fidget_tpu_torch on one CUDA card.

Builds the six CUDA kernels of the port from the sources in
fidget_tpu_torch/csrc, holds each against its plain PyTorch version on
the card, and drives the port's main paths: the 2D frame
(`PixelRenderer.render()` at 1024^2 on a 7,203-op procedural shape)
under each of its tape bindings (bucketed, coded leaf, per-shape
arena, two tile levels) and the 3D heightmap + normals renderer
(`VoxelRenderer.render()` at 512^3 on the 28-op gyroid sphere, and at
128^3 on a 3,303-op union of 300 spheres), holding every frame against
the numpy oracles; then the shape-parameter gradient of the 2D frame
and the mesher (`build_mesh` at depth 8 on the sphere union and the
gyroid sphere), on `BulkEvaluator`. Run from the root of the
repository:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device: the card's name and power limit (nvidia-smi);
2. build: one nvcc per kernel source, all started together;
3. op matrix: every unary and binary op over special values (NaN,
   +-inf, +-0, pi multiples, halves, integers past 2^23) in float mode
   through interp_float (K3), interval mode through interp_interval
   (K1) and grad mode through interp_grad (K4), then the liveness pass
   (K2) over the captured choices, each against its plain version;
   float and interval at rtol = atol = 2e-5 (2e-4 for EXP and LN;
   bit-equal for the ops IEEE rounds correctly), grad values the same
   and derivatives at 1e-4, choices and codes exact; once with the
   shared-memory register files and once with register files too large
   for them (nf 512, global scratch); interp_float_coded (K6) over the same
   tapes with seeded action codes that mix all four values, against
   its plain version, on both register-file routes; and K1, K2, K3 once
   more on each tape packed under its own `frequency_op_order`, against
   the plain versions with the same order and bit-equal to their own
   canonical results (K4 too); then hand-packed tapes built to break the tape
   staging (`scenes.adversarial_arena`: lengths 0, 1, chunk - 1, chunk,
   chunk + 1, 3 chunks + 5 and a length past L; a chain in which every
   row reads the row before it and one in which none does; both
   operands immediate; two OUTPUT rows; a register past nf) through K3
   and K1 on both register-file routes, at S0 = 8, 2 and 1 (4, 2 and 1
   lanes a thread in K3), with choices that fold into the last word and
   with choice words too many for shared memory; through K4 at 2 and 1
   lanes a thread and through its global scratch, and K5 at sub 16 and
   32 (4 and 32 blocks a subtile), at one lane a thread and through its
   global scratch; through K2 (with
   opcodes 31, 40 and 127 and raw-field elisions that clamping would
   change) on its four routes (one or two mask words, the byte plane in
   shared or device memory) with choice words in shared and in device
   memory, per instance and as a shared tape; and through K6 as shared
   tapes under seeded and random codes (lengths 0, past L and cut inside
   a word) at 4, 2 and 1 lanes a thread and through the global scratch;
   all against the plain versions bit for bit;
4. 2D main path: a few frames through `PixelRenderer.render()` under
   different pans, with the launch counts set to 0 just before and
   read just after; each frame's occupancy must equal `render_brute`,
   distances allclose (rtol 1e-5, atol 1e-6) where evaluated, fills
   conservative;
5. one phase per 2D kernel on the inputs the main path gave it
   (L = 8192, CW = 128; S0 = 8 for K1/K2, 128 for K3; nf = 64 for K2 and
   the tape's 13 registers for K1 and K3): kernel against plain version,
   CUDA-event times, the bound (for K2 also the bound of its serial
   chain), and the launch geometry (lanes a thread, shared-memory bytes,
   register-file, liveness and choice-word routes);
6. per-stage times of warm 2D frames (CUDA events, profiler);
6a. coded frames: the same views through `_frame(..., leaf_coded=True)`,
   launch counts set to 0 before and read after (K1, K2, K6 and no K3);
   each frame held to `render_brute` as in phase 4 and bit-equal to the
   standard frame where evaluated; then K6 on the inputs the coded
   frame gave it (the tape's 13 registers: kernel against plain, equal
   to K6 at the bucket's nf 64 and through the global scratch, their
   CUDA-event times, bound) and the stages of a warm coded frame;
6b. per-shape frames: `PixelRenderer(specialize=True)` and two-level
   `tile_sizes=(128, 32)` over the same views, each held to
   `render_brute`; the specialized frame equal to the bucketed one;
   level tags on the zoomed-out view; K1, K2 and K3 on the inputs each
   of the two paths gave them (per-shape arena under its op_order; at
   the second level K1 over the per-tile arenas, K2 per instance, K3
   over the 32-px leaves): kernel against plain version with the same
   order, CUDA-event time and bound; stages of a warm frame of each;
   then warm frames of all four bindings timed in turns;
7. 3D main path: the gyroid sphere at 512^3 (tile 64, subtile 16)
   under three views in normals mode and one heightmap frame, then the
   sphere union at 128^3 (tile 32, subtile 16), launch counts set to 0
   before and read after each; depth equal to `render_brute` (the
   union's exactly; a gyroid column may differ only at a voxel whose
   float64 distance is within f32 rounding of 0, see `check_depth`),
   normals allclose (rtol = atol = 1e-4) to the numpy GradMode oracle
   `brute_normals` where depth > 0, [0, 0, 1] where saturated; ten
   warm union frames timed;
8. one phase per 3D kernel shape on the inputs the 3D path gave it:
   K4 and K5 against their plain versions (K5 exact) at the tape's
   registers, as the path launches them, with CUDA-event and profiler
   device times; again at the bucket's nf 64, at one lane a thread and
   through their global scratch, equal to the path's results; under the
   gyroid's `frequency_op_order` (the captured arenas renumbered),
   against the plain versions and bit-equal to the canonical results;
   K5 at sub 32 on a few subtiles of the gyroid; K1 and K2 at their 3D
   shapes; times and bounds over the real lanes and live instances
   only;
9. per-stage times of a warm 512^3 normals frame;
10. gradient: the parametrized 7,207-op stand-in (`param_standin_shape`,
   two shape Vars, V = 4) at 1024^2, bucketed, pixel_perfect; loss
   sum(img^2) / N^2 reversed through `_frame` with backward() (K3
   primal, two K4 passes for the Jacobian), held to `torch.func.jacfwd`
   (rtol 1e-5, atol 1e-6) and to central differences (h = 1e-2; rtol
   2e-2, atol 1e-3); without pixel_perfect, on the zoomed-out view,
   proven fills have a zero or NaN tangent (`torch.func.jvp`); forward
   and step times, the step's launches and device busy time, and K3 and
   K4 on the step's inputs against their plain versions;
11. mesh: `build_mesh` at depth 8, collapse on, on the sphere union and
   the gyroid sphere (world [-1, 1]^3 viewing model [-1.1, 1.1]^3),
   launch counts set to 0 before and read after; each mesh a closed
   2-manifold but at ambiguous-face pinches, wound outward (positive
   volume, 99% of the area with normals along the gradient), every
   vertex inside its cell and within its cell's diagonal of the surface
   (|f| / |grad f| by `BulkEvaluator`); a depth-5 sphere built on the
   card equal to the CPU's build; warm builds timed by stage
   (`_StageClock`) with the device's busy time; and K1, K3 and K4 on the
   inputs the depth-8 builds gave them, bit-equal to their plain
   versions on the first instances (NaN where plain is NaN), with time,
   bound and the cost of copying the tape over the instances.

The last two lines of standard output are the `kernels` JSON line and
the device JSON line.
"""

from __future__ import annotations

import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

#: peak rates of one H100 SXM at its 700 W limit (NVIDIA data sheet):
#: HBM bytes/s, and float32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: warp schedulers of the card (132 SMs x 4) and the instructions a tape
#: row cannot do without per value plane: two operand loads, the op, the
#: store. With the SM clock they give the scheduler-slot bound of a kernel.
SCHEDULERS = 132 * 4
ROW_INSTRUCTIONS = 4
#: the liveness pass's serial chain: per row the dependent integer
#: instructions it cannot do without (AND the destination's bit, test,
#: update the mask) at the dependent-issue latency of one, in SM cycles
CHAIN_INSTRUCTIONS = 3
CHAIN_LATENCY = 4
#: SM clock in Hz, read from nvidia-smi by `phase_device`
SM_CLOCK_HZ = None

SIZE = 1024
#: world_to_model views of the main path's frames: identity, a small
#: pan, and a pan zoomed out far enough that the outer tiles are proven
#: empty (so the fill path runs on the card too)
FRAMES = [
    None,
    np.array([[1.0, 0.0, 0.013], [0.0, 1.0, -0.021], [0.0, 0.0, 1.0]]),
    np.array([[2.0, 0.0, -0.05], [0.0, 2.0, 0.07], [0.0, 0.0, 1.0]]),
]

SPICY = np.array(
    [
        0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 100.0, -100.0,
        math.pi, -math.pi, math.pi / 2, -math.pi / 2, 2 * math.pi,
        0.1, -0.1, 1e6, -1e6, math.nan, math.inf, -math.inf,
        8388609.0, -8388609.0, 2.5, -2.5, 0.49999997,
    ],
    dtype=np.float32,
)

KERNEL_INFO = {
    "interp_interval": (
        "fidget_tpu_torch/csrc/interp_interval.cu",
        "fidget_tpu/eval/pallas_interp.py:615",
    ),
    "liveness_codes": (
        "fidget_tpu_torch/csrc/liveness.cu",
        "fidget_tpu/eval/simplify_device.py:78",
    ),
    "interp_float": (
        "fidget_tpu_torch/csrc/interp_float.cu",
        "fidget_tpu/eval/pallas_interp.py:179",
    ),
    "interp_grad": (
        "fidget_tpu_torch/csrc/interp_grad.cu",
        "fidget_tpu/eval/pallas_interp.py:820",
    ),
    "interp_voxel_depth": (
        "fidget_tpu_torch/csrc/interp_voxel_depth.cu",
        "fidget_tpu/eval/pallas_interp.py:337",
    ),
    "interp_float_coded": (
        "fidget_tpu_torch/csrc/interp_float_coded.cu",
        "fidget_tpu/eval/pallas_interp.py:518",
    ),
}

#: kernels of each main path
KERNELS_2D = ("interp_interval", "liveness_codes", "interp_float")
KERNELS_2D_CODED = ("interp_interval", "liveness_codes", "interp_float_coded")
KERNELS_3D = ("interp_interval", "liveness_codes", "interp_grad",
              "interp_voxel_depth")

SIZE3 = 512


def _rot(axis, a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4)
    i, j = {"x": (1, 2), "y": (2, 0)}[axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _perspective():
    m = np.eye(4)
    m[3, 2] = 0.3
    return m


#: views of the 3D main path: identity, a rotation (0.4 rad about y,
#: then 0.3 rad about x), and a perspective camera
VIEWS3 = [("identity", None),
          ("rotated", _rot("x", 0.3) @ _rot("y", 0.4)),
          ("perspective", _perspective())]


class Failed(Exception):
    pass


def log(*args):
    print(*args, flush=True)


def compare(got, want, rtol, atol):
    """NaN-aware elementwise comparison: both NaN, exactly equal
    (equal infinities included) or finite and within tolerance.
    Returns (number of mismatches, max abs error over finite pairs)."""
    got = got.detach().double()
    want = want.detach().double()
    both_nan = torch.isnan(got) & torch.isnan(want)
    finite = torch.isfinite(got) & torch.isfinite(want)
    diff = torch.where(finite, (got - want).abs(), torch.zeros_like(got))
    close = finite & (diff <= atol + rtol * want.abs())
    ok = both_nan | (got == want) | close
    return int((~ok).sum()), float(diff.max()) if diff.numel() else 0.0


def check(name, got, want, rtol, atol):
    bad, err = compare(got, want, rtol, atol)
    if bad:
        raise Failed(f"{name}: {bad} elements differ (max abs err {err})")
    return err


def time_cuda(fn, reps):
    """Mean ms per call of fn over reps calls, by CUDA events, after
    one warm call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise Failed(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    global SM_CLOCK_HZ
    SM_CLOCK_HZ = float(clock.stdout.strip().splitlines()[0]) * 1e6
    log(f"SM clock (nvidia-smi clocks.max.sm): {SM_CLOCK_HZ / 1e6:.0f} MHz")
    return smi.stdout.strip().splitlines()[0]


def phase_build(cuda):
    t0 = time.time()
    out = cuda.build()
    log(f"build: {time.time() - t0:.1f} s into {out.relative_to(ROOT)}")
    for stem in sorted({s for s, _ in cuda.KERNELS.values()}):
        for line in (out / f"{stem}.log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {stem}: {line.strip()}")


def _matrix_tapes(port):
    from fidget_tpu_torch.core.ops import BinaryOp, UnaryOp

    cases = []
    for op in UnaryOp:
        ctx = port.Context()
        cases.append((op.name, port.lower(ctx, [ctx.op_unary(op, ctx.x())])))
    for op in BinaryOp:
        for variant, imm in (
            ("reg_reg", None), ("reg_imm", 0.5), ("reg_imm", -2.0),
            ("imm_reg", 0.5), ("imm_reg", -2.0),
        ):
            ctx = port.Context()
            x, y = ctx.x(), ctx.y()
            if variant == "reg_reg":
                node = ctx.op_binary(op, x, y)
            elif variant == "reg_imm":
                node = ctx.op_binary(op, x, ctx.constant(imm))
            else:
                node = ctx.op_binary(op, ctx.constant(imm), y)
            if ctx.get_const(node) is not None or ctx.tag(node) != 3:
                continue
            cases.append((op.name, port.lower(ctx, [node])))
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    f = ctx.min(
        ctx.add(ctx.sin(x), ctx.cos(y)),
        ctx.sub(ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y))), 1.0),
    )
    cases.append(("spill", port.lower(ctx, [f], reg_limit=2)))
    return cases


#: ops that IEEE f32 rounds correctly on both sides (compiled with
#: --fmad=false): kernel and plain version must agree bit for bit
EXACT_OPS = {
    "NEG", "ABS", "SQUARE", "SQRT", "RECIP", "FLOOR", "CEIL", "ROUND",
    "NOT", "ADD", "SUB", "MUL", "DIV", "MIN", "MAX", "AND", "OR", "MOD",
    "COMPARE",
}


def _matrix_tolerance(name):
    if name in EXACT_OPS:
        return 0.0
    return 2e-4 if name in ("EXP", "LN") else 2e-5


def phase_op_matrix(port, dev):
    from fidget_tpu_torch.compiler.pack import pack_tapes
    from fidget_tpu_torch.eval import interp, simplify_device

    cases = _matrix_tapes(port)
    packed = pack_tapes([t for _, t in cases], capacity=32)
    arena = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (packed.w1, packed.w2, packed.imm, packed.lengths)]
    s0 = 8
    ns = len(SPICY)
    lanes = s0 * 128
    pad = lambda a: np.pad(a, (0, lanes - a.size)).reshape(s0, 128)
    a_pts = np.repeat(SPICY, ns)
    b_pts = np.tile(SPICY, ns)
    T = len(cases)
    pts = np.zeros((T, 2, s0, 128), np.float32)
    lo, hi = np.zeros_like(pts), np.zeros_like(pts)
    for t_i, (_, tape) in enumerate(cases):
        for v, i in tape.var_map.items():
            is_x = v.kind == "x"
            pts[t_i, i] = pad(a_pts if is_x else b_pts)
            lo[t_i, i] = pad(np.minimum(a_pts, b_pts) if is_x else b_pts)
            hi[t_i, i] = pad(np.maximum(a_pts, b_pts) if is_x else b_pts)
    pts, lo, hi = (torch.from_numpy(a).to(dev) for a in (pts, lo, hi))
    tol = torch.tensor(
        [_matrix_tolerance(name) for name, _ in cases], device=dev
    )[:, None, None, None]
    # grad values at the matrix's tolerance of the transcendentals
    grad_tol = torch.tensor(
        [2e-4 if name in ("EXP", "LN") else 2e-5 for name, _ in cases],
        device=dev,
    )[:, None, None, None]
    errs = {}
    # shared-memory register files, then global scratch for every kernel
    # (K4's four files of one lane a thread leave shared memory above
    # nf = 106; K3's single file above nf = 428)
    from fidget_tpu_torch.eval import cuda

    duals = torch.zeros((T, 2, 4, s0, 128), device=dev)
    duals[:, :, 0] = pts
    for t_i, (_, tape) in enumerate(cases):
        for v, i in tape.var_map.items():
            duals[t_i, i, 1 if v.kind == "x" else 2] = 1.0
    for nf in (packed.nf, 512):
        for kernel in ("interp_float", "interp_interval", "interp_grad"):
            g = cuda.launch_geometry(kernel, nf=nf, lanes=lanes, T=T, cw=1)
            if g.regs_shared != (nf == packed.nf):
                raise Failed(f"op matrix: {kernel} at nf {nf} took {g}")
        kw = dict(nf=nf, n_inputs=2, n_outputs=1, s0=s0)
        got = interp.interp_float(*arena, pts, **kw)
        want = interp.interp_float_plain(*arena, pts, **kw)
        errs["float", nf] = check(
            f"op matrix float (nf={nf})", got, want, tol, tol
        )
        got = interp.interp_interval(*arena, lo, hi, c_words=1, **kw)
        want = interp.interp_interval_plain(*arena, lo, hi, c_words=1, **kw)
        for k, part in enumerate(("lo", "hi")):
            errs[part, nf] = check(
                f"op matrix interval {part} (nf={nf})", got[k], want[k],
                tol, tol,
            )
        if not torch.equal(got[2], want[2]):
            raise Failed(f"op matrix interval choices differ (nf={nf})")
        w1, w2, _, lens = arena
        L = w1.shape[1]
        codes = simplify_device.liveness_codes(
            w1, w2, lens, want[2], nf=nf, L=L, shared_tape=False
        )
        codes_plain = simplify_device.liveness_codes_plain(
            w1, w2, lens, want[2], nf=nf, L=L, shared_tape=False
        )
        if not torch.equal(codes, codes_plain):
            raise Failed(f"op matrix liveness codes differ (nf={nf})")
        # grad mode: x seeded d/dx, y seeded d/dy
        got = interp.interp_grad(*arena, duals, **kw)
        want = interp.interp_grad_plain(*arena, duals, **kw)
        errs["grad", nf] = check(
            f"op matrix grad value (nf={nf})", got[:, :, 0], want[:, :, 0],
            grad_tol, grad_tol,
        )
        errs["d/dxyz", nf] = check(
            f"op matrix grad derivatives (nf={nf})", got[:, :, 1:],
            want[:, :, 1:], 1e-4, 1e-4,
        )
    torch.cuda.synchronize()
    log(f"op matrix: {T} tapes x {ns * ns} value pairs agree in float, "
        f"interval and grad mode, choices and codes exact; max abs err "
        + ", ".join(f"{k[0]}@nf{k[1]}={v:.3g}" for k, v in errs.items()))
    _op_matrix_coded(cases, packed, arena, pts, dev)
    _op_matrix_op_order(cases, packed, arena, pts, lo, hi, duals, dev)
    phase_adversarial(dev)


def phase_adversarial(dev):
    """K3 and K1 on the hand-packed tapes of `scenes.adversarial_arena`
    against their plain versions, bit for bit: at S0 = 8, 2 and 1 (so K3
    runs 4, 2 and 1 lanes a thread), with the register file in shared
    memory and (nf 512) in the global scratch, with 2 choice words (272
    choices fold into the last), and with 512 (too many for shared
    memory: OR-reduced into device memory); then K2 and K6."""
    from fidget_tpu_torch.eval import cuda, interp
    from fidget_tpu_torch.scenes import adversarial_arena

    A = adversarial_arena(cuda.TAPE_CHUNK)
    arena = [torch.from_numpy(A[k]).to(dev)
             for k in ("w1", "w2", "imm", "lengths")]
    T = len(A["names"])
    if A["n_choices"] <= 32:
        raise Failed("adversarial tapes: too few choices to fold")
    rng = np.random.default_rng(5)
    seen = set()
    for s0, nf, cw in ((8, A["nf"], 2), (2, A["nf"], 2), (1, A["nf"], 2),
                       (8, 512, 2), (1, 512, 512), (8, A["nf"], 512)):
        lo = rng.uniform(-1.5, 1.5, size=(T, 2, s0, 128)).astype(np.float32)
        hi = lo + rng.uniform(0, 0.5, size=lo.shape).astype(np.float32)
        lo, hi = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
        kw = dict(nf=nf, n_inputs=A["n_inputs"], n_outputs=A["n_outputs"],
                  s0=s0)
        gf = cuda.launch_geometry("interp_float", nf=nf, lanes=s0 * 128, T=T)
        gi = cuda.launch_geometry("interp_interval", nf=nf, lanes=s0 * 128,
                                  T=T, cw=cw)
        seen |= {("r", gf.r), ("float shared", gf.regs_shared),
                 ("interval shared", gi.regs_shared),
                 ("choices shared", gi.choices_shared)}
        got = interp.interp_float(*arena, lo, **kw)
        want = interp.interp_float_plain(*arena, lo, **kw)
        pairs = [("float", got, want)]
        got = interp.interp_interval(*arena, lo, hi, c_words=cw, **kw)
        want = interp.interp_interval_plain(*arena, lo, hi, c_words=cw, **kw)
        pairs += list(zip(("interval lo", "interval hi", "choices"), got, want))
        for what, g, w in pairs:
            same = g.view(torch.int32) == w.view(torch.int32)
            if not same.all():
                t_bad = sorted({A["names"][t] for t in
                                (~same).reshape(T, -1).any(1).nonzero()[:, 0]})
                raise Failed(f"adversarial tapes: {what} differs from plain at "
                             f"s0 {s0}, nf {nf}, cw {cw} on {t_bad}")
        if not (want[2] != 0).any() or (got[0][0] != 0).any():
            raise Failed("adversarial tapes: no choices, or a length-0 tape "
                         "wrote an output")
    want_seen = {("r", 4), ("r", 2), ("r", 1)} | {
        (k, v) for k in ("float shared", "interval shared", "choices shared")
        for v in (True, False)
    }
    if seen != want_seen:
        raise Failed(f"adversarial tapes: geometries covered only {seen}")
    torch.cuda.synchronize()
    log(f"adversarial tapes: {T} tapes ({', '.join(A['names'])}) through "
        f"interp_float and interp_interval equal their plain versions bit for "
        f"bit at 4, 2 and 1 lanes a thread, on the shared-memory and the "
        f"global-scratch register files, with choices folded into 2 words and "
        f"with 512 words OR-reduced into device memory")
    _adversarial_liveness(dev)
    _adversarial_coded(dev)
    _adversarial_3d(dev)


def _adversarial_liveness(dev):
    """K2 on `adversarial_arena(liveness=True)` with seeded choice words
    (all four codes), per instance and with the longest chain as the
    shared tape of three instances, on every route: nf 6 and 13 (one
    mask word), 64 (two), 512 (byte plane in shared memory) and 2048
    (in device memory), with 2 choice words in shared memory and 512 in
    device memory; bit for bit against the plain version."""
    from fidget_tpu_torch.eval import cuda, simplify_device
    from fidget_tpu_torch.scenes import adversarial_arena

    A = adversarial_arena(cuda.TAPE_CHUNK, liveness=True)
    w1, w2, lens = (torch.from_numpy(A[k]).to(dev)
                    for k in ("w1", "w2", "lengths"))
    T, L = w1.shape
    t = A["names"].index(f"chain{L}")
    rng = np.random.default_rng(6)
    seen = set()
    for nf, cw in ((6, 2), (13, 2), (64, 2), (6, 512), (512, 2), (512, 512),
                   (2048, 2)):
        g = cuda.launch_geometry("liveness_codes", nf=nf, lanes=128, T=T,
                                 cw=cw)
        seen |= {("mask words", g.mask_words), ("plane shared", g.regs_shared),
                 ("choices shared", g.choices_shared)}
        ch = torch.from_numpy(rng.integers(
            -2**31, 2**31, size=(T, cw, 1, 128)).astype(np.int32)).to(dev)
        for shared, args in ((False, (w1, w2, lens, ch)),
                             (True, (w1[t:t + 1], w2[t:t + 1], lens[t:t + 1],
                                     ch[:3]))):
            kw = dict(nf=nf, L=L, shared_tape=shared)
            got = simplify_device.liveness_codes(*args, **kw)
            want = simplify_device.liveness_codes_plain(*args, **kw)
            if not torch.equal(got, want):
                bad = (got != want).reshape(got.shape[0], -1).any(1)
                names = [A["names"][i] for i in bad.nonzero()[:, 0].tolist()]
                raise Failed(f"adversarial liveness codes differ from plain at "
                             f"nf {nf}, cw {cw}, shared tape {shared}: "
                             f"{names if not shared else 'chain'}")
    want_seen = {("mask words", k) for k in (0, 1, 2)} | {
        (k, v) for k in ("plane shared", "choices shared") for v in (True, False)
    }
    if seen != want_seen:
        raise Failed(f"adversarial liveness: routes covered only {seen}")
    torch.cuda.synchronize()
    log(f"adversarial liveness: {T} tapes ({', '.join(A['names'])}) through "
        f"liveness_codes equal its plain version bit for bit per instance and "
        f"as a shared tape, with liveness in one and two mask words and in the "
        f"byte plane in shared and in device memory, choice words in shared "
        f"and in device memory")


def _adversarial_coded(dev):
    """K6 with each adversarial tape as the shared tape of seven tiles:
    every row run; seeded codes that keep the dataflow, COPY from b on
    unary rows and from immediates included; random codes (a register
    nothing wrote reads 0); the seeded codes under a length past L; a
    culled tile; random codes beyond a length cut inside a word (masked);
    at S0 = 8, 2 and 1 (4, 2, 1 lanes a thread) and through the global
    scratch (nf 512); bit for bit against the plain version."""
    from fidget_tpu_torch.eval import cuda, interp
    from fidget_tpu_torch.scenes import (
        adversarial_arena, pack_action_codes, seeded_action_codes,
    )

    A = adversarial_arena(cuda.TAPE_CHUNK)
    L = A["w1"].shape[1]
    tiles = 7
    rng = np.random.default_rng(8)
    seen = set()
    for s0, nf in ((8, A["nf"]), (2, A["nf"]), (1, A["nf"]), (8, 512)):
        g = cuda.launch_geometry("interp_float_coded", nf=nf, lanes=s0 * 128,
                                 T=tiles)
        seen |= {("r", g.r), ("shared", g.regs_shared)}
        for t, name in enumerate(A["names"]):
            n = min(int(A["lengths"][t]), L)
            codes = np.zeros((tiles, L), np.uint32)
            codes[0, :n] = 1
            codes[1] = seeded_action_codes(A["w1"][t], A["w2"][t], n, A["nf"],
                                           rng, any_row=True)
            codes[2] = rng.integers(0, 4, size=L)
            codes[3] = codes[1]
            codes[5] = rng.integers(0, 4, size=L)
            codes[6] = rng.integers(0, 4, size=L)
            lengths = torch.tensor([n, n, n, L + 7, 0, max(n - 5, 0), n],
                                   dtype=torch.int32, device=dev)
            words = torch.from_numpy(pack_action_codes(codes)).to(dev)
            shared = [torch.from_numpy(np.ascontiguousarray(A[k][t:t + 1])).to(
                dev) for k in ("w1", "w2", "imm")]
            vars_ = torch.from_numpy(rng.uniform(
                -1.5, 1.5, size=(tiles, 2, s0, 128)).astype(np.float32)).to(dev)
            kw = dict(nf=nf, n_inputs=2, n_outputs=2, s0=s0)
            got = interp.interp_float_coded(*shared, lengths, words, vars_, **kw)
            want = interp.interp_float_coded_plain(
                *shared, lengths, words, vars_, **kw)
            same = got.view(torch.int32) == want.view(torch.int32)
            if not same.all():
                tb = (~same).reshape(tiles, -1).any(1).nonzero()[:, 0].tolist()
                raise Failed(f"adversarial coded leaf differs from plain on "
                             f"{name}, tiles {tb}, s0 {s0}, nf {nf}")
            if (got[4] != 0).any():
                raise Failed(f"adversarial coded leaf: culled tile wrote ({name})")
    if seen != {("r", 4), ("r", 2), ("r", 1), ("shared", True),
                ("shared", False)}:
        raise Failed(f"adversarial coded leaf: geometries covered only {seen}")
    torch.cuda.synchronize()
    log(f"adversarial coded leaf: {len(A['names'])} shared tapes x {tiles} "
        f"tiles (seeded and random codes, lengths 0, past L and cut inside a "
        f"word) through interp_float_coded equal its plain version bit for "
        f"bit at 4, 2 and 1 lanes a thread and through the global scratch")


def _adversarial_3d(dev):
    """K4 and K5 on the adversarial tapes against their plain versions,
    bit for bit (every op of these tapes rounds correctly in f32, duals
    too): K4 at S0 = 8 and 1 (2 and 1 lanes a thread) and through its
    global scratch (nf 256); K5 at sub 16 and 32, at one lane a thread
    (nf 256) and through its global scratch (nf 512), with a ramp over
    vz in the inputs so that the surface moves within a column."""
    from fidget_tpu_torch.eval import cuda, interp
    from fidget_tpu_torch.scenes import adversarial_arena

    A = adversarial_arena(cuda.TAPE_CHUNK)
    arena = [torch.from_numpy(A[k]).to(dev)
             for k in ("w1", "w2", "imm", "lengths")]
    T = len(A["names"])
    rng = np.random.default_rng(12)
    seen = set()

    def differs(what, got, want, **at):
        same = got.view(torch.int32) == want.view(torch.int32)
        if not same.all():
            bad = sorted({A["names"][t] for t in
                          (~same).reshape(T, -1).any(1).nonzero()[:, 0]})
            raise Failed(f"adversarial tapes: {what} differs from plain at "
                         f"{at} on {bad}")

    for s0, nf in ((8, A["nf"]), (1, A["nf"]), (8, 256)):
        g = cuda.launch_geometry("interp_grad", nf=nf, lanes=s0 * 128, T=T)
        seen |= {("grad r", g.r), ("grad shared", g.regs_shared)}
        duals = torch.from_numpy(rng.uniform(
            -1.5, 1.5, size=(T, 2, 4, s0, 128)).astype(np.float32)).to(dev)
        kw = dict(nf=nf, n_inputs=2, n_outputs=2, s0=s0)
        differs("interp_grad", interp.interp_grad(*arena, duals, **kw),
                interp.interp_grad_plain(*arena, duals, **kw), s0=s0, nf=nf)
    depths = set()
    for sub, nf in ((16, A["nf"]), (32, A["nf"]), (16, 256), (16, 512)):
        g = cuda.launch_geometry("interp_voxel_depth", nf=nf, lanes=sub**3,
                                 T=T, sub=sub)
        seen |= {("voxel r", g.r), ("voxel shared", g.regs_shared)}
        vz = np.arange(sub**3) // (sub * sub)
        x = rng.uniform(-1.5, 1.5, size=(T, 2, sub**3)) + (vz / sub * 3 - 1.5)
        pts = torch.from_numpy(
            x.astype(np.float32).reshape(T, 2, sub**3 // 128, 128)).to(dev)
        kw = dict(nf=nf, n_inputs=2, s0=sub**3 // 128, sub=sub)
        got = interp.interp_voxel_depth(*arena, pts, **kw)
        differs("interp_voxel_depth", got,
                interp.interp_voxel_depth_plain(*arena, pts, **kw), sub=sub,
                nf=nf)
        depths |= set(got.unique().tolist())
    want_seen = {("grad r", 2), ("grad r", 1), ("grad shared", True),
                 ("grad shared", False), ("voxel r", 4), ("voxel r", 1),
                 ("voxel shared", True), ("voxel shared", False)}
    if seen != want_seen or len(depths) < 8:
        raise Failed(f"adversarial 3D: covered only {seen}, depths {depths}")
    torch.cuda.synchronize()
    log(f"adversarial 3D: {T} tapes through interp_grad (2 and 1 lanes a "
        f"thread, global scratch) and interp_voxel_depth (sub 16 and 32, 4 "
        f"and 1 lanes a thread, global scratch; {len(depths)} distinct "
        f"depths) equal their plain versions bit for bit")


def _op_matrix_coded(cases, packed, arena, pts, dev):
    """K6 over every op-matrix tape as the shared tape of six tiles:
    tile 0 runs every row, tiles 1-4 carry seeded codes that rewrite
    rows to copies of either operand and skip what that leaves dead,
    tile 5 is culled; kernel against plain on both register routes."""
    from fidget_tpu_torch.eval import interp
    from fidget_tpu_torch.scenes import pack_action_codes, seeded_action_codes

    w1, w2, imm, _ = arena
    rng = np.random.default_rng(11)
    tiles, seen, worst = 6, set(), 0.0
    L = w1.shape[1]
    for t_i, (name, _) in enumerate(cases):
        n = int(packed.lengths[t_i])
        codes = np.zeros((tiles, L), np.uint32)
        codes[0, :n] = 1
        for k in range(1, 5):
            codes[k] = seeded_action_codes(
                packed.w1[t_i], packed.w2[t_i], n, packed.nf, rng
            )
        codes[5] = codes[0]
        seen |= set(np.unique(codes[1:5, :n]).tolist())
        words = torch.from_numpy(pack_action_codes(codes)).to(dev)
        lengths = torch.full((tiles,), n, dtype=torch.int32, device=dev)
        lengths[5] = 0
        vars_ = pts[t_i:t_i + 1].expand(tiles, -1, -1, -1).contiguous()
        tol = _matrix_tolerance(name)
        shared = (w1[t_i:t_i + 1], w2[t_i:t_i + 1], imm[t_i:t_i + 1])
        for nf in (packed.nf, 256):
            kw = dict(nf=nf, n_inputs=2, n_outputs=1, s0=pts.shape[2])
            got = interp.interp_float_coded(*shared, lengths, words, vars_, **kw)
            want = interp.interp_float_coded_plain(
                *shared, lengths, words, vars_, **kw
            )
            worst = max(worst, check(
                f"op matrix coded {name} (nf={nf})", got, want, tol, tol
            ))
            if not (got[5] == 0).all():
                raise Failed(f"op matrix coded {name}: a culled tile wrote")
    if seen != {0, 1, 2, 3}:
        raise Failed(f"op matrix coded: seeded codes hold only {seen}")
    torch.cuda.synchronize()
    log(f"op matrix coded: interp_float_coded over {len(cases)} shared tapes "
        f"x {tiles} tiles with seeded codes 0-3 agrees with its plain version "
        f"on both register-file routes; max abs err {worst:.3g}")


def _op_matrix_op_order(cases, packed, arena, pts, lo, hi, duals, dev):
    """K1, K2, K3 and K4 on each tape packed under its own frequency
    order: against the plain versions with the same order, and
    bit-equal to the same kernels on the canonical arena."""
    from fidget_tpu_torch.compiler.pack import frequency_op_order, pack_tapes
    from fidget_tpu_torch.eval import interp, simplify_device

    L = arena[0].shape[1]
    kw = dict(nf=packed.nf, n_inputs=2, n_outputs=1, s0=pts.shape[2])
    c_float = interp.interp_float(*arena, pts, **kw)
    c_ival = interp.interp_interval(*arena, lo, hi, c_words=1, **kw)
    c_codes = simplify_device.liveness_codes(
        arena[0], arena[1], arena[3], c_ival[2], nf=packed.nf, L=L,
        shared_tape=False,
    )
    c_grad = interp.interp_grad(*arena, duals, **kw)
    moved, worst = 0, 0.0
    for t_i, (name, tape) in enumerate(cases):
        order = frequency_op_order(tape)
        moved += order != tuple(range(len(order)))
        p = pack_tapes([tape], capacity=L, op_order=order)
        a = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (p.w1, p.w2, p.imm, p.lengths)]
        one = slice(t_i, t_i + 1)
        tol = _matrix_tolerance(name)
        got = interp.interp_float(*a, pts[one], op_order=order, **kw)
        want = interp.interp_float_plain(*a, pts[one], op_order=order, **kw)
        worst = max(worst, check(f"op_order float {name}", got, want, tol, tol))
        if not torch.equal(got.view(torch.int32), c_float[one].view(torch.int32)):
            raise Failed(f"op_order float {name} differs from canonical")
        got = interp.interp_interval(
            *a, lo[one], hi[one], c_words=1, op_order=order, **kw
        )
        want = interp.interp_interval_plain(
            *a, lo[one], hi[one], c_words=1, op_order=order, **kw
        )
        for k in range(2):
            worst = max(worst, check(
                f"op_order interval {name}", got[k], want[k], tol, tol
            ))
        if not torch.equal(got[2], want[2]):
            raise Failed(f"op_order interval choices {name} differ from plain")
        for g, c in zip(got, c_ival):
            if not torch.equal(g.view(torch.int32), c[one].view(torch.int32)):
                raise Failed(f"op_order interval {name} differs from canonical")
        lk = dict(nf=packed.nf, L=L, shared_tape=False, op_order=order)
        codes = simplify_device.liveness_codes(a[0], a[1], a[3], got[2], **lk)
        plain = simplify_device.liveness_codes_plain(
            a[0], a[1], a[3], got[2], **lk
        )
        if not (torch.equal(codes, plain) and torch.equal(codes, c_codes[one])):
            raise Failed(f"op_order liveness codes {name} differ")
        got = interp.interp_grad(*a, duals[one], op_order=order, **kw)
        want = interp.interp_grad_plain(*a, duals[one], op_order=order, **kw)
        gtol = 2e-4 if name in ("EXP", "LN") else 2e-5
        worst = max(worst, check(f"op_order grad {name}", got[:, :, 0],
                                 want[:, :, 0], gtol, gtol),
                    check(f"op_order grad derivatives {name}", got[:, :, 1:],
                          want[:, :, 1:], 1e-4, 1e-4))
        if not torch.equal(got.view(torch.int32),
                           c_grad[one].view(torch.int32)):
            raise Failed(f"op_order grad {name} differs from canonical")
    if moved < len(cases) // 2:
        raise Failed(f"only {moved} frequency orders differ from canonical")
    torch.cuda.synchronize()
    log(f"op matrix op_order: K1, K2, K3, K4 on {len(cases)} tapes under their "
        f"own frequency orders ({moved} of them not the canonical order) "
        f"agree with their plain versions (max abs err {worst:.3g}) and "
        f"are bit-equal to the canonical kernels")


@contextlib.contextmanager
def capture_kernel_inputs(targets, store):
    """Records, per key, the arguments of the call of each kernel
    wrapper with the most tape steps that the frames make (the first
    of equals; the wrappers themselves run unchanged). targets:
    (module, wrapper name, key function of the call's args and
    kwargs)."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def steps(args, name):
        lens = args[2] if name == "liveness_codes" else args[3]
        return int(lens.clamp(min=0).sum())

    def wrap(fn, name, keyfn):
        def recorder(*args, **kwargs):
            key = keyfn(args, kwargs)
            if key not in store or steps(args, name) > steps(store[key][0], name):
                store[key] = (args, kwargs)
            return fn(*args, **kwargs)
        return recorder

    for (mod, name, keyfn), (_, _, fn) in zip(targets, saved):
        setattr(mod, name, wrap(fn, name, keyfn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_frame(r, img, view, brute=None):
    """One 2D frame against `render_brute` (computed here unless the
    caller has it already)."""
    if brute is None:
        brute = r.render_brute(view)
    dist = img.distance.cpu().numpy()
    fill = img.fill.cpu().numpy()
    if dist.shape != brute.shape or not np.isfinite(dist).all():
        raise Failed("frame has the wrong shape or non-finite distances")
    from fidget_tpu_torch.render.render2d import (
        FILL_INSIDE, FILL_NONE, FILL_OUTSIDE,
    )

    ev = fill == FILL_NONE
    if not np.allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6):
        raise Failed("evaluated distances differ from render_brute")
    cls = img.fill_class().cpu().numpy()
    if not ((brute[cls == FILL_INSIDE] < 0).all()
            and (brute[cls == FILL_OUTSIDE] > 0).all()):
        raise Failed("a fill is not conservative")
    occ = img.inside().cpu().numpy()
    if not np.array_equal(occ, brute < 0):
        raise Failed(f"occupancy differs at {(occ != (brute < 0)).sum()} px")
    return float(occ.mean()), float(ev.mean())


def _bound(name, args, kwargs, out, lanes=None):
    """(bound_ms, bound_by, slot_bound_ms): the larger of the bytes the
    call must move over HBM bandwidth and the operations it does over
    the float32 rate, counting only the work this call's data needs, and
    beside it the scheduler-slot bound of those operations. A tape step
    counts one operation per real lane per value plane (float: 1,
    interval: 2, liveness: 1, grad: 4; the voxel pass one per voxel
    plus one per voxel of a live instance for its depth epilogue). Tape
    words count up to each instance's length; per-lane inputs count
    only for instances that have a tape (length > 0); inputs and
    outputs count only the `lanes` real lanes of an instance (the root
    and subtile passes pad theirs to a multiple of 128; None: every
    lane is real), and the voxel pass's output only its sub^2 depth
    columns. The coded leaf is counted by `_bound_coded`."""
    if name == "interp_float_coded":
        return _bound_coded(args, out)
    liveness = name == "liveness_codes"
    lens = args[2] if liveness else args[3]
    steps = int(lens.clamp(min=0).sum())
    planes = args[3] if liveness else args[4]
    B = planes.shape[0]
    width = planes.shape[-2] * 128
    real = width if lanes is None else lanes
    frac = real / width
    shared = liveness and args[0].shape[0] == 1
    n_live = B * int(int(lens[0]) > 0) if shared else int((lens > 0).sum())
    in_bytes = planes[0].nbytes * n_live * frac
    tape_bytes = (8 if liveness else 12) * steps
    if name == "interp_interval":
        in_bytes *= 2  # lo and hi
        out_bytes = sum(o.nbytes for o in out) * frac
        ops = 2 * steps * real
    elif liveness:
        out_bytes = out.nbytes * frac
        ops = steps * (B if shared else 1) * real
    elif name == "interp_grad":
        out_bytes = out.nbytes * frac
        ops = 4 * steps * real
    elif name == "interp_voxel_depth":
        out_bytes = B * kwargs["sub"] ** 2 * out.element_size()
        ops = steps * width + n_live * width
    else:
        out_bytes = out.nbytes * frac
        ops = steps * real
    nbytes = int(tape_bytes + in_bytes + out_bytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    log(f"  {name}: {steps} tape steps over {lens.numel()} tapes, "
        f"{n_live} instances with a tape, {real} of {width} lanes real; "
        f"{nbytes} bytes, {ops} operations")
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, _slot_bound_ms(ops)


def _slot_bound_ms(ops):
    """The scheduler-slot bound of an interpreter kernel: its operations
    (one per real lane, executed tape row and value plane, as `_bound`
    counts them) are `ops / 32` warp-rows, each at least
    ROW_INSTRUCTIONS warp instructions, over the card's schedulers at
    the SM clock. No interpreter comes near the float32 rate, which
    counts a row as one operation; this counts the instructions a row cannot do without."""
    return ops / 32 * ROW_INSTRUCTIONS / (SCHEDULERS * SM_CLOCK_HZ) * 1e3


def _bound_coded(args, out):
    """The bound of one `interp_float_coded` call: bytes are the rows of
    the shared tape that some tile executes, once each, the code words of
    the live tiles (length > 0) up to their length, their input planes
    and every tile's output plane; operations are one per lane per row
    whose code is non-zero within the tile's length."""
    from fidget_tpu_torch.eval.simplify_device import unpack_codes

    w1, _, _, lengths, codes, vars_ = args
    L = w1.shape[1]
    lens = lengths.clamp(min=0, max=L)
    n_live = int((lens > 0).sum())
    width = vars_.shape[-2] * 128
    rows = torch.arange(L, device=lens.device)[None, :] < lens[:, None]
    executed = (unpack_codes(codes, L) > 0) & rows
    steps = int(executed.sum())
    tape_bytes = 12 * int(executed.any(dim=0).sum())
    code_bytes = 4 * int(((lens + 15) // 16).sum())
    nbytes = int(tape_bytes + code_bytes + vars_[0].nbytes * n_live + out.nbytes)
    ops = steps * width
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    log(f"  interp_float_coded: {steps} executed rows of {int(lens.sum())} "
        f"walked over {lens.numel()} tiles, {n_live} of them live, {width} "
        f"lanes each; {nbytes} bytes, {ops} operations")
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, _slot_bound_ms(ops)


def _time_plain(plain, args, kwargs):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    want = plain(*args, **kwargs)
    t1.record()
    torch.cuda.synchronize()
    return want, t0.elapsed_time(t1)


def _kernel_pairs():
    from fidget_tpu_torch.eval import interp, simplify_device

    return {
        "interp_interval": (interp.interp_interval, interp.interp_interval_plain),
        "liveness_codes": (
            simplify_device.liveness_codes,
            simplify_device.liveness_codes_plain,
        ),
        "interp_float": (interp.interp_float, interp.interp_float_plain),
        "interp_grad": (interp.interp_grad, interp.interp_grad_plain),
        "interp_voxel_depth": (
            interp.interp_voxel_depth, interp.interp_voxel_depth_plain,
        ),
        "interp_float_coded": (
            interp.interp_float_coded, interp.interp_float_coded_plain,
        ),
    }


def measure_kernel(name, args, kwargs, lanes=None):
    """One kernel on one captured call: kernel against its plain
    version on the card, CUDA-event ms, plain ms and the bound (`lanes`:
    the real lanes of an instance, as `_bound` takes them)."""
    fn, plain = _kernel_pairs()[name]
    got = fn(*args, **kwargs)
    want, plain_ms = _time_plain(plain, args, kwargs)
    if name == "interp_interval":
        err = max(check(f"{name} {p}", g, w, 2e-5, 2e-5)
                  for p, g, w in zip(("lo", "hi"), got[:2], want[:2]))
        if not torch.equal(got[2], want[2]):
            raise Failed("interp_interval choices differ from plain")
    elif name in ("liveness_codes", "interp_voxel_depth"):
        if not torch.equal(got, want):
            raise Failed(f"{name} differs from plain")
        err = 0.0
    elif name == "interp_grad":
        err = max(check(f"{name} values", got[:, :, 0], want[:, :, 0],
                        2e-5, 2e-5),
                  check(f"{name} derivatives", got[:, :, 1:], want[:, :, 1:],
                        1e-4, 1e-4))
    else:
        err = check(name, got, want, 2e-5, 2e-5)
    ms = time_cuda(lambda: fn(*args, **kwargs), reps=20)
    bound_ms, bound_by, slot_ms = _bound(name, args, kwargs, got, lanes)
    planes = {"liveness_codes": 3, "interp_float_coded": 5}.get(name, 4)
    shape = tuple(args[planes].shape)
    log(f"kernel {name}: {kwargs}, inputs {shape}, max abs err {err:.3g}, "
        f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms "
        f"({bound_by}), scheduler-slot bound {slot_ms:.5f} ms")
    row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, slot_bound_ms=slot_ms)
    if name == "liveness_codes":
        row["chain_bound_ms"] = _chain_bound_ms(args)
        log(f"  serial-chain bound {row['chain_bound_ms']:.5f} ms")
    if name in KERNEL_INFO:
        from fidget_tpu_torch.eval import cuda

        cw = shape[1] if name == "liveness_codes" else kwargs.get("c_words", 0)
        g = cuda.launch_geometry(
            name, nf=kwargs["nf"], lanes=shape[-2] * 128, T=shape[0], cw=cw,
            sub=kwargs.get("sub", 0),
        )
        row["geometry"] = {
            "lanes_per_thread": g.r, "smem_bytes": g.smem, "blocks": g.blocks,
            "regs_shared": g.regs_shared, "choices_shared": g.choices_shared,
            "mask_words": g.mask_words,
        }
        log(f"  geometry: {row['geometry']}")
    return row


def _chain_bound_ms(args):
    """The bound of the liveness pass's serial chain: the most rows any
    instance walks, each CHAIN_INSTRUCTIONS dependent instructions at
    CHAIN_LATENCY cycles, at the SM clock (instances run side by side;
    a lane's rows one after another)."""
    w1, _, lens = args[:3]
    rows = int(lens.clamp(min=0, max=w1.shape[1]).max())
    return rows * CHAIN_INSTRUCTIONS * CHAIN_LATENCY / SM_CLOCK_HZ * 1e3


def phase_kernels(captured, launches, n_frames, n_tiles):
    """K1-K3 on the inputs the 2D path gave them; the root passes (K1,
    K2) hold one real lane per root tile."""
    rows = {}
    for name in KERNELS_2D:
        args, kwargs = captured[name]
        src, replaces = KERNEL_INFO[name]
        lanes = None if name == "interp_float" else n_tiles
        rows[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "launches_per_frame": launches[name] / n_frames,
            **measure_kernel(name, args, kwargs, lanes), "library_ms": None,
        }
    return rows


def device_ms(fn, name, reps=20):
    """Mean device time per call of the kernels whose name holds `name`
    over `reps` calls, from the profiler (None when it records none);
    beside `time_cuda`, which also counts the host's enqueue where it is
    slower than the kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if name in e.key and e.self_device_time_total > 0]
    count = sum(e.count for e in events)
    if not count:
        return None
    return sum(e.self_device_time_total for e in events) / 1e3 / count


def _renumbered(w1, order):
    """Tape words with their op fields moved to the positions of
    `order` (position -> canonical opcode), as `pack_tapes(op_order=)`
    packs them."""
    pos = torch.arange(128, dtype=torch.int32, device=w1.device)
    pos[torch.tensor(order, device=w1.device).long()] = torch.arange(
        len(order), dtype=torch.int32, device=w1.device)
    return ((w1 & ~127) | pos[(w1 & 127).long()]).contiguous()


def _same(got, want):
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def _routes3d(r, captured, rows):
    """K4 and K5 on the 3D path's inputs at other register-file sizes
    (the bucket's nf 64, one lane a thread, the global scratch), bit-
    equal to the path's results, with the bucket's nf timed; under the
    gyroid's frequency order, against the plain versions and bit-equal
    to the canonical results; K5 at sub 32 on a few gyroid subtiles."""
    from fidget_tpu_torch.compiler.pack import frequency_op_order, pack_tapes
    from fidget_tpu_torch.eval import cuda

    pairs = _kernel_pairs()
    order = frequency_op_order(r.tape)
    if order == tuple(range(len(order))):
        raise Failed("the gyroid's frequency order is the canonical one")
    for name, nfs in (("interp_grad", (64, 256)),
                      ("interp_voxel_depth", (64, 256, 512))):
        fn, plain = pairs[name]
        args, kwargs = captured[name]
        base = fn(*args, **kwargs)
        routes = []
        for nf in nfs:
            kw = {**kwargs, "nf": nf}
            g = cuda.launch_geometry(
                name, nf=nf, lanes=args[4].shape[-2] * 128,
                T=args[4].shape[0], sub=kw.get("sub", 0))
            routes.append((nf, g.r, g.regs_shared))
            if not _same(fn(*args, **kw), base):
                raise Failed(f"{name} at nf {nf} ({g}) differs from nf "
                             f"{kwargs['nf']}")
            if nf == r.nf_b:
                ms = time_cuda(lambda: fn(*args, **kw), reps=20)
                dms = device_ms(lambda: fn(*args, **kw), name + "_kernel")
                rows[name]["at_bucket_nf"] = dict(nf=nf, ms=ms, device_ms=dms,
                                                  r=g.r)
                log(f"kernel {name} at the bucket's nf {nf}: {ms:.4f} ms "
                    f"(device {dms if dms is None else round(dms, 4)} ms), "
                    f"{g.r} lanes a thread")
        w1o = _renumbered(args[0], order)
        got = fn(w1o, *args[1:], op_order=order, **kwargs)
        want = plain(w1o, *args[1:], op_order=order, **kwargs)
        if name == "interp_grad":
            err = max(check(f"{name} op_order values", got[:, :, 0],
                            want[:, :, 0], 2e-5, 2e-5),
                      check(f"{name} op_order derivatives", got[:, :, 1:],
                            want[:, :, 1:], 1e-4, 1e-4))
        elif not torch.equal(got, want):
            raise Failed(f"{name} under op_order differs from plain")
        else:
            err = 0.0
        if not _same(got, base):
            raise Failed(f"{name} under op_order differs from canonical")
        log(f"kernel {name}: equal at (nf, lanes a thread, shared) {routes}; "
            f"under the gyroid's op_order equal to plain (max abs err "
            f"{err:.3g}) and bit-equal to canonical")
    # K5 at sub 32: the gyroid over four 32^3 subtiles across its surface
    sub, T = 32, 4
    packed = pack_tapes([r.tape] * T)
    dev = captured["interp_voxel_depth"][0][0].device
    arena = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (packed.w1, packed.w2, packed.imm, packed.lengths)]
    arena[3][-1] = 0
    vz, vy, vx = np.meshgrid(*[np.arange(sub)] * 3, indexing="ij")
    vox = np.stack([vx, vy, vz]).reshape(3, -1).astype(np.float32)
    step = np.float32(2.0 / SIZE3)
    planes = np.zeros((T, packed.n_inputs, sub**3), np.float32)
    for t, base in enumerate(([-0.05, -0.05, 0.45], [0.3, -0.4, 0.2],
                              [-0.5, 0.1, -0.3], [0.0, 0.0, 0.0])):
        pts = np.asarray(base, np.float32)[:, None] + vox * step
        for v, i in r.tape.var_map.items():
            planes[t, i] = pts["xyz".index(v.kind)]
    planes = torch.from_numpy(planes.reshape(T, -1, sub**3 // 128, 128)).to(dev)
    kw = dict(nf=packed.nf, n_inputs=packed.n_inputs, s0=sub**3 // 128,
              sub=sub)
    fn, plain = pairs["interp_voxel_depth"]
    got = fn(*arena, planes, **kw)
    if not torch.equal(got, plain(*arena, planes, **kw)):
        raise Failed("interp_voxel_depth at sub 32 differs from plain")
    if len(got[:-1].unique()) < 4 or (got[-1] != 0).any():
        raise Failed("interp_voxel_depth at sub 32: too few depths, or a "
                     "culled subtile has one")
    log(f"kernel interp_voxel_depth at sub 32: {T} subtiles equal the plain "
        f"version ({len(got.unique())} distinct depths)")


def phase_kernels3d(r, captured, launches3d, n_frames, rows):
    """K4 and K5 on the inputs the 3D path gave them (with the
    profiler's device time beside the CUDA-event time, and
    `_routes3d`), and K1/K2 at their 3D shapes: one real lane per root
    tile at the root, per subtile of a root tile at the subtiles."""
    pairs = _kernel_pairs()
    for name in ("interp_grad", "interp_voxel_depth"):
        args, kwargs = captured[name]
        src, replaces = KERNEL_INFO[name]
        rows[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches3d[name],
            "launches_per_frame": launches3d[name] / n_frames,
            **measure_kernel(name, args, kwargs), "library_ms": None,
        }
        fn = pairs[name][0]
        dms = device_ms(lambda: fn(*args, **kwargs), name + "_kernel")
        rows[name]["device_ms"] = dms
        log(f"kernel {name}: profiler device time "
            f"{'not recorded' if dms is None else f'{dms:.4f} ms'} a launch")
    _routes3d(r, captured, rows)
    real = {"root": r.geo.nt, "subtile": r.geo.m, "instances": r.geo.m}
    for key in ("interp_interval@root", "interp_interval@subtile",
                "liveness_codes@root", "liveness_codes@instances"):
        name, where = key.split("@")
        args, kwargs = captured[key]
        m = measure_kernel(name, args, kwargs, real[where])
        rows[name].setdefault("at_3d", {})[where] = {
            k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "slot_bound_ms", "chain_bound_ms")
            if k in m
        }
    for name in rows:
        rows[name]["launches_3d"] = launches3d[name]
        rows[name]["launches_3d_per_frame"] = launches3d[name] / n_frames


def _stage_profile(render, frame, names, reps=10):
    """Where a warm frame's time goes: `render()` wall time on the
    host clock; per-stage times from CUDA events recorded as each stage
    is enqueued (`frame(hook)` runs one frame with a stage hook; a stage
    that waits on the host to enqueue its work shows that wait too, and
    stages that repeat are summed); and the device's busy time per frame
    from the profiler, summed over every kernel."""
    sums = dict.fromkeys(names, 0.0)
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    for _ in range(reps):
        events = []

        def hook(stage):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((stage, ev))

        torch.cuda.synchronize()
        hook("start")
        frame(hook)
        torch.cuda.synchronize()
        for (_, e0), (stage, e1) in zip(events, events[1:]):
            sums[stage] += e0.elapsed_time(e1)
    log(f"render() wall time (host clock, synchronized): median "
        f"{float(np.median(wall)):.3f} ms, min {min(wall):.3f} ms over "
        f"{reps} warm frames")
    log("stages (ms per warm frame, CUDA events): " + ", ".join(
        f"{n} {sums[n] / reps:.3f}" for n in names))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            render()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / reps
    # device-side entries only: a host op's entry repeats its kernels' time
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / reps
    if busy == 0:
        log("profiler: no device time recorded; busy share not measured")
        return
    events.sort(key=lambda e: -e.self_device_time_total)
    log(f"profiler: device busy {busy:.3f} ms per frame of {prof_wall:.3f} "
        f"ms wall under the profiler ({100 * busy / prof_wall:.1f}% busy; "
        f"{100 * busy / float(np.median(wall)):.1f}% of the unprofiled "
        f"median); {sum(e.count for e in events) / reps:.0f} device ops "
        f"per frame")
    for e in events[:8]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms/frame "
            f"{e.count / reps:5.0f}x  {e.key[:70]}")


def phase_stages(r, view):
    mat, vec = r._mat4(view), r._var_vec(None)
    _stage_profile(
        lambda: r.render(view),
        lambda hook: r._frame(mat, 0.0, vec, stage_hook=hook),
        ["root", "codes", "reconstruct", "leaf", "assemble"],
    )


def _same_where_evaluated(label, img, fill, std):
    """Fills equal to the standard frame's, distances bit-equal where
    evaluated."""
    if not torch.equal(fill, std.fill):
        raise Failed(f"{label}: fills differ from the standard frame")
    ev = std.fill == 0
    if not torch.equal(img[ev].view(torch.int32),
                       std.distance[ev].view(torch.int32)):
        raise Failed(f"{label}: evaluated distances are not bit-equal to the "
                     f"standard frame's")


def phase_coded(r, std_images, brutes, cuda, render2d):
    """The coded-leaf frames (K1, K2, K6; no child tapes, no K3), K6 on
    the inputs they gave it, and the stages of a warm coded frame.
    Returns K6's row of the `kernels` line."""
    from fidget_tpu_torch.eval import interp

    vec = r._var_vec(None)
    frame = lambda view, **kw: r._frame(
        r._mat4(view), 0.0, vec, leaf_coded=True, **kw
    )
    captured = {}
    name = "interp_float_coded"
    with capture_kernel_inputs([(render2d, name, lambda a, k: name)], captured):
        frame(FRAMES[0])  # warm-up; its inputs feed the kernel phase
    torch.cuda.synchronize()

    cuda.reset_launches()
    frames = [frame(view) for view in FRAMES]
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"coded frames: launches over {len(FRAMES)} frames: {launches}")
    missing = [k for k in KERNELS_2D_CODED if launches[k] == 0]
    if missing or launches["interp_float"]:
        raise Failed(f"coded frames launched {launches}")
    for k, ((img, fill), view) in enumerate(zip(frames, FRAMES)):
        img, fill = img[: r.H, : r.W], fill[: r.H, : r.W]
        ink, evaluated = check_frame(
            r, render2d.Image2D(img, fill), view, brutes[k]
        )
        _same_where_evaluated(f"coded frame {k}", img, fill, std_images[k])
        log(f"coded frame {k}: occupancy equals render_brute ({ink:.4f} "
            f"inside, {evaluated:.3f} of pixels evaluated), bit-equal to the "
            f"standard frame where evaluated")

    args, kwargs = captured[name]
    src, replaces = KERNEL_INFO[name]
    row = {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "launches": launches[name],
        "launches_per_frame": launches[name] / len(FRAMES),
        **measure_kernel(name, args, kwargs), "library_ms": None,
    }
    got = interp.interp_float_coded(*args, **kwargs)
    for nf in (r.nf_b, 256):
        other = dict(kwargs, nf=nf)
        if not torch.equal(interp.interp_float_coded(*args, **other), got):
            raise Failed(f"interp_float_coded differs at nf {nf}")
        other_ms = time_cuda(lambda: interp.interp_float_coded(*args, **other),
                             10)
        g = cuda.launch_geometry(name, nf=nf, lanes=args[5].shape[-2] * 128,
                                 T=args[5].shape[0])
        row[f"ms_at_nf{nf}"] = other_ms
        log(f"kernel interp_float_coded at nf {nf} ({g.r} lanes a thread, "
            f"register file in {'shared' if g.regs_shared else 'device'} "
            f"memory) equals it at nf {kwargs['nf']}; {other_ms:.4f} ms")
    log("coded frame stages:")
    _stage_profile(
        lambda: frame(FRAMES[1]),
        lambda hook: frame(FRAMES[1], stage_hook=hook),
        ["root", "codes", "reconstruct", "leaf", "assemble"],
    )
    return row


def phase_per_shape(port, tape, std_images, brutes, cuda, render2d,
                    simplify_device, rows):
    """The per-shape arena (`specialize=True`) and the two-level frame
    (`tile_sizes=(128, 32)`): the main path's views against
    `render_brute`; K1, K2 and K3 on the inputs these paths gave them
    under the shape's op_order (kernel against plain version, time and
    bound, kept in `rows` under `at_specialized` / `at_two_level`); and
    the stages of a warm frame of each. Returns the two renderers by
    label."""
    renderers = {}
    for label, opts in (("specialized", dict(specialize=True)),
                        ("two-level", dict(tile_sizes=(128, 32)))):
        r = port.PixelRenderer(tape, port.ImageSize(SIZE, SIZE), **opts)
        renderers[label] = r
        log(f"{label} frames: arena of {r.packed.capacity} rows under op_order "
            f"{r.op_order[:8]}..., nf {r.nf}, cw {r.c_words}; tiles "
            f"{r.tile_sizes}, {r.nc} leaf instances")
        captured = {}
        where = lambda a: "root" if a[0].shape[0] == 1 else "subtiles"
        targets = [
            (render2d, "interp_interval",
             lambda a, k: "interp_interval@" + where(a)),
            (render2d, "interp_float", lambda a, k: "interp_float@leaf"),
            (simplify_device, "liveness_codes",
             lambda a, k: "liveness_codes@" + where(a)),
        ]
        with capture_kernel_inputs(targets, captured):
            r.render(FRAMES[0])  # warm-up; its inputs feed the timings
        torch.cuda.synchronize()
        cuda.reset_launches()
        images = [r.render(view) for view in FRAMES]
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        log(f"{label} frames: launches over {len(FRAMES)} frames: {launches}")
        missing = [k for k in KERNELS_2D if launches[k] == 0]
        if missing or launches["interp_float_coded"]:
            raise Failed(f"{label} frames launched {launches}")
        for k, (img, view) in enumerate(zip(images, FRAMES)):
            ink, evaluated = check_frame(r, img, view, brutes[k])
            levels = img.fill_level()
            shares = ", ".join(
                f"level {lv} {float((levels == lv).float().mean()):.3f}"
                for lv in (0, 1)
            )
            log(f"{label} frame {k}: occupancy equals render_brute "
                f"({ink:.4f} inside, {evaluated:.3f} of pixels evaluated; "
                f"filled at {shares})")
            if not r.two_level:
                _same_where_evaluated(f"{label} frame {k}", img.distance,
                                      img.fill, std_images[k])
        if r.two_level:
            if not (images[2].fill_level() == 1).any():
                raise Failed("two-level: no level-1 fill on the zoomed-out view")
            if not (images[2].fill_level() == 0).any():
                raise Failed("two-level: no level-0 fill on the zoomed-out view")
        else:
            log(f"{label} frames equal the bucketed frames (fills equal, "
                f"distances bit-equal where evaluated)")
        real = {"root": r.n0, "subtiles": r.m, "leaf": None}
        for key in sorted(captured):
            name, where = key.split("@")
            args, kwargs = captured[key]
            log(f"kernel {key} ({label}): {tuple(args[0].shape)} arena, "
                f"op_order {'set' if kwargs.get('op_order') else 'none'}")
            at = rows[name].setdefault("at_" + label.replace("-", "_"), {})
            at[where] = measure_kernel(name, args, kwargs, real[where])
        for name in KERNELS_2D:
            at = rows[name]["at_" + label.replace("-", "_")]
            at["launches"] = launches[name]
        mat, vec = r._mat4(FRAMES[1]), r._var_vec(None)
        log(f"{label} frame stages:")
        names = ["root", "codes", "reconstruct", "leaf", "assemble"]
        if r.two_level:
            names.insert(3, "subtiles")
        _stage_profile(
            lambda: r.render(FRAMES[1]),
            lambda hook: r._frame(mat, 0.0, vec, stage_hook=hook),
            names,
        )
    return renderers


def phase_compare_frames(r, per_shape, view, rounds=20):
    """Warm frames of the four tape bindings in turns on this card
    (standard, coded, specialized, two-level, `rounds` times over), so
    that drift of the host's clock falls on all alike: host-clock wall
    time of a synchronized frame, median and min per binding."""
    mat, vec = r._mat4(view), r._var_vec(None)
    frames = {
        "standard": lambda: r.render(view),
        "coded": lambda: r._frame(mat, 0.0, vec, leaf_coded=True),
        "specialized": lambda: per_shape["specialized"].render(view),
        "two-level": lambda: per_shape["two-level"].render(view),
    }
    wall = {k: [] for k in frames}
    for fn in frames.values():
        fn()
    for _ in range(rounds):
        for label, fn in frames.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall[label].append((time.perf_counter() - t0) * 1e3)
    log(f"frames in turns ({rounds} rounds, host clock, synchronized), ms "
        "median / min: " + "; ".join(
            f"{k} {float(np.median(v)):.3f} / {min(v):.3f}"
            for k, v in wall.items()))


def phase_stages3d(r, view):
    mat, vec = r._mat4(view), r._var_vec(None)
    _stage_profile(
        lambda: r.render(view),
        lambda hook: r._frame(mat, vec, stage_hook=hook),
        ["root", "simplify", "proofs", "compact", "respecialize", "voxel",
         "fold", "normals"],
    )


# ----------------------------------------------------------------------
# 3D main path


class _Peak:
    """A value mode around `mode` that records, per point, the largest
    magnitude of any value the tape makes: the scale of its f32
    rounding errors there."""

    def __init__(self, mode):
        self.mode, self.peak = mode, 0.0

    def _seen(self, v):
        self.peak = np.fmax(self.peak, np.abs(v))
        return v

    def const(self, imm, like):
        return self.mode.const(imm, like)

    def unary(self, op, a):
        return self._seen(self.mode.unary(op, a))

    def binary(self, op, a, b):
        return self._seen(self.mode.binary(op, a, b))

    def choice_binary(self, op, a, b):
        v, c = self.mode.choice_binary(op, a, b)
        return self._seen(v), c


#: how close to the surface, in f32 ulps of the tape's largest value at
#: the point, a voxel must lie for the card and numpy to disagree on it
SURFACE_ULPS = 4


def check_depth(r, depth, brute, view):
    """Depth equal to render_brute. A column may differ only where the
    voxel the two disagree on lies on the surface to within f32
    rounding: numpy's f32 distance there gives render_brute's verdict,
    and the distance evaluated in float64 at the same f32 coordinates
    is within SURFACE_ULPS f32 ulps of the largest value the tape makes
    there (transcendentals round differently on the card and in numpy).
    The witness is numpy alone, independent of the port's kernels.
    Returns one reading per differing column."""
    from fidget_tpu_torch.eval.arith import FloatMode
    from fidget_tpu_torch.eval.unrolled import eval_tape
    from fidget_tpu_torch.render.transform import transform_points

    bad = np.argwhere(depth != brute)
    if not len(bad):
        return []
    rows, cols = bad[:, 0], bad[:, 1]
    dp, db = depth[rows, cols], brute[rows, cols]
    z = np.maximum(dp, db) - 1  # the voxel the two sides disagree on
    f32 = np.float32
    mat = r._screen_mat(r._mat4(view))
    pts = transform_points(mat, cols.astype(f32), rows.astype(f32), z.astype(f32))
    inputs = r._brute_inputs(r._var_vec(None), pts, pts[0])
    peak = _Peak(FloatMode(np))
    with np.errstate(all="ignore"):
        (d32,), _ = eval_tape(r.tape, FloatMode(np), inputs)
        (d64,), _ = eval_tape(r.tape, peak, [a.astype(np.float64) for a in inputs])
    band = SURFACE_ULPS * np.spacing(np.asarray(peak.peak, f32))
    ok = ((d32 < 0) == (db > dp)) & (np.abs(d64) <= band)
    readings = list(zip(rows.tolist(), cols.tolist(), dp.tolist(),
                        db.tolist(), d32.tolist(), d64.tolist(),
                        band.tolist()))
    for row, col, a, b, x32, x64, w in readings[:8]:
        log(f"    column ({row}, {col}): depth {a}, brute {b}; distance of "
            f"voxel {max(a, b) - 1}: numpy f32 {x32!r}, float64 {x64!r}, "
            f"band {w!r}")
    if not ok.all():
        raise Failed(f"depth differs from render_brute at {len(bad)} "
                     f"columns, {int((~ok).sum())} of them off the surface")
    return readings


def check_frame3d(r, img, view, brute, label, exact=False):
    """Depth against render_brute (`exact`: no column may differ, else
    as `check_depth` allows), normals against the numpy oracle."""
    depth = img.depth.cpu().numpy()
    if depth.shape != (r.H, r.W) or depth.dtype != np.int32:
        raise Failed(f"{label}: depth has shape {depth.shape} {depth.dtype}")
    if exact and not np.array_equal(depth, brute):
        raise Failed(f"{label}: depth differs from render_brute at "
                     f"{int((depth != brute).sum())} columns")
    rounding = len(check_depth(r, depth, brute, view))
    msg = (f"{label}: depth equals render_brute "
           f"({(depth > 0).mean():.4f} of pixels hit, "
           f"{(depth == r.D).mean():.4f} saturated")
    msg += (f"; {rounding} columns differ at a voxel on the surface to "
            "within f32 rounding)" if rounding else ")")
    if img.normal is not None:
        normal = img.normal.cpu().numpy()
        if normal.shape != (r.H, r.W, 3) or not np.isfinite(normal).all():
            raise Failed(f"{label}: normals have the wrong shape or non-finite"
                         " values")
        want = r.brute_normals(depth, view)
        hit = (depth > 0) & (depth < r.D)
        bad = ~np.isclose(normal, want, rtol=1e-4, atol=1e-4).all(-1) & hit
        if bad.any():
            k = np.argwhere(bad)[:4]
            raise Failed(f"{label}: normals differ from the oracle at "
                         f"{int(bad.sum())} px, e.g. {k.tolist()}: "
                         f"{normal[tuple(k.T)].tolist()} vs "
                         f"{want[tuple(k.T)].tolist()}")
        if not (normal[depth == r.D] == (0.0, 0.0, 1.0)).all():
            raise Failed(f"{label}: a saturated pixel is not [0, 0, 1]")
        if not (normal[depth == 0] == 0.0).all():
            raise Failed(f"{label}: an empty pixel has a normal")
        err = float(np.abs(normal - want)[hit].max()) if hit.any() else 0.0
        msg += f"; normals agree with the oracle (max abs err {err:.3g})"
    log(msg)


def phase_main3d(port, cuda, render3d, render2d, simplify_device):
    from fidget_tpu_torch.scenes import gyroid_sphere

    shape = gyroid_sphere(port)
    tape = shape.tape()
    if (len(tape), tape.reg_count, tape.choice_count) != (28, 6, 1):
        raise Failed(f"gyroid sphere lowered to {len(tape)} ops")
    r = port.VoxelRenderer(shape, port.VoxelSize(SIZE3, SIZE3, SIZE3),
                           tile_size=64, sub_size=16)
    log(f"3D main path: gyroid sphere, {len(tape)}-op tape; buckets Lcap "
        f"{r.Lcap_b}, nf {r.nf_b}, cw {r.cw_b}; {SIZE3}^3 in tiles of "
        f"{r.ts} and subtiles of {r.sub}, worklist {r.cap} slots")
    captured = {}
    targets = [
        (render3d, "interp_interval",
         lambda a, k: "interp_interval@" + ("root" if a[0].shape[0] == 1
                                            else "subtile")),
        (render3d, "interp_voxel_depth", lambda a, k: "interp_voxel_depth"),
        (render3d, "interp_grad", lambda a, k: "interp_grad"),
        (render2d, "liveness_codes", lambda a, k: "liveness_codes@root"),
        (simplify_device, "liveness_codes",
         lambda a, k: "liveness_codes@instances"),
    ]
    with capture_kernel_inputs(targets, captured):
        r.render(VIEWS3[0][1])  # warm-up; its inputs feed the kernel phase
    torch.cuda.synchronize()

    cuda.reset_launches()
    images = [r.render(view) for _, view in VIEWS3]
    images.append(r.render(VIEWS3[0][1], mode="heightmap"))
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    n_frames = len(images)
    log(f"3D main path launches over {n_frames} frames: {launches}")
    missing = [k for k in KERNELS_3D if launches[k] == 0]
    if missing:
        raise Failed(f"3D main path never launched {missing}")
    brutes = {}
    for (label, view), img in zip(VIEWS3 + [("heightmap", VIEWS3[0][1])],
                                  images):
        t0 = time.time()
        key = label if label != "heightmap" else "identity"
        if key not in brutes:
            brutes[key] = r.render_brute(view).depth.numpy()
        if label == "heightmap" and img.normal is not None:
            raise Failed("heightmap frame returned normals")
        check_frame3d(r, img, view, brutes[key], label)
        log(f"  oracle {time.time() - t0:.1f} s")
    if not np.array_equal(images[-1].depth.cpu().numpy(),
                          images[0].depth.cpu().numpy()):
        raise Failed("heightmap and normals frames disagree on depth")
    return r, captured, launches, n_frames


def phase_union3d(port, cuda, reps=10):
    from fidget_tpu_torch.scenes import sphere_union_shape

    ctx = port.Context()
    tape = port.lower(ctx, [sphere_union_shape(ctx)])
    if (len(tape), tape.reg_count, tape.choice_count) != (3303, 13, 299):
        raise Failed(f"sphere union lowered to {len(tape)} ops, "
                     f"{tape.reg_count} registers, {tape.choice_count} choices")
    r = port.VoxelRenderer(tape, port.VoxelSize(128, 128, 128), tile_size=32,
                           sub_size=16)
    r.render()
    torch.cuda.synchronize()
    cuda.reset_launches()
    img = r.render()
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    missing = [k for k in KERNELS_3D if launches[k] == 0]
    if missing:
        raise Failed(f"sphere union frame never launched {missing}")
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    log(f"3D tape-heavy scene: {len(tape)}-op sphere union, buckets Lcap "
        f"{r.Lcap_b}, nf {r.nf_b}, cw {r.cw_b}; 128^3 in tiles of 32, "
        f"worklist {r.cap}; launches {launches}; render() wall time (host "
        f"clock, synchronized): median {float(np.median(wall)):.3f} ms, min "
        f"{min(wall):.3f} ms over {reps} warm frames")
    t0 = time.time()
    # sub, square, add, sqrt and min round correctly in f32 on both sides
    check_frame3d(r, img, None, r.render_brute().depth.numpy(), "union",
                  exact=True)
    log(f"  oracle {time.time() - t0:.1f} s")


# ----------------------------------------------------------------------
# gradients, bulk evaluation and meshing

#: finite-difference step and the reference's tolerances
#: (tests/test_grad_parity.py:230-253)
H_FD = 1e-2
#: parameter values of the parametrized 2D stand-in: (shift, grow)
GRAD_PARAMS = (0.013, 0.004)
#: BASELINE.json's meshing depth, and the depth of the card-against-CPU
#: build
MESH_DEPTH = 8
MESH_DEPTH_CPU = 5
#: world -> model of the mesh scenes: world [-1, 1]^3 views model
#: [-1.1, 1.1]^3, so the union's spheres (centres in [-0.9, 0.9], radii
#: up to 0.12) and the gyroid sphere (radius 0.8) lie inside the cube
#: and their meshes close
MESH_VIEW = np.diag([1.1, 1.1, 1.1, 1.0])
#: warm builds timed per scene
MESH_REPS = 3
#: instances of a captured bulk call held to the plain version: the
#: plain version walks every instance's copy of the tape on the host,
#: so it takes the first few (each instance depends on its own lanes
#: only)
PLAIN_INSTANCES = 4
KERNELS_MESH = ("interp_interval", "interp_float", "interp_grad")


def _param_standin(port):
    from fidget_tpu_torch.scenes import param_standin_shape

    ctx = port.Context()
    shift, grow = port.Var.new(), port.Var.new()
    tape = port.lower(ctx, [param_standin_shape(ctx, ctx.input(shift),
                                                ctx.input(grow))])
    if (len(tape), tape.reg_count, tape.choice_count) != (7207, 14, 1066):
        raise Failed(f"parametrized stand-in lowered to {len(tape)} ops, "
                     f"{tape.reg_count} registers, {tape.choice_count} choices")
    return tape, shift, grow


def _device_busy(fn, reps):
    """(device busy ms per call, wall ms per call under the profiler,
    device ops per call, the heaviest kernels) of `fn` over `reps`
    warm calls, from the profiler's device-side entries; None when it
    records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / reps
    if busy == 0:
        return None
    events.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key[:60], e.self_device_time_total / 1e3 / reps, e.count / reps)
           for e in events[:5]]
    return busy, wall, sum(e.count for e in events) / reps, top


def _log_busy(label, busy, median_ms):
    if busy is None:
        log(f"  {label}: profiler recorded no device time; busy share not "
            f"measured")
        return None
    ms, wall, ops, top = busy
    log(f"  {label}: device busy {ms:.3f} ms a run of {wall:.1f} ms under the "
        f"profiler ({100 * ms / median_ms:.1f}% of the unprofiled median "
        f"{median_ms:.1f} ms), {ops:.0f} device ops; heaviest: " + "; ".join(
            f"{k} {t:.3f} ms x{c:.0f}" for k, t, c in top))
    return ms


def _median_ms(fn, reps):
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(wall)), min(wall)


def phase_grad(port, cuda, rows, size=SIZE, reps=5, dev="cuda"):
    """The shape-parameter gradient of a 1024^2 frame of the
    parametrized stand-in (bucketed binding, pixel_perfect): loss
    sum(img^2) / N^2 reversed through `_frame` with backward(), held to
    forward mode (`torch.func.jacfwd`; rtol 1e-5, atol 1e-6) and to
    central differences (h = 1e-2; rtol 2e-2, atol 1e-3); without
    pixel_perfect, proven fills get a zero or NaN tangent
    (`torch.func.jvp`). Times the forward frame and the forward +
    backward step; records K3 and K4 launches of the step and holds both
    kernels to their plain versions on its inputs."""
    dev = torch.device(dev)
    tape, shift, grow = _param_standin(port)
    r = port.PixelRenderer(tape, port.ImageSize(size, size), device=dev)
    mat = r._mat4(None)
    vec0 = r._var_vec({shift: GRAD_PARAMS[0], grow: GRAD_PARAMS[1]})
    V = len(vec0)
    N = size

    def loss(v, pixel_perfect=True):
        img, _ = r._frame(mat, 0.0, v, pixel_perfect=pixel_perfect)
        return (img[:N, :N] ** 2).sum() / (N * N)

    def step():
        v = torch.tensor(vec0, device=dev, requires_grad=True)
        loss(v).backward()
        return v.grad

    from fidget_tpu_torch.eval import interp
    from fidget_tpu_torch.render import render2d

    captured = {}
    targets = [(render2d, "interp_float", lambda a, k: "interp_float"),
               (interp, "interp_grad", lambda a, k: "interp_grad")]
    with capture_kernel_inputs(targets, captured):
        step()  # warm-up; its inputs feed the kernel rows
    torch.cuda.synchronize()
    cuda.reset_launches()
    g_rev = step()
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"gradient: {len(tape)}-op parametrized stand-in, V = {V}, {N}^2, "
        f"one forward + backward step launched {launches}")
    for k in ("interp_float", "interp_grad"):
        if launches[k] == 0:
            raise Failed(f"the gradient step never launched {k}")
    g_rev = g_rev.double().cpu().numpy()
    g_fwd = torch.func.jacfwd(loss)(torch.tensor(vec0, device=dev))
    g_fwd = g_fwd.double().cpu().numpy()
    if not np.allclose(g_rev, g_fwd, rtol=1e-5, atol=1e-6):
        raise Failed(f"reverse mode {g_rev} differs from forward mode {g_fwd}")
    fd = np.zeros(V)
    with torch.no_grad():
        for k in range(V):
            e = np.zeros(V, np.float32)
            e[k] = H_FD
            lo = float(loss(torch.tensor(vec0 - e, device=dev)))
            hi = float(loss(torch.tensor(vec0 + e, device=dev)))
            fd[k] = (hi - lo) / (2 * H_FD)
    if not np.allclose(g_rev, fd, rtol=2e-2, atol=1e-3):
        raise Failed(f"reverse mode {g_rev} differs from central "
                     f"differences {fd}")
    # beside it, a step ten times smaller (reported, not held: the
    # 800-circle loss is not smooth at the scale of a few pixels)
    fd3 = np.zeros(V)
    with torch.no_grad():
        for k in range(V):
            e = np.zeros(V, np.float32)
            e[k] = H_FD / 10
            lo = float(loss(torch.tensor(vec0 - e, device=dev)))
            hi = float(loss(torch.tensor(vec0 + e, device=dev)))
            fd3[k] = (hi - lo) / (2 * H_FD / 10)
    kinds = [v.kind for v, _ in sorted(tape.var_map.items(), key=lambda p: p[1])]
    log(f"  d loss / d inputs {kinds}: "
        f"reverse {g_rev.tolist()}, torch.func.jacfwd {g_fwd.tolist()}, central "
        f"differences {fd.tolist()} (h = {H_FD}), {fd3.tolist()} (h = "
        f"{H_FD / 10})")
    # fills carry no tangent: the zoomed-out view, whose outer tiles
    # are proven empty
    dvec = torch.zeros(V, device=dev)
    dvec[tape.var_map[shift]] = 0.7
    dvec[tape.var_map[grow]] = -0.3
    mat2 = r._mat4(FRAMES[2])
    _, tang = torch.func.jvp(
        lambda v: r._frame(mat2, 0.0, v, pixel_perfect=False)[0],
        (torch.tensor(vec0, device=dev),), (dvec,))
    _, fill = r._frame(mat2, 0.0, vec0, pixel_perfect=False)
    filled = fill != 0
    t_fill = tang[filled]
    if not filled.any() or not bool(((t_fill == 0) | ~torch.isfinite(t_fill)).all()):
        raise Failed("no proven fill, or one carries a finite non-zero tangent")
    log(f"  pixel_perfect=False: {int(filled.sum())} filled pixels, all with "
        f"a zero or NaN tangent")
    with torch.no_grad():
        fwd_ms = _median_ms(lambda: loss(torch.tensor(vec0, device=dev)), reps)
    step_ms = _median_ms(step, reps)
    log(f"  forward frame + loss {fwd_ms[0]:.3f} ms median ({fwd_ms[1]:.3f} "
        f"min), forward + backward step {step_ms[0]:.3f} ms median "
        f"({step_ms[1]:.3f} min), host clock, synchronized, {reps} warm "
        f"runs")
    busy = _log_busy("gradient step", _device_busy(step, reps), step_ms[0])
    for name in ("interp_float", "interp_grad"):
        args, kwargs = captured[name]
        rows[name]["at_gradient"] = {
            "launches": launches[name], "forward_ms": fwd_ms[0],
            "step_ms": step_ms[0], "step_device_busy_ms": busy,
            **_measure_sliced(f"{name} in the gradient step", name, args,
                              kwargs),
        }


def _mesh_scenes(port):
    from fidget_tpu_torch.scenes import gyroid_sphere, sphere_union_shape

    ctx = port.Context()
    union = port.lower(ctx, [sphere_union_shape(ctx)])
    if (len(union), union.reg_count, union.choice_count) != (3303, 13, 299):
        raise Failed(f"sphere union lowered to {len(union)} ops")
    return [("union", "sphere union", union),
            ("gyroid", "gyroid sphere", gyroid_sphere(port))]


@contextlib.contextmanager
def _cell_boxes(collapse, boxes):
    """Records, for the build it wraps, every output vertex with the
    box of the octree cell it belongs to: the leaf cell of a fine
    vertex, the merged cell of a collapsed one. `boxes` receives
    (vertices [V, 3] f64, lo [V, 3], size [V]) in world units."""
    real_walk = collapse.collapse_and_walk
    real_store = collapse.HostVertexStore

    class BoxedStore(real_store):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.lo, self.size = BoxedStore.fine

        def merge_round(self, member_vids, seg_member, pbase, ps):
            self.cand = (pbase, ps)
            return super().merge_round(member_vids, seg_member, pbase, ps)

        def commit(self, accept):
            pbase, ps = self.cand
            lo = pbase[accept].astype(np.float64) * self.h - 1.0
            self.lo = np.concatenate([self.lo, lo])
            self.size = np.concatenate(
                [self.size, np.full(len(lo), ps * self.h)])
            return super().commit(accept)

        def final_positions(self, ids):
            boxes.append((self.vpos[ids], self.lo[ids], self.size[ids]))
            return super().final_positions(ids)

    def walk(**kw):
        cells, nvert, h = kw["cells"], kw["nvert"], kw["h"]
        cov = np.repeat(np.arange(len(cells)), nvert)
        BoxedStore.fine = (cells[cov].astype(np.float64) * h - 1.0,
                           np.full(len(cov), h))
        return real_walk(**kw)

    collapse.HostVertexStore = BoxedStore
    collapse.collapse_and_walk = walk
    try:
        yield
    finally:
        collapse.HostVertexStore = real_store
        collapse.collapse_and_walk = real_walk


def check_mesh(label, mesh, ev, boxes, view):
    """A mesh of a closed scene: every undirected edge used twice but at
    ambiguous-face pinches (used 3 or 4 times, balanced in direction, as
    fidget_tpu/mesh/__init__.py:34-44 documents and tests/test_mesh.py
    checks); outward winding (positive enclosed volume, and each
    triangle's normal along the tape's gradient at its centroid for 99%
    of triangles); every vertex inside the box of its cell; and every
    vertex within its cell's diagonal of the surface by the first-order
    estimate |f| / |grad f| (`BulkEvaluator`, in model units)."""
    v = mesh.vertices.astype(np.float64)
    t = mesh.triangles
    if len(t) == 0 or not np.isfinite(v).all():
        raise Failed(f"{label}: empty mesh or non-finite vertices")
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    und = np.sort(e, axis=1)
    uniq, inv, counts = np.unique(und, axis=0, return_inverse=True,
                                  return_counts=True)
    fwd = np.bincount(inv, weights=(e[:, 0] < e[:, 1]), minlength=len(uniq))
    pinch = counts != 2
    if (counts < 2).any() or (counts > 4).any() or (
            np.abs(2 * fwd - counts)[pinch] > 1).any():
        raise Failed(f"{label}: not a closed 2-manifold (edge uses "
                     f"{np.bincount(counts).tolist()})")
    a, b, c = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
    n = np.cross(b - a, c - a)
    volume = float(np.einsum("ij,ij->i", a, np.cross(b, c)).sum() / 6)
    mv = np.asarray(view, np.float64)
    cen = (a + b + c) / 3 @ mv[:3, :3].T + mv[:3, 3]
    g = ev.eval_grad(*cen.T.astype(np.float32)).cpu().numpy()[0]
    grad_w = g[1:4].T @ mv[:3, :3]
    along = np.einsum("ij,ij->i", n, grad_w) > 0
    area = np.linalg.norm(n, axis=1)
    along_area = float(area[along].sum() / area.sum())
    log(f"  {label}: {along.mean():.5f} of triangles ({along_area:.5f} of "
        f"the area) have their normal along the gradient")
    if volume <= 0 or along_area < 0.99:
        raise Failed(f"{label}: winding: volume {volume}, "
                     f"{along_area:.4f} of the area along the gradient")
    pos, lo, size = boxes
    if len(pos) != len(v) or not np.array_equal(pos.astype(np.float32),
                                                mesh.vertices):
        raise Failed(f"{label}: the recorded vertices are not the mesh's")
    if ((pos < lo) | (pos > lo + size[:, None])).any():
        raise Failed(f"{label}: a vertex lies outside its cell")
    vm = (v @ mv[:3, :3].T + mv[:3, 3]).astype(np.float32)
    fg = ev.eval_grad(*vm.T).cpu().numpy()[0].astype(np.float64)
    est = np.abs(fg[0]) / np.maximum(np.linalg.norm(fg[1:4], axis=0), 1e-12)
    diag = np.sqrt(3.0) * size * abs(mv[0, 0])
    if not (est <= diag).all():
        k = int(np.argmax(est / diag))
        raise Failed(f"{label}: vertex {k} lies {est[k]} from the surface, "
                     f"its cell's diagonal is {diag[k]}")
    log(f"  {label}: {len(v)} vertices, {len(t)} triangles, "
        f"{int(pinch.sum())} pinched edges, volume {volume:.5f}, "
        f"{int((size > size.min()).sum())} collapsed vertices; "
        f"|f|/|grad f| max {est.max():.3g}, median {np.median(est):.3g} "
        f"(model units)")


def _stage_table(stages):
    """Stage label (without its counts) -> ms, summed."""
    out = {}
    for label, ms in stages:
        key = label.split(" (")[0]
        if key.startswith("collapse s="):
            key = "collapse"
        elif key.startswith("classify d="):
            key = "classify levels"
        out[key] = out.get(key, 0.0) + ms
    return out


def _measure_sliced(label, name, args, kwargs, tape_copy=False):
    """One captured call of K1, K3 or K4: the kernel over every instance
    against its plain version on the first PLAIN_INSTANCES (max abs err
    0: NaN where plain is NaN, else equal; choice words exact), its
    CUDA-event time, the plain version's time on those instances, and
    the bound; with `tape_copy`, the time of copying instance 0's tape
    over all instances, as `BulkEvaluator` does."""
    fn, plain = _kernel_pairs()[name]
    args = tuple(a.detach() for a in args)
    T = args[0].shape[0]
    n = min(PLAIN_INSTANCES, T)
    got = fn(*args, **kwargs)
    want, plain_ms = _time_plain(plain, tuple(a[:n] for a in args), kwargs)
    head = [g[:n] for g in got] if name == "interp_interval" else [got[:n]]
    want = list(want) if name == "interp_interval" else [want]
    for g, w in zip(head, want):
        if g.dtype == torch.int32:
            if not torch.equal(g, w):
                raise Failed(f"{label}: choice words differ from plain")
        else:
            check(f"{label} (first {n} instances)", g, w, 0.0, 0.0)
    ms = time_cuda(lambda: fn(*args, **kwargs), reps=20)
    bound_ms, bound_by, slot_ms = _bound(name, args, kwargs, got)
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, plain_instances=n,
               instances=T, bound_ms=bound_ms, bound_by=bound_by,
               slot_bound_ms=slot_ms)
    copy = ""
    if tape_copy:
        w1, w2, imm = (a[:1] for a in args[:3])
        row["tape_copy_ms"] = time_cuda(
            lambda: [a.expand(T, a.shape[1]).contiguous() for a in (w1, w2, imm)],
            reps=20)
        copy = f"; tape copy over {T} instances {row['tape_copy_ms']:.4f} ms"
    log(f"kernel {label}: inputs {tuple(args[4].shape)}, nf {kwargs['nf']}, "
        f"op_order {'set' if kwargs.get('op_order') else 'none'}; bit-equal "
        f"to plain on {n} of {T} instances; {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms on {n} instances, bound {bound_ms:.5f} ms "
        f"({bound_by}), scheduler-slot bound {slot_ms:.5f} ms{copy}")
    return row


def phase_mesh(port, cuda, rows, depth=MESH_DEPTH, dev="cuda"):
    """`build_mesh` at depth 8 (collapse on) on the 3,303-op sphere union
    and the gyroid sphere, inside the cube by MESH_VIEW, launch counts
    set to 0 before the two builds and read after; each mesh held by
    `check_mesh`. A depth-5 sphere mesh built on the card equal to the
    same build on the CPU (triangles equal, vertices within 1e-5). Warm
    builds timed, stage by stage (`_StageClock`, synchronized at each
    stage's end). K1, K3 and K4 on the inputs the depth-8 builds gave
    them: kernel against plain version (max abs err 0; signs, choices
    exact), time and bound, kept in `rows` under `at_mesh_union` /
    `at_mesh_gyroid`; and the cost of the tape copies."""
    from fidget_tpu_torch import mesh as mesh_mod
    from fidget_tpu_torch.eval import bulk
    from fidget_tpu_torch.mesh import collapse

    dev = torch.device(dev)
    settings = port.MeshSettings(depth=depth, world_to_model=MESH_VIEW,
                                 device=dev)
    scenes = _mesh_scenes(port)
    captured = {}
    for tag, label, scene in scenes:  # warm-up; its inputs feed the rows
        targets = [(bulk, n, lambda a, k, n=n, tag=tag: f"{n}@{tag}")
                   for n in KERNELS_MESH]
        with capture_kernel_inputs(targets, captured):
            port.build_mesh(scene, settings)
    torch.cuda.synchronize()
    cuda.reset_launches()
    meshes, boxes = [], []
    for _, label, scene in scenes:
        with _cell_boxes(collapse, boxes):
            meshes.append(port.build_mesh(scene, settings))
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"mesh path launches over {len(scenes)} depth-{depth} builds: "
        f"{launches}")
    missing = [k for k in KERNELS_MESH if launches[k] == 0]
    if missing:
        raise Failed(f"mesh path never launched {missing}")
    for (_, label, scene), m, bx in zip(scenes, meshes, boxes):
        tape = scene.tape() if isinstance(scene, port.Shape) else scene
        ev = mesh_mod._get_evaluator(tape, dev)
        check_mesh(label, m, ev, bx, MESH_VIEW)

    ctx = port.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    sphere = port.lower(ctx, [ctx.sub(ctx.sqrt(ctx.add(
        ctx.square(x), ctx.add(ctx.square(y), ctx.square(z)))), 0.6)])
    got = port.build_mesh(sphere, port.MeshSettings(depth=MESH_DEPTH_CPU,
                                                    device=dev))
    want = port.build_mesh(sphere, port.MeshSettings(depth=MESH_DEPTH_CPU,
                                                     device="cpu"))
    if not (np.array_equal(got.triangles, want.triangles)
            and np.allclose(got.vertices, want.vertices, rtol=0, atol=1e-5)):
        raise Failed("the depth-5 sphere mesh on the card differs from the CPU's")
    log(f"depth-{MESH_DEPTH_CPU} sphere: card mesh equals the CPU's "
        f"({len(got.triangles)} triangles, max vertex difference "
        f"{np.abs(got.vertices - want.vertices).max():.3g})")

    for _, label, scene in scenes:
        totals, stages = [], []
        for _ in range(MESH_REPS):
            clock = mesh_mod._StageClock(True, dev, echo=False)
            t0 = time.perf_counter()
            port.build_mesh(scene, settings, clock=clock)
            torch.cuda.synchronize()
            totals.append((time.perf_counter() - t0) * 1e3)
            stages.append(_stage_table(clock.stages))
        k = int(np.argsort(totals)[len(totals) // 2])
        log(f"mesh build, {label}, depth {depth}: warm median "
            f"{float(np.median(totals)):.1f} ms, min {min(totals):.1f} ms over "
            f"{MESH_REPS} builds (host clock); stages of the median build "
            f"(ms): " + ", ".join(f"{s} {ms:.1f}" for s, ms in stages[k].items()))
        _log_busy(f"{label} build", _device_busy(
            lambda: port.build_mesh(scene, settings), 1), float(np.median(totals)))

    for key in sorted(captured):
        name, tag = key.split("@")
        args, kwargs = captured[key]
        rows[name][f"at_mesh_{tag}"] = dict(
            launches=launches[name],
            **_measure_sliced(f"{name} at the {tag} mesh's bulk shape",
                              name, args, kwargs, tape_copy=True))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import fidget_tpu_torch as port
    from fidget_tpu_torch.eval import cuda, simplify_device
    from fidget_tpu_torch.render import render2d, render3d
    from fidget_tpu_torch.scenes import standin_shape

    dev = torch.device("cuda")
    smi = phase_device()
    phase_build(cuda)
    phase_op_matrix(port, dev)

    ctx = port.Context()
    tape = port.lower(ctx, [standin_shape(ctx)])
    if (len(tape), tape.reg_count, tape.choice_count) != (7203, 13, 1066):
        raise Failed(f"stand-in lowered to {len(tape)} ops, "
                     f"{tape.reg_count} registers, {tape.choice_count} choices")
    r = port.PixelRenderer(tape, port.ImageSize(SIZE, SIZE))
    log(f"main path: {len(tape)}-op tape, {tape.reg_count} registers, "
        f"{tape.choice_count} choices; buckets Lcap {r.Lcap_b}, nf "
        f"{r.nf_b}, cw {r.cw_b}; {SIZE}^2 in {r.n0} tiles of {r.T0} px")
    captured = {}
    targets = [(render2d, n, lambda a, k, n=n: n) for n in KERNELS_2D]
    with capture_kernel_inputs(targets, captured):
        r.render(FRAMES[0])  # warm-up; its inputs feed the kernel phase
    torch.cuda.synchronize()

    cuda.reset_launches()
    images = [r.render(view) for view in FRAMES]
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"main path launches over {len(FRAMES)} frames: {launches}")
    missing = [k for k in KERNELS_2D if launches[k] == 0]
    if missing:
        raise Failed(f"main path never launched {missing}")
    brutes = []
    for k, (img, view) in enumerate(zip(images, FRAMES)):
        t0 = time.time()
        brutes.append(r.render_brute(view))
        ink, evaluated = check_frame(r, img, view, brutes[k])
        log(f"frame {k}: occupancy equals render_brute ({ink:.4f} inside, "
            f"{evaluated:.3f} of pixels evaluated; brute "
            f"{time.time() - t0:.1f} s)")

    rows = phase_kernels(captured, launches, len(FRAMES), r.n0)
    log("standard frame stages:")
    phase_stages(r, FRAMES[1])
    rows["interp_float_coded"] = phase_coded(r, images, brutes, cuda, render2d)
    per_shape = phase_per_shape(port, tape, images, brutes, cuda, render2d,
                                simplify_device, rows)
    phase_compare_frames(r, per_shape, FRAMES[1])

    r3, captured3, launches3, n3 = phase_main3d(
        port, cuda, render3d, render2d, simplify_device
    )
    phase_union3d(port, cuda)
    phase_kernels3d(r3, captured3, launches3, n3, rows)
    phase_stages3d(r3, VIEWS3[1][1])

    phase_grad(port, cuda, rows)
    phase_mesh(port, cuda, rows)

    log(smi)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
