#!/usr/bin/env python3
"""Bring-up check of fidget_tpu_torch on one CUDA card.

Builds the three CUDA kernels of the 2D MPR frame from the sources in
fidget_tpu_torch/csrc, holds each against its plain PyTorch version on
the card, drives the port's main path (`PixelRenderer.render()` at
1024^2 on a 7,203-op procedural shape) and holds every frame against
the numpy oracle `render_brute`. Run from the root of the repository:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device: the card's name and power limit (nvidia-smi);
2. build: one nvcc per kernel source, all started together;
3. op matrix: every unary and binary op over special values (NaN,
   +-inf, +-0, pi multiples, halves, integers past 2^23) in float mode through interp_float (K3)
   and interval mode through interp_interval (K1), then the liveness
   pass (K2) over the captured choices, each against its plain version
   at rtol = atol = 2e-5 (2e-4 for EXP and LN; bit-equal for the ops
   IEEE rounds correctly), choices and codes exact; once with the shared-memory register file and once with a
   register file too large for it (global scratch);
4. main path: a few frames through `PixelRenderer.render()` under
   different pans, with the launch counts set to 0 just before and
   read just after; each frame's occupancy must equal `render_brute`,
   distances allclose (rtol 1e-5, atol 1e-6) where evaluated, fills
   conservative;
5. one phase per kernel on the inputs the main path gave it
   (L = 8192, nf = 64, CW = 128; S0 = 8 for K1/K2, 128 for K3): kernel
   against plain version, CUDA-event times, and the bound;
6. per-stage times of warm frames (CUDA events).

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
}


class Failed(Exception):
    pass


def log(*args):
    print(*args, flush=True)


def standin_shape(ctx, n=800, seed=0):
    """Seeded procedural stand-in of prospero's size: n circles (radii
    0.01-0.06, centres in [-1, 1]), every third clipped to a horizontal
    band by a `max`, reduced by a balanced tree of `min`s. Lowered:
    7,203 ops, 13 registers, 1,066 choices."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, size=(n, 2))
    r = rng.uniform(0.01, 0.06, size=n)
    x, y = ctx.x(), ctx.y()
    parts = []
    for i in range(n):
        dx = ctx.sub(x, float(c[i, 0]))
        dy = ctx.sub(y, float(c[i, 1]))
        d = ctx.sub(
            ctx.sqrt(ctx.add(ctx.square(dx), ctx.square(dy))), float(r[i])
        )
        if i % 3 == 0:
            d = ctx.max(d, ctx.sub(ctx.abs(dy), float(r[i]) * 0.5))
        parts.append(d)
    while len(parts) > 1:
        nxt = [ctx.min(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


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
    errs = {}
    for nf in (packed.nf, 256):  # shared-memory file, then global scratch
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
    torch.cuda.synchronize()
    log(f"op matrix: {T} tapes x {ns * ns} value pairs agree in float and "
        f"interval mode, choices and codes exact; max abs err "
        + ", ".join(f"{k[0]}@nf{k[1]}={v:.3g}" for k, v in errs.items()))


@contextlib.contextmanager
def capture_kernel_inputs(render2d, store):
    """Records the arguments of the first call of each kernel wrapper
    that the frame makes (the wrappers themselves run unchanged)."""
    names = ("interp_interval", "liveness_codes", "interp_float")
    saved = {n: getattr(render2d, n) for n in names}

    def wrap(name, fn):
        def recorder(*args, **kwargs):
            store.setdefault(name, (args, kwargs))
            return fn(*args, **kwargs)
        return recorder

    for n in names:
        setattr(render2d, n, wrap(n, saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(render2d, n, fn)


def check_frame(r, img, view):
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
    if not ((brute[fill == FILL_INSIDE] < 0).all()
            and (brute[fill == FILL_OUTSIDE] > 0).all()):
        raise Failed("a fill is not conservative")
    occ = img.inside().cpu().numpy()
    if not np.array_equal(occ, brute < 0):
        raise Failed(f"occupancy differs at {(occ != (brute < 0)).sum()} px")
    return float(occ.mean()), float(ev.mean())


def _bound(name, args, out):
    """(bound_ms, bound_by): the larger of the bytes the call must move
    over HBM bandwidth and the operations it does over the float32
    rate, from this call's inputs. A tape step counts one operation per
    lane per value plane (float: 1, interval: 2, liveness: 1); tape
    words count only up to each instance's length."""
    lens = args[2] if name == "liveness_codes" else args[3]
    steps = int(lens.clamp(min=0).sum())
    if name == "interp_interval":
        lo, hi = args[4:6]
        nbytes = 12 * steps + lo.nbytes + hi.nbytes + sum(o.nbytes for o in out)
        ops = 2 * steps * lo.shape[2] * 128
    elif name == "liveness_codes":
        w1, ch = args[0], args[3]
        B, _, s0, _ = ch.shape
        reps = B if w1.shape[0] == 1 else 1
        nbytes = 8 * steps + ch.nbytes + out.nbytes
        ops = steps * reps * s0 * 128
    else:
        vars_ = args[4]
        lanes = vars_.shape[2] * 128
        nbytes = 12 * steps + vars_.nbytes + out.nbytes
        ops = steps * lanes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    log(f"  {name}: {steps} tape steps over {lens.numel()} tapes, "
        f"{nbytes} bytes, {ops} operations")
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(captured, launches):
    from fidget_tpu_torch.eval import interp, simplify_device

    kernels = {
        "interp_interval": (interp.interp_interval, interp.interp_interval_plain),
        "liveness_codes": (
            simplify_device.liveness_codes,
            simplify_device.liveness_codes_plain,
        ),
        "interp_float": (interp.interp_float, interp.interp_float_plain),
    }
    rows = []
    for name, (fn, plain) in kernels.items():
        args, kwargs = captured[name]
        got = fn(*args, **kwargs)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        want = plain(*args, **kwargs)
        t1.record()
        torch.cuda.synchronize()
        plain_ms = t0.elapsed_time(t1)
        if name == "interp_interval":
            err = max(check(f"{name} {p}", g, w, 2e-5, 2e-5)
                      for p, g, w in zip(("lo", "hi"), got[:2], want[:2]))
            if not torch.equal(got[2], want[2]):
                raise Failed("interp_interval choices differ from plain")
        elif name == "liveness_codes":
            if not torch.equal(got, want):
                raise Failed("liveness codes differ from plain")
            err = 0.0
        else:
            err = check(name, got, want, 2e-5, 2e-5)
        ms = time_cuda(lambda: fn(*args, **kwargs), reps=20)
        bound_ms, bound_by = _bound(name, args, got)
        log(f"kernel {name}: {kwargs}, instances {args[0].shape[0]}, "
            f"max abs err {err:.3g}, {ms:.4f} ms, plain {plain_ms:.1f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by})")
        src, replaces = KERNEL_INFO[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "launches_per_frame": launches[name] / len(FRAMES),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    return rows


def phase_stages(r, view, reps=10):
    """Where a warm frame's time goes: `render()` wall time on the host
    clock; per-stage times from CUDA events recorded as each stage of
    `_frame_core` is enqueued (a stage that waits on the host to
    enqueue its work shows that wait too); and the device's busy time
    per frame from the profiler, summed over every kernel."""
    names = ["root", "codes", "reconstruct", "leaf", "assemble"]
    sums = dict.fromkeys(names, 0.0)
    wall = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(view)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    mat, vec = r._mat4(view), r._var_vec(None)
    for _ in range(reps):
        events = {}

        def hook(stage):
            events[stage] = torch.cuda.Event(enable_timing=True)
            events[stage].record()

        torch.cuda.synchronize()
        hook("start")
        r._frame(mat, 0.0, vec, stage_hook=hook)
        torch.cuda.synchronize()
        prev = "start"
        for n in names:
            sums[n] += events[prev].elapsed_time(events[n])
            prev = n
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
            r.render(view)
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
        f"ms wall under the profiler ({100 * busy / prof_wall:.1f}% busy); "
        f"{sum(e.count for e in events) / reps:.0f} device ops per frame")
    for e in events[:8]:
        log(f"  {e.self_device_time_total / 1e3 / reps:8.3f} ms/frame "
            f"{e.count / reps:5.0f}x  {e.key[:70]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import fidget_tpu_torch as port
    from fidget_tpu_torch.eval import cuda
    from fidget_tpu_torch.render import render2d

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
    with capture_kernel_inputs(render2d, captured):
        r.render(FRAMES[0])  # warm-up; its inputs feed the kernel phase
    torch.cuda.synchronize()

    cuda.reset_launches()
    images = [r.render(view) for view in FRAMES]
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"main path launches over {len(FRAMES)} frames: {launches}")
    missing = [k for k in cuda.KERNELS if launches[k] == 0]
    if missing:
        raise Failed(f"main path never launched {missing}")
    for k, (img, view) in enumerate(zip(images, FRAMES)):
        t0 = time.time()
        ink, evaluated = check_frame(r, img, view)
        log(f"frame {k}: occupancy equals render_brute ({ink:.4f} inside, "
            f"{evaluated:.3f} of pixels evaluated; brute "
            f"{time.time() - t0:.1f} s)")

    rows = phase_kernels(captured, launches)
    phase_stages(r, FRAMES[1])

    log(smi)
    print(json.dumps({"kernels": rows}), flush=True)
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
