"""What one launch and one CTA cost on the card: the port of the Pallas
probe demos/exp_grid_overhead.py (P3), which timed the fixed cost of a
TPU grid step.

`grid_step(x, G)` (csrc/grid_step.cu) runs a minimal kernel over
x [T, 8, 128] f32: T / G CTAs, one [G, 8, 128] block each, every
element going through v = v * 1.0001 + 0.5 eight times. `many` is the
reference's driver: K = 64 calls on x scaled by 1 + 1e-7 k, summing one
element of each. It is timed twice for T in {1024, 4096, 16384} and G
in {1, 4, 16}: captured in one CUDA graph (the counterpart of the
reference's one `jax.jit(many)` dispatch), and launched eagerly, as the
port's frames launch their kernels. The slope of ms per call against
the CTA count T / G is the cost of a CTA; the intercept is what a call
costs whatever its size (the kernel's launch and the two glue ops').

Run on a CUDA card from the repository root:

    python -m fidget_tpu_torch.demos.exp_grid_overhead
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..eval import cuda

#: the body: REPS times v = v * SCALE + SHIFT, in f32
REPS = 8
SCALE = float(np.float32(1.0001))
SHIFT = 0.5
#: the reference's calls per dispatch and its sizes
K_CALLS = 64
TS = (1024, 4096, 16384)
GS = (1, 4, 16)


def _check(x, G):
    if x.dim() != 3 or x.shape[1:] != (8, 128) or x.dtype != torch.float32:
        raise ValueError("x must be float32 [T, 8, 128]")
    if G <= 0 or x.shape[0] % G:
        raise ValueError(f"G={G} must divide T={x.shape[0]}")


def grid_step(x, G):
    """One launch of the probe's kernel: T / G CTAs of G [8, 128] tiles,
    REPS times v * SCALE + SHIFT on every element, each product and sum
    rounded to f32. On CUDA tensors it launches csrc/grid_step.cu; on
    CPU tensors it runs `grid_step_plain`."""
    _check(x, G)
    if x.device.type == "cpu":
        return grid_step_plain(x, G)
    cuda.check_cuda(x)
    y = torch.empty_like(x)
    cuda.launch("grid_step", x, y, x.shape[0], G)
    return y


def grid_step_plain(x, G):
    """Plain PyTorch version of `grid_step` (G only splits the work)."""
    _check(x, G)
    v = x
    for _ in range(REPS):
        v = v * SCALE + SHIFT
    return v


def step_scale(k):
    """The reference's 1 + 1e-7 k, formed in f32."""
    return float(np.float32(1.0) + np.float32(1e-7) * np.float32(k))


def many(x, K, G):
    """The reference's driver: acc += grid_step(x * (1 + 1e-7 k))[0, 0, 0]
    for k in 0..K-1, in f32; three launches a call (the scaling, the
    kernel, the sum)."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for k in range(K):
        acc = acc + grid_step(x * step_scale(k), G)[0, 0, 0]
    return acc


def capture(x, K, G):
    """`many` over a static copy of x captured in one CUDA graph, after
    a warm run on a side stream; returns (graph, static x, static acc)."""
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        many(static_x, K, G)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        acc = many(static_x, K, G)
    return graph, static_x, acc


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_eager(x, K, G, reps=3):
    """The fastest of `reps` eager runs of `many`, in ms per call, host
    clock to the value of acc on the host (the reference's timing); the
    input is perturbed per run, as the reference perturbs it."""
    float(many(x, K, G))
    best = float("inf")
    for i in range(reps):
        xi = x * (1.0 + 1e-6 * (i + 1))
        _sync(x.device)
        t0 = time.perf_counter()
        float(many(xi, K, G))
        best = min(best, (time.perf_counter() - t0) / K)
    return best * 1e3


def time_graph(x, K, G, reps=3):
    """The same with `many` replayed from one CUDA graph; also returns
    the graph's acc on x, for a check against the eager one."""
    graph, static_x, acc = capture(x, K, G)
    graph.replay()
    acc_x = float(acc)
    best = float("inf")
    for i in range(reps):
        static_x.copy_(x * (1.0 + 1e-6 * (i + 1)))
        _sync(x.device)
        t0 = time.perf_counter()
        graph.replay()
        float(acc)
        best = min(best, (time.perf_counter() - t0) / K)
    return best * 1e3, acc_x


def fit(rows):
    """Least-squares lines through (CTAs, ms per call): `slope_us` the
    cost of one more CTA, `intercept_us` that of a call; and a second
    fit that also takes the tiles T as a term, since the glue's bytes
    grow with T and not with T / G (`per_cta_us`, `per_tile_us`,
    `per_call_us`)."""
    ctas = np.array([r["ctas"] for r in rows], np.float64)
    tiles = np.array([r["T"] for r in rows], np.float64)
    ms = np.array([r["ms"] for r in rows], np.float64)
    slope, icpt = np.polyfit(ctas, ms, 1)
    coef = np.linalg.lstsq(np.stack([np.ones_like(ctas), ctas, tiles], 1),
                           ms, rcond=None)[0]
    return {"slope_us": slope * 1e3, "intercept_us": icpt * 1e3,
            "per_call_us": coef[0] * 1e3, "per_cta_us": coef[1] * 1e3,
            "per_tile_us": coef[2] * 1e3}


def main(device=None, Ts=TS, Gs=GS, K=K_CALLS, reps=3):
    """Prints the reference's line per (T, G), first with `many` in one
    CUDA graph and then launched eagerly (eagerly only on the CPU), and
    each mode's fit. Returns {"graph": rows, "eager": rows,
    "fit": {mode: fit}, "acc": {(T, G): (graph acc, eager acc)}}, a row
    being {"T", "G", "ctas", "ms", "us_per_step"}."""
    dev = cuda.resolve_device(device)
    modes = ("graph", "eager") if dev.type == "cuda" else ("eager",)
    res = {"graph": [], "eager": [], "fit": {}, "acc": {}}
    for mode in modes:
        print(f"{mode}: many() of K={K} calls "
              + ("in one CUDA graph" if mode == "graph" else "launched eagerly"),
              flush=True)
        for T in Ts:
            for G in Gs:
                x = torch.ones((T, 8, 128), dtype=torch.float32, device=dev)
                if mode == "graph":
                    ms, acc = time_graph(x, K, G, reps)
                    res["acc"][(T, G)] = (acc, float(many(x, K, G)))
                else:
                    ms = time_eager(x, K, G, reps)
                ctas = T // G
                row = {"T": T, "G": G, "ctas": ctas, "ms": ms,
                       "us_per_step": ms / ctas * 1e3}
                res[mode].append(row)
                print(f"T={T:6d} G={G:3d}: {ms:7.4f} ms/call "
                      f"= {row['us_per_step']:7.4f} us/grid-step", flush=True)
        if len(res[mode]) > 2:
            f = res["fit"][mode] = fit(res[mode])
            print(f"{mode}: ms/call against CTAs: {f['slope_us']:.5f} us a "
                  f"CTA, {f['intercept_us']:.3f} us a call; with T as a "
                  f"term: {f['per_cta_us']:.5f} us a CTA, "
                  f"{f['per_tile_us']:.5f} us a tile, {f['per_call_us']:.3f} "
                  f"us a call", flush=True)
    return res


if __name__ == "__main__":
    main()
