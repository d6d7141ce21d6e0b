#!/usr/bin/env python3
"""Bring-up check of fidget_tpu_torch on one CUDA card.

Builds the eight CUDA kernels of the port from the sources in
fidget_tpu_torch/csrc and the six it generates per tape (from
csrc/unrolled.cuh), holds each against its plain PyTorch version on
the card, and drives the port's main paths: the 2D frame
(`PixelRenderer.render()` at 1024^2 on a 7,203-op procedural shape)
under each of its tape bindings (bucketed, coded leaf, per-shape
arena, two tile levels) and the 3D heightmap + normals renderer
(`VoxelRenderer.render()` at 512^3 on the 28-op gyroid sphere, and at
128^3 on a 3,303-op union of 300 spheres) under its bucketed, per-shape
and compiled frames (the last on two more kernels generated per tape,
U1-3D `unrolled_voxel_fold` and U2-3D `unrolled_proofs3`), holding
every frame against the numpy oracles; the per-shape compiled 2D path
(`render_unrolled` with the union and the full leaf, `render_dense`)
on the two kernels generated for the stand-in (U1 `unrolled_float`,
U2 `unrolled_interval`); then the shape-parameter gradient of the 2D
frames and the mesher (`build_mesh` at depth 8 on the sphere union and the
gyroid sphere), on `BulkEvaluator`, and again on the compiled mesher
(`eval="unrolled"`: more kernels generated per tape, U1-P's sign
table entries `leaf_masks` and `merge_topo` and its edge search
`unrolled_edges`, U2-B `level_active`, and K4); last the
ports of the Pallas probes
P2 and P3, each through its own probe (`fidget_tpu_torch.demos`); and
last the application layer: the command line (`python -m
fidget_tpu_torch render2d | render3d | mesh`) on a `.vm` model through
the native tape compiler and a `.rhai` script through the script engine,
with the post-effects (denoise, SSAO, blur, shading) on the card; and
at the very end the least-squares solver and the sharded entry points
(`fidget_tpu_torch.parallel.sharding`) in a world of 1 under NCCL and
a world of 2 gloo ranks on the card. Run
from the root of the repository:

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
6c. unrolled build: the union plan of the stand-in at 1024^2 (8-px
   tiles, 256-px blocks, the first view) built on the host and timed;
   U1 of the full tape and of the plan's programs plus the full-tape
   fallback (one translation unit a program, linked with -rdc), U2
   with the two epilogues the frames launch (proofs, violation; one
   unit a warp's stream), and U1 of the parametrized stand-in, all
   nvcc processes started together: cold and cached build seconds per
   step, registers and spills (U2's capture epilogue, which no frame
   launches, is held to its plain version by phase 6e);
6d. unrolled frames: `render_unrolled(leaf="union")`, `leaf="full"`
   with `cull` unrolled and interp, and `render_dense` over the three
   views, launch counts set to 0 before each mode's frames and read
   after (U1 and U2, or K1 and U1, or U1 alone); each frame held to
   `render_brute` as in phase 4 and its occupancy equal to `render()`'s;
   the union frames' fallback share; warm frames (median and min ms,
   Mpix/s, device busy share, device ops a frame); then U1 and U2 on
   the inputs each mode gave them against their plain versions (U1 and
   U2's flags and words exactly), with CUDA-event
   and profiler device times, the bound, and the SASS instructions a
   row and lane by class (`cuobjdump -sass`) with the issue and MUFU
   floors they give;
6e. unrolled guard: U1 and U2 beyond the stand-in's seven opcodes, all
   built in one batch: U1 over one launch of one program per op (every
   unary op on x and on a var, every binary op, MIN / MAX / AND / OR
   included, register with register, with an immediate on either
   side), held exactly (at `_matrix_tolerance` for the transcendentals);
   U1 alone (one program) and U2 under all three epilogues on three tapes
   that feed every op into a choice row (the exact ops with DIV by an
   immediate 0 and by a denominator across 0; the transcendentals; the
   nan_div shape of tests/test_torch_cuda.py), U1 exactly but on the
   transcendental tape (2e-4), U2's flags, words and violation flags
   exactly, capture and violation also with the words in global memory
   (a tape past `SHARED_LIMIT`'s route); at two matrices (one overflowing to infinities) with the
   vars taking every SPICY value and three denormals; then the 3D
   variants on the combined tapes, built in the same batch: U1-3D's
   explicit entry over every 8^3 subtile of a 64^3 volume and its frame
   entry (`unrolled_voxel_fold`) on stratum worklists of that volume at
   subtiles 8 and 16 (fewer active subtiles than slots; more, on a slab
   with its first row at 32; none), both at every group of lanes a column
   (1-16, up to the subtile's edge); U2-3D's explicit entry over the
   subtiles' boxes at edges 8 and 32 and its frame entry
   (`unrolled_proofs3`) over the volume's roots of 32 and 16 with their
   subtiles of 8, at every layout the frames take (1 and 4 warps a
   group, `proofs3_warps`; the frame entries at every other var pair,
   which still take every value below), at a
   perspective matrix and one overflowing to infinities, the vars as
   before, U2-3D's proofs and U1-3D's depths and floors bit for bit (on
   the transcendental tape a depth column may differ only where the
   plain distance of the voxel in question is within 2e-4 of 0); and
   the mesher's kernels on the combined tapes, built in the
   same batch: U1-P under both epilogues over the guard's 256^2 points
   in model space (a [4, 16384] list with 12,000 live columns) and U2-B
   over its 8-px tiles' boxes (a [2, 512] list with 400), at its two
   matrices and vars, distances, signs and proofs bit for bit (dead
   lanes included; on the transcendental tape a sign may differ only
   where the plain distance is within 2e-4 of 0); U1-P's edge search
   over a random crossing list of a depth-7 lattice (4,096 slots, 3,000
   live) at 16 samples x 4 rounds, and at 5 x 3 and 40 x 2 at every
   fourth var pair, and U2-B on a level of random parents (2,048, 1,500
   live, a tenth of the keys -1), under an oblique world -> model
   matrix and the same scaled by 1e30, every output bit for bit (on the
   transcendental tape a slot's brackets may differ only where the
   plain search met a sample within 2e-4 of 0);
7. 3D main path, bucketed (`specialize=False`): the gyroid sphere at
   512^3 (tile 64, subtile 16)
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
9a. the per-shape 3D frame (`VoxelRenderer()`, the default): the same
   gyroid views and heightmap frame, launch counts set to 0 before and
   read after (K1, K2, K5, K4), each frame held to phase 7's oracles;
   the strata schedule adopted after the first frame and the slots it
   saves; K1 (root, subtiles), K2 (root codes, per instance), K5 and K4
   on the frames' inputs, all under the shape's op_order, against their
   plain versions;
9b. the compiled 3D frames: the gyroid with `leaf="unrolled"` under
   `proofs="interp"` (K1, K2, U1-3D's frame entry `unrolled_voxel_fold`,
   K4) and `"unrolled"` (U2-3D's frame entry `unrolled_proofs3` once a
   frame, U1-3D's a stratum, K4) over the same frames, and the sphere
   union at 128^3 with both unrolled (depth exactly `render_brute`'s),
   launch counts from 0 for each mode; every one of these frames equal,
   depth and normals bit for bit, to the same frame on the parent's glue
   (`_old_glue3d`: U2-3D's explicit entry on the roots and a launch a
   stratum, U1-3D's explicit entry and the fold in torch ops); the
   generated kernels' cold build (started with the
   run, beside the earlier phases) and cached build seconds; both frame
   entries and the explicit ones on the frames' inputs bit for bit
   against their plain versions, with CUDA-event and profiler device
   times, the bound and SASS floors; the bucketed, per-shape and compiled 512^3 frames in
   turns (wall time, device busy share, device ops a frame), the two
   union frames likewise; then a `warmup="interp"` first frame of a
   shape whose kernels are not built, which must come from the bucketed
   twin (K1, K2, K5, K4) and equal its oracle, and after the background
   build the compiled frame (U2-3D, U1-3D, K4);
10. gradient: the parametrized 7,207-op stand-in (`param_standin_shape`,
   two shape Vars, V = 4) at 1024^2, bucketed, pixel_perfect; loss
   sum(img^2) / N^2 reversed through `_frame` with backward() (K3
   primal, two K4 passes for the Jacobian, of 4 planes and 2), held to
   `torch.func.jacfwd` (rtol 1e-5, atol 1e-6) and to central
   differences (h = 1e-2; rtol 2e-2, atol 1e-3); without pixel_perfect,
   on the zoomed-out view, proven fills have a zero or NaN tangent
   (`torch.func.jvp`); forward and step times, the step's launches and
   device busy time, and K3 and K4 at each of its widths on the step's
   inputs against their plain versions; then the same loss through the
   dense frame (`_dense`) and the pixel_perfect unrolled frame
   (`_frame_unrolled`, K1 cull), whose leaf is U1 and whose Jacobian is
   one K4 launch of 3 planes (the two shape parameters), held to its
   plain version: reverse mode held to `_frame`'s gradient on the same
   tape and vector (rtol 1e-4; every pixel is
   evaluated in all three), exactly 0 at the axis entries, which the
   transform overwrites, and to `torch.func.jacfwd` (rtol 1e-5, atol
   1e-6) and central differences (h = 1e-2; rtol 2e-2, atol 1e-5);
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
   bound and the cost of copying the tape over the instances;
11b. mesh, unrolled: `build_mesh(Settings(eval="unrolled"))` at depth
   8, collapse on, on the same two scenes under the same view: the cold
   build of U1-P and U2-B (started with the run, after the compiled 3D
   build, so that the union's U1 program is not built twice) and a
   cached one; launch counts set to 0 before the two builds and read
   after (U1-P's leaf and merge entries and edge search, U2-B's levels
   and K4, and no K1 or K3); each mesh held as in phase 11 and equal,
   bit for bit, to the same build on the dense glue (U1-P "sign" at
   every (cell, corner) and (candidate, lattice point) pair with the
   corners, lattices and topology test in torch ops; the edge rounds of
   U1-P "sign", "distance" and K4 over all 12 x cs slots; U2-B over box
   planes formed in torch ops); the depth-5 sphere and a depth-5 gyroid sphere under an
   oblique rotation (0.7 rad about (1, 2, 3)) built on the card equal to
   the CPU's builds (triangles equal, vertices within 1e-5; a vertex
   past that only on a float64 witness: the CPU build with its
   transcendentals correctly rounded moves it, and the card lies within
   1e-5 + 4x that move); U1-P (the leaf entry and the first collapse
   round's merge entry, each from the sign table as the build left it:
   masks, topo and the table's keys, signs and counts, and the table's
   growths (`table_grow`) counted; its edge search; and its "sign"
   kernel at the leaf corners as the dense glue forms them), U2-B (levels, and the box-plane entry
   on the union's largest level) on the inputs a cached depth-8 build
   gave them, bit for bit against their plain versions, with CUDA-event
   and profiler times, the points evaluated against the points asked
   for, and the bound over the live lanes (the table entries' two ways:
   the points a pair and the distinct points evaluated), and
   K4 at the fine stage's gradient shape; warm builds (host clock,
   synchronized, stages by `_StageClock`; phase 11 times the interpreter's)
   and the device's busy share of a compiled build;
12. the interleave probe (P2, `demos/exp_interleave.py`): the
   two-stream kernel `interp_float2` against its plain version bit for
   bit on the reference's tapes at its shapes (128 instances of two
   streams, Lcap 1024, nf 32, S0 32), on INPUT-prefixed random tapes
   with full lens and with lens short of Lcap (the kernel walks Lcap
   rows either way), and on one tape per opcode 0-30, 31, 40 and 127
   with immediates, an aux past V and registers past nf, each at 4, 2
   and 1 lanes a thread; then the probe's `main()`, launch counts set
   to 0 before and read after (K3 for variant A, P2 for B); A, B and B
   at A's lanes a thread by CUDA events and profiler device time, B's
   bound and the plain version's time;
13. the grid-overhead probe (P3, `demos/exp_grid_overhead.py`): the
   kernel `grid_step` against its plain version bit for bit at T in
   {1024, 4096, 16384} and G in {1, 4, 16}; then the probe's `main()`,
   launch counts set to 0 before and read after: ms per call and us
   per grid step of its 64-call driver `many` in one CUDA graph and
   launched eagerly, the graph's sum equal to the eager one, each
   mode's fit of ms per call against CTAs; then the kernel alone at
   every (T, G) by CUDA events and profiler device time beside its
   byte bound;
14. the application layer: the stand-in written as `.vm`
   (`Context.export`) and the gyroid sphere as a `.rhai` script in a
   temporary directory, then `fidget_tpu_torch.cli.main` for `render2d`
   at 1024^2 (mono, `-N 3`), `render3d` at 512^3 (shaded with SSAO, `-N
   3`) and `mesh` at depth 8 (`-N 2`), each on its default `--eval`,
   launch counts set to 0 before and read after each (K1, K2, K3; K1,
   K2, K5, K4; K1, K3, K4); the 2D PNG decoded equal to the mono image
   of a direct `PixelRenderer.render` of the same loaded tape, and its
   occupancy to phase 4's `render_brute`; the 3D frame's depth equal to
   a direct `VoxelRenderer.render`'s, its PNG equal to the card's
   effects of that frame, and the effects on the card held to the same
   functions on the CPU on the CLI's own depth and normals (denoise and
   blur within 1e-6, SSAO equal on 99.9% of filled pixels and the rest
   by exactly 1/64, shading within 1 level on 99% and 4 everywhere); the
   STL's triangle count equal to a direct `build_mesh`'s and the
   command's mesh held by `check_mesh`; each command's wall time and
   best repeat, the effects' CUDA-event times and the device ops and
   busy share of one profiled denoise + shading with SSAO. The g++
   build of the tape compiler starts in a thread with the run.

15. the solver and the sharded entry points: `solve` on the card (the
   constraint demo's linkage and a chain of 128 points, 254 equations
   over 254 free variables) against the CPU solve (1e-4), its residuals
   within 1e-5 widened by two f32 spacings of the largest coordinate,
   K3 and K4 launches an LM iteration and ms a solve; then every entry
   point of `fidget_tpu_torch.parallel.sharding` at full width
   (`render_tiles_sharded` and `render_unrolled_sharded` on the stand-in
   at 1024^2 over the three views, `render_voxels_sharded` on the gyroid
   sphere at 512^3 with the interpreter leaf and with leaf and proofs
   unrolled, `render_sharded` and `fit_step` with both pipelines on the
   parametrized stand-in at 1024^2) in a world of 1 under NCCL, each
   result equal bit for bit to the single-device frame of its binding
   (normals within 1e-4) and the 2D occupancy to phase 4's
   `render_brute`, each call's ms beside the single-device frame's; and
   in a world of 2 gloo ranks sharing the card (spawned processes,
   killed at a timeout), each rank's results equal to the world of 1's
   and the post-cull deal even; every path's kernels launched in each
   world, a fit step's K4 once (unrolled) or twice (interp).

The last two lines of standard output are the `kernels` JSON line and
the device JSON line.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import importlib
import json
import math
import pathlib
import socket
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
#: host clock at the start of `main`; log lines carry the seconds since
START = None
#: warm frames a stage profile runs under the profiler: a frame's device
#: busy time varies little from frame to frame, while the profiler's
#: processing of a 3D frame's 9,000 device ops took about 5 s a frame
#: (H100 80GB HBM3 machine)
PROFILED_FRAMES = 3
#: shared-memory bytes one SM moves a clock (32 banks of 4 bytes), and
#: the bytes of one register-file row a lane in shared memory: two
#: operand loads and a store of 4 bytes; with the SM clock they give the
#: shared-memory floor of an interpreter whose file lies there
SMEM_BYTES_PER_SM_CLOCK = 128
SMEM_ROW_BYTES = 12

SIZE = 1024
#: world_to_model views of the main path's frames: identity, a small
#: pan, and a pan zoomed out far enough that the outer tiles are proven
#: empty (so the fill path runs on the card too)
FRAMES = [
    None,
    np.array([[1.0, 0.0, 0.013], [0.0, 1.0, -0.021], [0.0, 0.0, 1.0]]),
    np.array([[2.0, 0.0, -0.05], [0.0, 2.0, 0.07], [0.0, 0.0, 1.0]]),
]

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
    # the Pallas probes P2 and P3, driven by their own probes (phases 12-13)
    "interp_float2": (
        "fidget_tpu_torch/csrc/interleave.cu",
        "demos/exp_interleave.py:58",
    ),
    "grid_step": (
        "fidget_tpu_torch/csrc/grid_step.cu",
        "demos/exp_grid_overhead.py:29",
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
    if START is not None:
        args = (f"[{time.perf_counter() - START:6.1f} s]", *args)
    print(*args, flush=True)


def concurrently(fns):
    """The results of the callables `fns`, run in threads of their own:
    the numpy oracles, which release the interpreter lock in their array
    work, take one core each instead of running one after another."""
    with concurrent.futures.ThreadPoolExecutor(len(fns)) as pool:
        return [f.result() for f in [pool.submit(fn) for fn in fns]]


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
    for stem in sorted({s for s, _ in cuda.KERNELS.values() if s}):
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
    from fidget_tpu_torch.scenes import SPICY

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
    interval: 2, liveness: 1, grad: its dual's planes, 2 to 4; the voxel
    pass one per voxel plus one per voxel of a live instance for its
    depth epilogue). Tape words count up to each instance's length;
    per-lane inputs count only for instances that have a tape (length >
    0); inputs and outputs count only the `lanes` real lanes of an
    instance (the root and subtile passes pad theirs to a multiple of
    128; None: every lane is real), and the voxel pass's output only its
    sub^2 depth columns. The coded leaf is counted by `_bound_coded`."""
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
        ops = planes.shape[2] * steps * real
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
        row["geometry"] = _geometry(name, shape, kwargs)
    return row


def _geometry(name, shape, kwargs):
    """The launch geometry of a call whose per-lane inputs have `shape`
    (K4: of its dual's planes), logged."""
    from fidget_tpu_torch.eval import cuda

    cw = shape[1] if name == "liveness_codes" else kwargs.get("c_words", 0)
    tangents = shape[2] - 1 if name == "interp_grad" else 3
    g = cuda.launch_geometry(
        name, nf=kwargs["nf"], lanes=shape[-2] * 128, T=shape[0], cw=cw,
        sub=kwargs.get("sub", 0), tangents=tangents,
    )
    geometry = {
        "lanes_per_thread": g.r, "smem_bytes": g.smem, "blocks": g.blocks,
        "regs_shared": g.regs_shared, "choices_shared": g.choices_shared,
        "mask_words": g.mask_words,
    }
    log(f"  geometry: {geometry}")
    return geometry


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
    over `reps` calls, from the profiler; beside `time_cuda`, which also
    counts the host's enqueue where it is slower than the kernel. A
    session that records no device event for them is run again, up to
    three sessions (back-to-back sessions on the card have come back
    empty every other time); None when none records one."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if name in e.key and e.self_device_time_total > 0]
        count = sum(e.count for e in events)
        if count:
            return sum(e.self_device_time_total for e in events) / 1e3 / count
    return None


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
        kwo = {**kwargs, "op_order": order}
        got = fn(w1o, *args[1:], **kwo)
        want = plain(w1o, *args[1:], **kwo)
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
    stages that repeat are summed), both over `reps` frames; and the
    device's busy time per frame from the profiler over PROFILED_FRAMES,
    summed over every kernel."""
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

    n = PROFILED_FRAMES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            render()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3 / n
    # device-side entries only: a host op's entry repeats its kernels' time
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / n
    if busy == 0:
        log("profiler: no device time recorded; busy share not measured")
        return
    events.sort(key=lambda e: -e.self_device_time_total)
    log(f"profiler: device busy {busy:.3f} ms per frame of {prof_wall:.3f} "
        f"ms wall under the profiler ({100 * busy / prof_wall:.1f}% busy; "
        f"{100 * busy / float(np.median(wall)):.1f}% of the unprofiled "
        f"median); {sum(e.count for e in events) / n:.0f} device ops "
        f"per frame")
    for e in events[:8]:
        log(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/frame "
            f"{e.count / n:5.0f}x  {e.key[:70]}")


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
                           tile_size=64, sub_size=16, specialize=False)
    log(f"3D main path (bucketed): gyroid sphere, {len(tape)}-op tape; buckets Lcap "
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
    t0 = time.time()
    brutes = dict(zip([label for label, _ in VIEWS3], concurrently(
        [lambda v=view: r.render_brute(v).depth.numpy()
         for _, view in VIEWS3])))
    log(f"  oracles of {len(VIEWS3)} views in {time.time() - t0:.1f} s")
    for (label, view), img in zip(VIEWS3 + [("heightmap", VIEWS3[0][1])],
                                  images):
        key = label if label != "heightmap" else "identity"
        if label == "heightmap" and img.normal is not None:
            raise Failed("heightmap frame returned normals")
        check_frame3d(r, img, view, brutes[key], label)
    if not np.array_equal(images[-1].depth.cpu().numpy(),
                          images[0].depth.cpu().numpy()):
        raise Failed("heightmap and normals frames disagree on depth")
    return r, captured, launches, n_frames, brutes


def phase_union3d(port, cuda, reps=10):
    from fidget_tpu_torch.scenes import sphere_union_shape

    ctx = port.Context()
    tape = port.lower(ctx, [sphere_union_shape(ctx)])
    if (len(tape), tape.reg_count, tape.choice_count) != (3303, 13, 299):
        raise Failed(f"sphere union lowered to {len(tape)} ops, "
                     f"{tape.reg_count} registers, {tape.choice_count} choices")
    r = port.VoxelRenderer(tape, port.VoxelSize(128, 128, 128), tile_size=32,
                           sub_size=16, specialize=False)
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
    brute = r.render_brute().depth.numpy()
    check_frame3d(r, img, None, brute, "union", exact=True)
    log(f"  oracle {time.time() - t0:.1f} s")
    return r, brute


# ----------------------------------------------------------------------
# 3D per-shape and compiled frames

#: the frame entries of U1-3D and U2-3D, which the compiled 3D frames
#: launch, and their explicit entries (the same kernels; phase 6e, and
#: the parent's glue in `_old_glue3d`)
UNROLLED3_KERNELS = ("unrolled_voxel_fold", "unrolled_proofs3")
UNROLLED3_EXPLICIT = {"unrolled_voxel_fold": "unrolled_voxel_depth",
                      "unrolled_proofs3": "unrolled_interval3"}
#: the Pallas probe whose whole-tape code the generated kernels port
UNROLLED3_REPLACES = "demos/exp_unrolled_kernel.py:116"
#: the compiled 3D modes and the kernels each must launch
COMPILED3_MODES = {
    "unrolled leaf": (dict(leaf="unrolled"),
                      ("interp_interval", "liveness_codes",
                       "unrolled_voxel_fold", "interp_grad")),
    "unrolled leaf+proofs": (dict(leaf="unrolled", proofs="unrolled"),
                             ("unrolled_proofs3", "unrolled_voxel_fold",
                              "interp_grad")),
}


@contextlib.contextmanager
def _old_glue3d():
    """The compiled 3D frame with the parent's glue around the kernels:
    U2-3D's explicit entry on the roots, then on each stratum's subtiles
    (their corners formed in torch ops, nearest stratum first), and U1-3D's
    explicit entry on the decoded worklist with the candidates scattered
    back and folded in torch ops (`fold_candidates`)."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.render import render3d

    saved = (render3d.unrolled_proofs3, render3d.unrolled_voxel_fold)

    def proofs(kern, x0, y0, z0, params, ts, sub):
        rf, re_ = uc.unrolled_interval3(kern, x0, y0, z0, params, ts)
        sx0, sy0, sz0 = uc.subtile_corners(x0, y0, z0, ts, sub)
        nt, m = sx0.shape
        ntz = int(z0.max().item()) // ts + 1
        parts = {}
        for tz in range(ntz - 1, -1, -1):
            rows = slice(tz * (nt // ntz), (tz + 1) * (nt // ntz))
            parts[tz] = uc.unrolled_interval3(
                kern, sx0[rows].reshape(-1), sy0[rows].reshape(-1),
                sz0[rows].reshape(-1), params, sub)
        sf = torch.cat([parts[tz][0] for tz in range(ntz)]).reshape(nt, m)
        se = torch.cat([parts[tz][1] for tz in range(ntz)]).reshape(nt, m)
        return (torch.cat([rf[:, None], sf], 1),
                torch.cat([re_[:, None], se], 1))

    def fold(kern, order, count, z_lo, params, floor, *, sub, nl,
             y_base=0.0, group=None):
        ny2, nx2 = floor.shape[0] // sub, floor.shape[1] // sub
        valid, lz, gy, gx = uc.decode_worklist(order, count, ny2=ny2,
                                               nx2=nx2)
        bx, by, bz = uc.worklist_corners(lz, gy, gx, z_lo.reshape(()),
                                         sub=sub, y_base=y_base)
        dcand = uc.unrolled_voxel_depth(kern, bx, by, bz, valid, params,
                                        sub=sub, group=1)
        return floor.copy_(uc.fold_candidates(floor, dcand, order, valid,
                                              nl=nl))

    render3d.unrolled_proofs3, render3d.unrolled_voxel_fold = proofs, fold
    try:
        yield
    finally:
        render3d.unrolled_proofs3, render3d.unrolled_voxel_fold = saved


def start_compiled3d_build(port, union_tape):
    """The compiled 3D frames' renderers (the gyroid sphere at 512^3 in
    both compiled modes, the sphere union at 128^3 with both unrolled)
    and a future of their generated kernels' build, started in a thread
    of its own beside the phases before 7b: (renderers, future of
    (steps, seconds))."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.scenes import gyroid_sphere

    size = port.VoxelSize(SIZE3, SIZE3, SIZE3)
    renderers = {
        label: port.VoxelRenderer(gyroid_sphere(port), size, tile_size=64,
                                  sub_size=16, **kw)
        for label, (kw, _) in COMPILED3_MODES.items()
    }
    renderers["union"] = port.VoxelRenderer(
        union_tape, port.VoxelSize(128, 128, 128), tile_size=32, sub_size=16,
        leaf="unrolled", proofs="unrolled")
    kernels = {k.unit().key: k for r in renderers.values()
               for k in r._generated_kernels()}

    def build():
        t0 = time.perf_counter()
        steps = uc.build_kernels(list(kernels.values()))
        return steps, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(build)
    pool.shutdown(wait=False)
    return renderers, future


def _frames_by_turns(frames, rounds=10, busy_reps=1):
    """Warm frames of several renderers in turns (`rounds` times over, so
    that drift of the host's clock falls on all alike): host-clock wall
    time of a synchronized frame, median and min; then each frame's
    device busy time, share of the median and device ops from the
    profiler over `busy_reps` frames."""
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
    out = {}
    for label, fn in frames.items():
        med, mn = float(np.median(wall[label])), min(wall[label])
        log(f"  {label}: median {med:.3f} ms, min {mn:.3f} ms (host clock, "
            f"synchronized, {rounds} frames in turns)")
        busy = _device_busy(fn, busy_reps)
        _log_busy(label, busy, med)
        out[label] = {
            "median_ms": med, "min_ms": mn,
            "device_busy_ms": None if busy is None else busy[0],
            "busy_share": None if busy is None else busy[0] / med,
            "device_ops": None if busy is None else busy[2],
        }
    return out


def _log_schedule(r, label):
    nsub_s = r.nl * r.ny2 * r.nx2
    uniform = r.ntz * min(r.cap, nsub_s)
    if r._sched is None:
        log(f"  {label}: no strata schedule (uniform cap {r.cap}, "
            f"{uniform} slots a frame)")
        return None
    log(f"  {label}: strata schedule {list(r._sched)} (nearest first): "
        f"{sum(r._sched)} slots a frame against the uniform cap's "
        f"{uniform} ({uniform - sum(r._sched)} fewer)")
    return {"schedule": list(r._sched), "slots": sum(r._sched),
            "uniform_slots": uniform}


def phase_per_shape3d(port, cuda, render3d, simplify_device, brutes, rows):
    """The per-shape interpreter frame (`VoxelRenderer()`, specialize on)
    of the gyroid sphere at 512^3 (tile 64, subtile 16) over the three
    views and a heightmap frame, launch counts set to 0 before and read
    after (K1, K2, K5, K4); each frame held to `render_brute` (the
    bucketed phase's oracles) and `brute_normals` as in phase 7; the
    strata schedule adopted after the first frame; then K1 (root and
    subtiles), K2 (root codes and per instance), K5 and K4 against their
    plain versions on the inputs the frames gave them, under the
    shape's op_order. Returns the renderer."""
    from fidget_tpu_torch.scenes import gyroid_sphere

    r = port.VoxelRenderer(gyroid_sphere(port),
                           port.VoxelSize(SIZE3, SIZE3, SIZE3), tile_size=64,
                           sub_size=16)
    if not r.specialize:
        raise Failed("VoxelRenderer does not default to the per-shape frame")
    captured = {}
    targets = [
        (render3d, "interp_interval",
         lambda a, k: "interp_interval@" + ("root" if a[0].shape[0] == 1
                                            else "subtile")),
        (render3d, "interp_voxel_depth", lambda a, k: "interp_voxel_depth"),
        (render3d, "interp_grad", lambda a, k: "interp_grad"),
        (simplify_device, "liveness_codes",
         lambda a, k: "liveness_codes@" + ("root" if k.get("shared_tape")
                                           else "instances")),
    ]
    with capture_kernel_inputs(targets, captured):
        r.render(VIEWS3[0][1])  # settles the cap, builds the schedule
    torch.cuda.synchronize()
    log(f"3D per-shape frame: gyroid sphere, the tape's own arena ({len(r.tape)}"
        f" rows, nf {r.nf}, {r.c_words} choice word) under its op_order "
        f"{list(r.op_order[:8])}...; worklist {r.cap} slots")
    sched = _log_schedule(r, "after the first frame")
    if sched is None:
        raise Failed("the per-shape frame adopted no strata schedule")
    cuda.reset_launches()
    images = [r.render(view) for _, view in VIEWS3]
    images.append(r.render(VIEWS3[0][1], mode="heightmap"))
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"3D per-shape launches over {len(images)} frames: "
        f"{ {k: v for k, v in launches.items() if v} }")
    if {k for k, v in launches.items() if v} != set(KERNELS_3D):
        raise Failed(f"3D per-shape frames launched {launches}")
    for (label, view), img in zip(VIEWS3 + [("heightmap", VIEWS3[0][1])],
                                  images):
        key = label if label != "heightmap" else "identity"
        check_frame3d(r, img, view, brutes[key], f"per-shape {label}")
    real = {"root": r.geo.nt, "subtile": r.geo.m, "instances": r.geo.m}
    for key in sorted(captured):
        name, _, where = key.partition("@")
        args, kwargs = captured[key]
        if kwargs.get("op_order") != r.op_order:
            raise Failed(f"{key} ran without the shape's op_order")
        m = measure_kernel(name, args, kwargs, real.get(where))
        rows[name].setdefault("per_shape_3d", {})[where or "frame"] = {
            k: m[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "slot_bound_ms", "max_abs_err")
        }
    for name in KERNELS_3D:
        rows[name]["launches_per_shape_3d"] = launches[name]
    return r, sched


def _walked(uc, kern, bx, by, bz, valid, params, sub, group=1):
    """Voxels a column walk of U1-3D evaluates over live slots: down to
    the first voxel inside, or the whole column, rounded up to `group`
    voxels (from the depths of its explicit entry on the same slots)."""
    d = uc.unrolled_voxel_depth(kern, bx, by, bz, valid, params, sub=sub,
                                group=1).to(torch.int64)
    top = (bz.to(torch.int64) + sub)[:, None, None]
    walked = torch.where(d > 0, top - d + 1, sub)
    walked = -(-walked // group) * group
    return int((walked * valid[:, None, None]).sum())


def _explicit3(name, args, kwargs):
    """The explicit entry's calls on a captured frame entry's inputs:
    U1-3D on the decoded worklist (its corners as the parent's glue formed
    them), U2-3D on the roots and on the subtile boxes: {where: (args,
    kwargs)}."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    if name == "unrolled_voxel_fold":
        kern, order, count, z_lo, params, floor = args
        sub = kwargs["sub"]
        valid, lz, gy, gx = uc.decode_worklist(
            order, count, ny2=floor.shape[0] // sub, nx2=floor.shape[1] // sub)
        corners = uc.worklist_corners(lz, gy, gx, z_lo.reshape(()), sub=sub,
                                      y_base=kwargs.get("y_base", 0.0))
        return {"leaf": ((kern, *corners, valid, params), {"sub": sub})}
    kern, x0, y0, z0, params, ts, sub = args
    sx0, sy0, sz0 = (c.reshape(-1) for c in uc.subtile_corners(x0, y0, z0,
                                                                ts, sub))
    return {"roots": ((kern, x0, y0, z0, params, ts), {}),
            "subtiles": ((kern, sx0, sy0, sz0, params, sub), {})}


def _unrolled3_bound(name, args, kwargs, out):
    """(bound_ms, bound_by, operations, bytes, evaluations) of one U1-3D /
    U2-3D call. U1-3D: one operation per tape row per voxel this call's
    data needs a column to evaluate (from the top down to its first
    voxel inside, or all of it), moving the slots' corners and flags
    (explicit) or worklist entries (frame entry) once, the params and
    the depths; the evaluations are the voxels its groups of lanes
    evaluate (rounded up to the group a column). U2-3D: two (lo, hi) per
    row per box, moving the corners, the params and the two flags."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    kern = args[0]
    if name in ("unrolled_voxel_depth", "unrolled_voxel_fold"):
        if name == "unrolled_voxel_fold":
            (ex_args, ex_kw), = _explicit3(name, args, kwargs).values()
            _, bx, by, bz, valid, params = ex_args
            nbytes = int(valid.sum()) * (8 + 4 * kwargs["sub"] ** 2)
        else:
            _, bx, by, bz, valid, params = args
            nbytes = bx.shape[0] * 13 + out.nbytes
        sub = kwargs["sub"]
        G = kwargs.get("group") or uc.voxel_group(bx.shape[0], sub)
        ops = _walked(uc, kern, bx, by, bz, valid, params, sub) * len(
            kern.tapes[0])
        evals = _walked(uc, kern, bx, by, bz, valid, params, sub, G) * len(
            kern.tapes[0])
        nbytes += params.nbytes
    else:
        x0, params = args[1], args[4]
        n = x0.shape[0]
        boxes = n
        if name == "unrolled_proofs3":
            boxes = n * (1 + (args[5] // args[6]) ** 3)
        ops = 2 * boxes * len(kern.tape)
        nbytes = n * 12 + params.nbytes + 2 * boxes
        evals = ops // 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    by_ = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by_, ops, nbytes, evals


def _call3(name, args, kwargs):
    """A call of U1-3D / U2-3D that leaves the captured inputs as they
    were: the frame entry of U1-3D folds into a copy of the floor, made
    once (folding again into the result changes nothing)."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    fn = getattr(uc, name)
    if name in ("unrolled_voxel_fold", "unrolled_voxel_fold_plain"):
        floor = args[5].clone()
        return lambda: fn(*args[:5], floor, **kwargs)
    return lambda: fn(*args, **kwargs)


def _measure_unrolled3(label, name, args, kwargs):
    """One captured U1-3D / U2-3D call against its plain version on the
    card (depths, floors, proofs bit for bit), CUDA-event ms, profiler
    device ms, plain ms, the bound and the SASS floors."""
    got = _call3(name, args, kwargs)()
    want, plain_ms = _time_plain(_call3(name + "_plain", args, kwargs), (),
                                 {})
    same = (torch.equal(got, want) if isinstance(got, torch.Tensor)
            else all(torch.equal(g, w) for g, w in zip(got, want)))
    if not same:
        raise Failed(f"{name} ({label}) differs from its plain version")
    ms = time_cuda(_call3(name, args, kwargs), reps=20)
    kernel_name = ("fidget_unrolled_voxel_depth" if "voxel" in name
                   else "fidget_unrolled_interval")
    dms = device_ms(_call3(name, args, kwargs), kernel_name)
    bound_ms, by, ops, nbytes, evals = _unrolled3_bound(
        name, args, kwargs, got if name == "unrolled_voxel_depth" else None)
    floors = unrolled_floors(args[0], evals)
    fl = ("SASS not measured" if floors is None else
          f"{floors['sass_per_row']:.2f} SASS instructions a row and lane, "
          f"issue floor {floors['issue_floor_ms']:.5f} ms, MUFU floor "
          f"{floors['mufu_floor_ms']:.5f} ms")
    group = ""
    if "voxel" in name:
        from fidget_tpu_torch.eval import unrolled_cuda as uc

        G = kwargs.get("group") or uc.voxel_group(args[1].shape[0],
                                                  kwargs["sub"])
        group = f", group {G}"
    # the slots of the work the kernel does: U1-3D's evaluations rounded
    # up to its groups, U2-3D's two bounds a row and box
    slots = _slot_bound_ms(evals if "voxel" in name else ops)
    log(f"kernel {name} ({label}): {args[1].shape[0]} slots-or-roots"
        f"{group}, {ops} operations ({evals} row-lane evaluations), "
        f"{nbytes} bytes; equal to plain, {ms:.4f} ms (CUDA events), "
        f"device {dms} ms (profiler), plain {plain_ms:.1f} ms, bound "
        f"{bound_ms:.5f} ms ({by}), slots {slots:.5f} ms; {fl}")
    return dict(max_abs_err=0.0, ms=ms, device_ms=dms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, slot_bound_ms=slots,
                operations=ops, bytes=nbytes, evaluations=evals,
                **(floors or {}))


def phase_compiled3d(port, cuda, render3d, r_bucketed, r_per_shape, brutes,
                     union_bucketed, union_brute, compiled, rows):
    """The compiled 3D frames: the gyroid sphere at 512^3 with
    `leaf="unrolled"` under `proofs="interp"` and `"unrolled"` over the
    three views and a heightmap frame, and the 3,303-op sphere union at
    128^3 with both unrolled, each mode's launches counted from 0 (and
    exactly its kernels); depth held to `render_brute` (the union's
    exactly) and normals to `brute_normals`; cold and cached build
    seconds of the generated kernels (built beside the earlier phases,
    `start_compiled3d_build`); U1-3D and U2-3D against their plain
    versions on the inputs the frames gave them; the frames of every 3D
    mode by turns against the bucketed one (wall, busy share, device
    ops); then a `warmup="interp"` first frame served by the bucketed
    twin while a fresh shape's kernels build, and the compiled frame
    once they are built. Adds the U1-3D and U2-3D rows to `rows`."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.render import unrolled2d as u2
    from fidget_tpu_torch.scenes import gyroid_sphere

    renderers, future = compiled
    t0 = time.perf_counter()
    steps, build_s = future.result()
    wait_s = time.perf_counter() - t0
    kernels = [k for r in renderers.values() for k in r._generated_kernels()]
    t0 = time.perf_counter()
    again = uc.build_kernels(kernels)
    cached = time.perf_counter() - t0
    if again or not uc.built(kernels):
        raise Failed(f"compiled 3D kernels not cached after a build: {again}")
    log(f"compiled 3D build: {len(steps)} nvcc steps in {build_s:.1f} s cold "
        f"(started with the run; {wait_s:.1f} s waited here), cached "
        f"{cached:.3f} s")
    spills = {}
    for label, r in renderers.items():
        for k in r._generated_kernels():
            lines, spill = _ptxas_lines(k.unit())
            kind = type(k).__name__
            spills[f"{label} {kind}"] = spill
            log(f"  {label} {kind}: {len(k.unit().objects) + 1} unit(s), "
                f"spill bytes {spill}; " + " | ".join(lines[:3]))

    captured = {}
    saved = {n: getattr(render3d, n) for n in UNROLLED3_KERNELS}
    current = [None]

    def recorder(name):
        def call(*args, **kwargs):
            if current[0] is not None:
                if name == "unrolled_voxel_fold":
                    # the heaviest stratum; the floor as it came in
                    where, size = "leaf", int(args[2])
                    kept = (*args[:5], args[5].clone())
                else:
                    where, size = f"roots {int(args[5])}", args[1].shape[0]
                    kept = args
                key = (current[0], name, where)
                old = captured.get(key)
                if old is None or size > old[2]:
                    captured[key] = (kept, kwargs, size)
            return saved[name](*args, **kwargs)
        return call

    totals = dict.fromkeys([*UNROLLED3_KERNELS, *UNROLLED3_EXPLICIT.values()],
                           0)
    n_frames = 0
    schedules = {}
    new_images = {}
    for n in UNROLLED3_KERNELS:
        setattr(render3d, n, recorder(n))
    try:
        for label, (_, expect) in COMPILED3_MODES.items():
            r = renderers[label]
            current[0] = label
            r.render(VIEWS3[0][1])  # settles the cap, builds the schedule
            current[0] = None
            schedules[label] = _log_schedule(r, f"{label} after the first "
                                                f"frame")
            torch.cuda.synchronize()
            cuda.reset_launches()
            images = [r.render(view) for _, view in VIEWS3]
            images.append(r.render(VIEWS3[0][1], mode="heightmap"))
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
            log(f"compiled 3D {label}: launches over {len(images)} frames: "
                f"{launches}")
            if set(launches) != set(expect):
                raise Failed(f"compiled 3D {label} frames launched {launches}")
            for k in totals:
                totals[k] += launches.get(k, 0)
            n_frames += len(images)
            new_images[label] = images
            for (view_label, view), img in zip(
                    VIEWS3 + [("heightmap", VIEWS3[0][1])], images):
                key = view_label if view_label != "heightmap" else "identity"
                check_frame3d(r, img, view, brutes[key],
                              f"compiled {label} {view_label}")
        ru = renderers["union"]
        current[0] = "union"
        ru.render()
        current[0] = None
        torch.cuda.synchronize()
        cuda.reset_launches()
        img = ru.render()
        torch.cuda.synchronize()
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        if set(launches) != set(COMPILED3_MODES["unrolled leaf+proofs"][1]):
            raise Failed(f"compiled 3D union frame launched {launches}")
        for k in totals:
            totals[k] += launches.get(k, 0)
        n_frames += 1
        new_images["union"] = [img]
        log(f"compiled 3D union ({len(ru.tape)}-op tape, 128^3): launches "
            f"{launches}")
        check_frame3d(ru, img, None, union_brute, "compiled union", exact=True)
    finally:
        current[0] = None
        for n, f in saved.items():
            setattr(render3d, n, f)

    # the same frames on the parent's glue: bit for bit
    t0 = time.perf_counter()
    with _old_glue3d():
        for label, images in new_images.items():
            r = renderers[label]
            if label == "union":
                old = [r.render()]
                views = [("identity", None)]
            else:
                old = [r.render(view) for _, view in VIEWS3]
                old.append(r.render(VIEWS3[0][1], mode="heightmap"))
                views = VIEWS3 + [("heightmap", None)]
            for (view_label, _), a, b in zip(views, images, old):
                if not torch.equal(a.depth, b.depth) or (
                        a.normal is not None
                        and not torch.equal(a.normal, b.normal)):
                    raise Failed(f"compiled 3D {label} {view_label}: the "
                                 f"frame differs from the parent's glue's")
    torch.cuda.synchronize()
    log(f"compiled 3D frames equal to the same frames on the parent's glue "
        f"(U2-3D's explicit entry on the roots and a launch a stratum, "
        f"U1-3D's explicit entry, the fold in torch ops), depth and "
        f"normals bit for bit: {sum(map(len, new_images.values()))} "
        f"frames ({time.perf_counter() - t0:.1f} s)")

    measured = {}
    for (label, name, where), (args, kwargs, _) in sorted(
            captured.items(), key=lambda p: p[0]):
        measured[(label, name, where)] = _measure_unrolled3(
            f"{label}, {where}", name, args, kwargs)
        if label == "unrolled leaf":  # the same kernels as leaf+proofs
            continue
        for ex_where, (ex_args, ex_kw) in _explicit3(name, args,
                                                     kwargs).items():
            ex = UNROLLED3_EXPLICIT[name]
            measured[(label, ex, ex_where)] = _measure_unrolled3(
                f"{label}, {ex_where}, explicit entry", ex, ex_args, ex_kw)

    view = VIEWS3[1][1]
    log(f"3D frames in turns at the {VIEWS3[1][0]} view, 512^3 gyroid:")
    timing = _frames_by_turns({
        "bucketed": lambda: r_bucketed.render(view),
        "per-shape": lambda: r_per_shape.render(view),
        **{label: (lambda r=renderers[label]: r.render(view))
           for label in COMPILED3_MODES},
    })
    log("3D frames in turns, 128^3 sphere union:")
    timing_union = _frames_by_turns({
        "bucketed union": lambda: union_bucketed.render(),
        "compiled union": lambda: renderers["union"].render(),
    })

    # warmup="interp": a shape whose kernels no phase has built
    rw = port.VoxelRenderer(gyroid_sphere(port, scale=4.5),
                            port.VoxelSize(128, 128, 128), tile_size=32,
                            sub_size=16, leaf="unrolled", proofs="unrolled")
    kw = rw._generated_kernels()
    if uc.built(kw):
        raise Failed("the warm-up shape's kernels were built already")
    brute_w = rw.render_brute().depth.numpy()
    cuda.reset_launches()
    t0 = time.perf_counter()
    img = rw.render(warmup="interp")
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    first = {k for k, v in cuda.LAUNCHES.items() if v}
    if first != set(KERNELS_3D) or getattr(rw, "_twin", None) is None:
        raise Failed(f"the warm-up's first frame did not come from the "
                     f"bucketed twin: {first}")
    check_frame3d(rw, img, None, brute_w, "warm-up frame (bucketed twin)")
    while not u2.ready(rw, kw, "interp"):
        if time.perf_counter() - t0 > 600:
            raise Failed("the warm-up's background build did not finish")
        time.sleep(0.1)
    build_w = time.perf_counter() - t0
    cuda.reset_launches()
    img = rw.render(warmup="interp")
    torch.cuda.synchronize()
    then = {k for k, v in cuda.LAUNCHES.items() if v}
    if then != set(COMPILED3_MODES["unrolled leaf+proofs"][1]):
        raise Failed(f"after its build the warm-up frame launched {then}")
    check_frame3d(rw, img, None, brute_w, "warm-up frame (compiled)")
    log(f"warm-up: first frame from the bucketed twin in {first_ms:.1f} ms "
        f"while the kernels built ({build_w:.1f} s), then the compiled frame")

    heads = {"unrolled_voxel_fold": "leaf", "unrolled_proofs3": "roots 64",
             "unrolled_voxel_depth": "leaf", "unrolled_interval3": "subtiles"}
    for name, where in heads.items():
        head_key = ("unrolled leaf+proofs", name, where)
        rows[name] = {
            "name": name, "route": "cuda", "source": UNROLLED_SOURCE,
            "replaces": UNROLLED3_REPLACES, "launches": totals[name],
            "launches_per_frame": totals[name] / n_frames,
            **measured[head_key], "library_ms": None,
            "at": {", ".join(k[::2]): m for k, m in measured.items()
                   if k[1] == name and k != head_key},
        }
        if name in UNROLLED3_KERNELS:
            rows[name].update(
                build={"cold_s": build_s, "cached_s": cached,
                       "spill_bytes": spills},
                frames=timing, frames_union=timing_union,
                schedules=schedules)


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
#: warm builds timed per scene and eval mode
MESH_REPS = 2
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
    kernels to their plain versions on its inputs, K4 at each width the
    step takes: its Jacobian in the four inputs is a pass of 4 planes
    and one of 2."""
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
               (interp, "interp_grad", _k4_key)]
    with capture_kernel_inputs(targets, captured):
        step()  # warm-up; its inputs feed the kernel rows
    keys = ("interp_float", "interp_grad@P4", "interp_grad@P2")
    if sorted(captured) != sorted(keys):
        raise Failed(f"the gradient step called {sorted(captured)}, not "
                     f"{sorted(keys)}")
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
    for key in keys:
        name, _, planes = key.partition("@")
        args, kwargs = captured[key]
        row = {
            "launches": launches[name], "forward_ms": fwd_ms[0],
            "step_ms": step_ms[0], "step_device_busy_ms": busy,
            **_measure_sliced(f"{key} in the gradient step", name, args,
                              kwargs),
        }
        if planes:
            row["geometry"] = _geometry(name, tuple(args[4].shape), kwargs)
            rows[name].setdefault("at_gradient", {})[planes] = row
        else:
            rows[name]["at_gradient"] = row


def _k4_key(args, kwargs):
    """A K4 call's capture key: its dual's planes."""
    return f"interp_grad@P{args[4].shape[2]}"


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
        if kw.get("store") is not None:  # a device store: ids 4*cell+slot
            kw["store"].set_fine(cells, h)
        return real_walk(**kw)

    from fidget_tpu_torch.mesh import fused

    real_device = fused.DeviceVertexStore

    class BoxedDeviceStore(real_device):
        def set_fine(self, cells, h):
            ids = np.arange(4 * len(cells))
            self.lo = np.zeros((self.cap, 3))
            self.size = np.zeros(self.cap)
            self.lo[ids] = cells[ids // 4].astype(np.float64) * h - 1.0
            self.size[ids] = h

        def merge_round(self, member_vids, seg_member, pbase, ps):
            self.cand = (pbase, ps)
            return super().merge_round(member_vids, seg_member, pbase, ps)

        def commit(self, accept):
            pbase, ps = self.cand
            ids = super().commit(accept)
            if len(self.lo) < self.cap:
                grow = self.cap - len(self.lo)
                self.lo = np.concatenate([self.lo, np.zeros((grow, 3))])
                self.size = np.concatenate([self.size, np.zeros(grow)])
            self.lo[ids] = pbase[accept].astype(np.float64) * self.h - 1.0
            self.size[ids] = ps * self.h
            return ids

        def final_positions(self, ids):
            out = super().final_positions(ids)
            boxes.append((out.astype(np.float64), self.lo[ids],
                          self.size[ids]))
            return out

    collapse.HostVertexStore = BoxedStore
    collapse.collapse_and_walk = walk
    fused.DeviceVertexStore = BoxedDeviceStore
    try:
        yield
    finally:
        collapse.HostVertexStore = real_store
        collapse.collapse_and_walk = real_walk
        fused.DeviceVertexStore = real_device


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
            clock = mesh_mod._StageClock(True, dev)
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


#: kernels of the compiled mesher's path: U1-P (the sign table's leaf
#: and merge entries, the edge search), U2-B on the levels and K4, and no
#: interpreter kernel but K4
KERNELS_MESH_UNROLLED = ("leaf_masks", "merge_topo", "unrolled_edges",
                         "level_active", "interp_grad")
MESHER_KERNELS = ("leaf_masks", "merge_topo", "unrolled_edges",
                  "level_active")
#: the sign table's entries, and the kernels (profiler names) each
#: launches besides the evaluation pass `fidget_unrolled_table_eval`
TABLE_ENTRIES = {"leaf_masks": ("fidget_unrolled_leaf_",),
                 "merge_topo": ("fidget_unrolled_merge_",
                                "fidget_unrolled_table_grow")}
#: operations of the edge search besides the tape's rows: forming a
#: sample's model point (t: 3, the world point: 6, the matrix: 18), and
#: a round's bracket update a slot (about 10)
EDGE_POINT_OPS, EDGE_ROUND_OPS = 27, 10
#: operations of forming one child box in `level_active` (the world box:
#: 9, the model box's six sums of seven terms: 72)
LEVEL_BOX_OPS = 81
#: the oblique view of the card-against-CPU gyroid build: 0.7 rad about
#: (1, 2, 3), whose coefficients mix signs
OBLIQUE_AXIS, OBLIQUE_ANGLE = (1.0, 2.0, 3.0), 0.7


def _oblique():
    a = np.asarray(OBLIQUE_AXIS) / np.linalg.norm(OBLIQUE_AXIS)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(4)
    m[:3, :3] = (np.eye(3) + math.sin(OBLIQUE_ANGLE) * k
                 + (1 - math.cos(OBLIQUE_ANGLE)) * k @ k)
    return m


@contextlib.contextmanager
def _f64_transcendentals():
    """torch's sqrt and transcendentals, as the tapes' plain evaluation
    calls them (eval/arith.py), on f32 CPU tensors evaluated in float64
    and rounded to f32 (correctly rounded, where torch's own vectorized
    CPU versions may err in the last place) while it is open: the
    witness build of `phase_mesh_unrolled`."""
    names = ("sqrt", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
             "arctan2", "exp", "log")
    saved = {n: getattr(torch, n) for n in names}

    def wrap(fn):
        def call(*args, **kw):
            if all(isinstance(a, torch.Tensor) and a.dtype == torch.float32
                   and a.device.type == "cpu" for a in args) and not kw:
                return fn(*(a.double() for a in args)).float()
            return fn(*args, **kw)
        return call

    for n, fn in saved.items():
        setattr(torch, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(torch, n, fn)


def _glue_sign(kern):
    """U1-P "sign" for the tape of a sign-table kernel (the dense glue's
    corners, lattices and edge rounds), kept on that kernel."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    k = kern.__dict__.get("_glue_sign")
    if k is None:
        k = kern._glue_sign = uc.PointsKernel(kern.tapes[0], kern.axis_of,
                                              kern.V, "sign")
    return k


def _glue_kernels(ev):
    """The kernels the dense glue of the fine stage runs besides the path's
    (`_old_glue`): U1-P "distance" (kept on the evaluator) and "sign"."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.mesh import fused

    ks = ev.__dict__.get("_old_glue_kernels")
    if ks is None:
        ks = ev._old_glue_kernels = {
            "distance": uc.PointsKernel(ev.tape, ev.axis_of, ev.n_inputs,
                                        "distance"),
            "sign": _glue_sign(fused._kernels(ev)["table"])}
    return ks


def start_mesh_unrolled_build(port, after):
    """The compiled mesher's generated kernels for the two mesh scenes
    (U1-P's sign table and edge search, U2-B; and U1-P "distance" and
    "sign" of `_old_glue`), their nvcc steps started in a thread of their own once
    `after` (the compiled 3D build, which builds the union's program)
    has ended, so that no unit is built twice. Returns a future of
    (steps, seconds)."""
    from fidget_tpu_torch import mesh as mesh_mod
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.mesh import fused

    kernels = []
    for _, _, scene in _mesh_scenes(port):
        tape = scene.tape() if isinstance(scene, port.Shape) else scene
        ev = mesh_mod._get_evaluator(tape, torch.device("cuda"), True)
        kernels += fused.fused_kernels(ev) + list(_glue_kernels(ev).values())
    for k in kernels:  # the units fixed on the calling thread
        k.unit()

    def build():
        after.result()
        t0 = time.perf_counter()
        steps = uc.build_kernels(kernels)
        return steps, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(build)
    pool.shutdown(wait=False)
    return future


def _glue_level_core(ev, keys, n_in, cvec, li, h_child, pos, neg, off3, vv,
                     cout):
    """mesh/fused.py's level core before `level_active`: the children's boxes
    as six planes in torch ops, stacked and classified by U2-B
    `unrolled_interval_boxes`, the keys encoded in torch ops."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.mesh import fused

    kid, mlo, mhi = uc.level_boxes(keys, h_child, pos, neg, off3)
    full, empty = uc.unrolled_interval_boxes(fused._kernels(ev)["boxes"],
                                             mlo, mhi, vv, n_in)
    live = (torch.arange(keys.shape[0], device=keys.device) < n_in) & (
        keys >= 0)
    act = ~(full | empty) & live[None, :]
    out, n_out = fused._compact_keys(act.T, kid.T, cout)
    cvec[li] = n_out[0]
    return out, n_out


def _glue_edge_search(ev, cross, h, mat, vv, cs, rounds, samples, seeds):
    """mesh/fused.py's edge search before `unrolled_edges`, over every (edge,
    cell) slot of [12, cs]: `rounds` launches of U1-P "sign" over
    [samples, 12, cs] with the brackets moved in torch ops between them,
    U1-P "distance" at the intersections and K4 over all 12 x cs lanes.
    The surface cells come from the crossing list's source (the cells
    the chain compacted: `_old_glue` passes them on)."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.mesh import fused
    from fidget_tpu_torch.mesh.tables import EDGE_HI, EDGE_LO

    surf_keys, mask, n_surf = (a[:cs] if a.numel() > 1 else a
                               for a in ev._glue_cells)
    dev = surf_keys.device
    x, y, z = fused._dec(surf_keys)
    lo_c = torch.as_tensor(EDGE_LO, device=dev)[:, None].expand(12, cs)
    hi_c = torch.as_tensor(EDGE_HI, device=dev)[:, None].expand(12, cs)
    lo_in = (mask[None, :] >> lo_c) & 1
    start_c = torch.where(lo_in == 1, lo_c, hi_c).long()
    end_c = torch.where(lo_in == 1, hi_c, lo_c).long()
    coff = fused._corner_off(dev)

    def corner_pos(c):
        return tuple((v[None, :] + coff[c, k]).to(torch.float32) * h - 1.0
                     for k, v in enumerate((x, y, z)))

    sx, sy, sz = corner_pos(start_c)
    ex, ey, ez = corner_pos(end_c)
    dx, dy, dz = ex - sx, ey - sy, ez - sz
    frac = ((torch.arange(samples, dtype=torch.float32, device=dev) + 1.0)
            / (samples + 1.0))[:, None, None]
    idx = torch.arange(samples, device=dev)[:, None, None]
    ta = torch.zeros((12, cs), dtype=torch.float32, device=dev)
    tb = torch.ones((12, cs), dtype=torch.float32, device=dev)
    sign = _glue_kernels(ev)["sign"]
    for _ in range(rounds):
        ts = ta[None] + (tb - ta)[None] * frac
        inside = uc.unrolled_points(
            sign, *fused._model_pts(mat, sx[None] + dx[None] * ts,
                                    sy[None] + dy[None] * ts,
                                    sz[None] + dz[None] * ts), vv, n_surf)
        outside = ~inside
        any_out = outside.any(dim=0)
        F = torch.where(outside, idx, samples).amin(dim=0).to(torch.float32)
        span = tb - ta
        tbF = ta + span * (F + 1.0) / (samples + 1.0)
        taF = ta + span * F / (samples + 1.0)
        ts_last = ta + span * samples / (samples + 1.0)
        new_tb = torch.where(any_out, tbF, tb)
        ta = torch.where(any_out & (F > 0), taF,
                         torch.where(any_out, ta, ts_last))
        tb = new_tb
    t = 0.5 * (ta + tb)
    ip = (sx + dx * t, sy + dy * t, sz + dz * t)
    mp = fused._model_pts(mat, *ip)
    idist = uc.unrolled_points(_glue_kernels(ev)["distance"], *mp, vv, n_surf)
    g = ev.eval_grad(*mp, vv, seeds=seeds)[0]
    return (*ip, idist, *(g[1 + k].reshape(12, cs) for k in range(3)))


def _glue_leaf_masks(kern, keys, n_leaf, h, mat, params, table):
    """mesh/fused.py's leaf core before the sign table: U1-P "sign" at
    every (corner, cell) pair of `leaf_points`, the masks in torch ops."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    _, pts = uc.leaf_points(keys, h, mat)
    return uc.corner_masks(uc.unrolled_points(_glue_sign(kern), *pts, params,
                                              n_leaf))


def _glue_merge_topo(kern, pb3, ps, n_cand, h, mat, params, table):
    """mesh/fused.py's collapse round before the sign table: U1-P "sign"
    at every point of the [27, kcap] lattice and `topo_test` in torch ops
    (a dead candidate's test runs and is not read)."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    _, pts = uc.lattice_points(pb3, ps, h, mat)
    return uc.topo_test(uc.unrolled_points(_glue_sign(kern), *pts, params))


@contextlib.contextmanager
def _old_glue():
    """The compiled mesher with the dense glue around the kernels: the
    level cores on `_glue_level_core`, the leaf core's masks on
    `_glue_leaf_masks`, the collapse rounds' test on `_glue_merge_topo`,
    the edge search on `_glue_edge_search` (the edge core's QEF part
    unchanged)."""
    from fidget_tpu_torch.mesh import fused

    names = ("level_core", "edge_search", "edges_core", "leaf_masks",
             "merge_topo")
    saved = {n: getattr(fused, n) for n in names}

    def edges_core(ev, surf_keys, surf_mask, n_surf, *args, **kw):
        ev._glue_cells = (surf_keys, surf_mask, n_surf)
        return saved["edges_core"](ev, surf_keys, surf_mask, n_surf, *args,
                                   **kw)

    fused.level_core = _glue_level_core
    fused.edge_search = _glue_edge_search
    fused.edges_core = edges_core
    fused.leaf_masks = _glue_leaf_masks
    fused.merge_topo = _glue_merge_topo
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fused, n, f)


def _mesher_live(name, args):
    """The live lanes of one U1-P / U2-B call: points or boxes of a
    [rows, cols] list with `count` live columns, slots of the crossing
    list, children of the live parents."""
    if name == "unrolled_edges":
        return min(args[1].shape[0], int(args[4]))
    if name in ("level_active", "leaf_masks"):
        return 8 * min(args[1].shape[0], int(args[2]))
    if name == "merge_topo":
        return 27 * int(args[3])
    first = args[1] if name == "unrolled_points" else args[1][0]
    i = 5 if name == "unrolled_points" else 4
    count = args[i] if len(args) > i else None
    cols = first.shape[-1]
    return first.numel() // cols * (cols if count is None
                                    else min(cols, int(count)))


def _mesher_bound(name, args, kwargs, out):
    """(bound_ms, bound_by, operations, bytes) of one U1-P / U2-B call
    over its live lanes (`_mesher_live`): U1-P one operation per tape
    row per point, moving the three coordinates in and the distance or
    sign out; U1-P's edge search, a slot's `rounds` x `samples` samples
    and the distance, each the tape's rows and EDGE_POINT_OPS, with
    EDGE_ROUND_OPS a round, moving the key, mask and slot in and its
    EDGE_OUTS values out; U2-B two (lo, hi) per row per box, moving the
    six corners in and the two proofs out (`level_active`: the parents'
    keys in, LEVEL_BOX_OPS a child to form its box, the child's key and
    flag out); the params once."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    kern = args[0]
    live = _mesher_live(name, args)
    if name == "unrolled_points":
        ops = live * len(kern.tapes[0])
        nbytes = live * (12 + out.element_size()) + args[4].nbytes
    elif name == "unrolled_edges":
        rows, S, R = len(kern.tapes[0]), kwargs["samples"], kwargs["rounds"]
        ops = live * ((R * S + 1) * (rows + EDGE_POINT_OPS)
                      + R * EDGE_ROUND_OPS)
        nbytes = live * (12 + 4 * uc.EDGE_OUTS) + args[6].nbytes + 48
    elif name == "level_active":
        ops = live * (2 * len(kern.tape) + LEVEL_BOX_OPS)
        nbytes = live // 8 * 4 + live * 5 + args[-1].nbytes + 84
    else:
        ops = 2 * live * len(kern.tape)
        nbytes = live * (24 + 2) + args[3].nbytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, ops, nbytes


def _measure_mesher(label, name, args, kwargs=None):
    """One captured U1-P / U2-B call against its plain version on the
    card (distances and the edge search's values with max abs err 0, NaN
    where plain is NaN; signs, proofs, flags and keys exactly),
    CUDA-event ms, profiler device ms, plain ms and the bound."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    kwargs = kwargs or {}
    fn = getattr(uc, name)
    plain = getattr(uc, name + "_plain")
    got = fn(*args, **kwargs)
    want, plain_ms = _time_plain(plain, args, kwargs)
    if name == "unrolled_edges" or (name == "unrolled_points"
                                    and args[0].epilogue == "distance"):
        err = check(f"{name} ({label})", got, want, 0.0, 0.0)
    else:
        same = (torch.equal(got, want) if name == "unrolled_points"
                else all(torch.equal(g, w) for g, w in zip(got, want)))
        if not same:
            raise Failed(f"{name} ({label}) differs from its plain version")
        err = 0.0
    ms = time_cuda(lambda: fn(*args, **kwargs), reps=20)
    symbol = {"level_active": "fidget_unrolled_level"}.get(name,
                                                            "fidget_" + name)
    dms = device_ms(lambda: fn(*args, **kwargs), symbol)
    bound_ms, by, ops, nbytes = _mesher_bound(
        name, args, kwargs, got if name == "unrolled_points" else None)
    shape = tuple((args[1][0] if name == "unrolled_interval_boxes"
                   else args[1]).shape)
    log(f"kernel {name} ({label}): {shape} lanes, {_mesher_live(name, args)} "
        f"live, {ops} operations over them, {nbytes} bytes; equal to plain "
        f"(max abs err {err}), {ms:.4f} ms (CUDA events), device {dms} ms "
        f"(profiler), plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms ({by}),"
        f" slots {_slot_bound_ms(ops):.5f} ms")
    return dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, operations=ops, bytes=nbytes,
                slot_bound_ms=_slot_bound_ms(ops), shape=list(shape),
                live=_mesher_live(name, args))


def _time_fresh(make, fn, reps):
    """Mean device ms a call of fn(make()) by CUDA events, `make` run
    before each call outside the timed span and the card kept busy
    (`torch.cuda._sleep`) while the host enqueues the call, so that the
    events time the call's kernels and not its enqueue."""
    fn(make())
    total = 0.0
    for _ in range(reps):
        x = make()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn(x)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _split_fresh(make, fn, names, reps=10):
    """Device ms a call of fn(make()) by kernel, from the profiler: each
    kernel whose name holds one of `names` (launched once a call), its
    device time over the launches the session recorded (a session may
    drop some); None when no session records one."""
    from torch.profiler import ProfilerActivity, profile

    xs = [make() for _ in range(reps)]
    fn(make())
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for x in xs:
                fn(x)
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.self_device_time_total > 0 and any(n in e.key
                                                    for n in names):
                out[e.key] = e.self_device_time_total / 1e3 / e.count
        if out:
            return out
        xs = [make() for _ in range(reps)]
    return None


def _table_bound(name, args, live, evaluated, out):
    """(bound over the distinct points the table evaluated, bound over the
    points a pair asks for (the reference's 8 a cell / 27 a candidate),
    bound_by of the first, operations of each, bytes) of a sign-table
    entry: a point one operation a tape row; bytes the cells' keys in and
    the masks out (leaf), the candidates' corners in and the test out
    (merge), and the params."""
    kern = args[0]
    rows = len(kern.tapes[0])
    if name == "leaf_masks":
        nbytes = live // 8 * 4 + out.numel() * 4
    else:
        nbytes = live // 27 * 12 + out.numel()
    nbytes += args[-2].nbytes + 48
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    ops, ops_ref = evaluated * rows, live * rows
    t_ops, t_ref = (o / F32_OPS_PER_S * 1e3 for o in (ops, ops_ref))
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), max(t_bytes, t_ref), by, ops, ops_ref, nbytes


def _measure_table(label, name, args, kwargs=None):
    """One captured sign-table entry (`leaf_masks`, `merge_topo`) against
    its plain version on the card, the call on a copy of the table the
    build held before it: masks or topo, the table's keys and signs and
    its counts exactly, no insert refused; device ms a call by CUDA
    events (the copy outside the timed span) and by the profiler (by
    kernel), plain ms, the points evaluated against the points asked
    for, and the bound two ways (`_table_bound`)."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    kwargs = kwargs or {}
    i = next(k for k, a in enumerate(args) if isinstance(a, uc.SignTable))
    before = args[i]
    fn, plain_fn = getattr(uc, name), getattr(uc, name + "_plain")

    def with_table(t):
        a = list(args)
        a[i] = t
        return a

    plain = uc.SignTable(0, before.device, plain=True)
    plain.keys, plain.signs = before.entries()
    plain.count = before.count.clone()
    want, plain_ms = _time_plain(plain_fn, with_table(plain), kwargs)
    live = _mesher_live(name, args)
    table = before.clone()
    got = fn(*with_table(table), **kwargs)
    if not torch.equal(got, want):
        raise Failed(f"{name} ({label}) differs from its plain version")
    for x, y in zip(table.entries(), plain.entries()):
        if not torch.equal(x, y):
            raise Failed(f"{name} ({label}): the table's keys or signs "
                         f"differ from the plain version's")
    counts = table.count.tolist()
    if counts[:2] != plain.count.tolist()[:2] or counts[2]:
        raise Failed(f"{name} ({label}): table counts {counts}, plain "
                     f"{plain.count.tolist()}")

    def call(t):
        return fn(*with_table(t), **kwargs)

    ms = _time_fresh(before.clone, call, 20)
    split = _split_fresh(before.clone, call,
                         ("fidget_unrolled_table_eval", *TABLE_ENTRIES[name]))
    dms = sum(split.values()) if split else None
    evaluated = counts[0]
    bound_ms, bound_ref, by, ops, ops_ref, nbytes = _table_bound(
        name, args, live, evaluated, want)
    # the issue floor of the points the table evaluated: the program's
    # static SASS alone (the unit's other functions, the table passes,
    # are not counted), a warp instruction a scheduler slot
    prog = program_sass(args[0].unit().lib)
    fl = None if prog is None or SM_CLOCK_HZ is None else dict(
        sass_per_row=prog / len(args[0].tapes[0]),
        issue_floor_ms=evaluated * prog / 32 / (SCHEDULERS * SM_CLOCK_HZ)
        * 1e3)
    log(f"kernel {name} ({label}): {live} points asked for, {evaluated} "
        f"evaluated ({live / max(1, evaluated):.2f}x), table of "
        f"{before.slots.numel()} slots holding {counts[1]} keys after "
        f"({table.slots.numel()} slots); equal to plain (masks or topo, the "
        f"table's keys, signs and counts); {ms:.4f} ms (CUDA events), device "
        f"{dms} ms by kernel {split}; plain {plain_ms:.1f} ms; bound "
        f"{bound_ms:.5f} ms ({by}) over the points evaluated ({ops} "
        f"operations, {nbytes} bytes), {bound_ref:.5f} ms over the points "
        f"asked for ({ops_ref} operations), slots {_slot_bound_ms(ops):.5f} "
        f"ms; " + ("SASS not measured" if fl is None else
                   f"the program's {prog} SASS ({fl['sass_per_row']:.3f} a "
                   f"row), issue floor {fl['issue_floor_ms']:.5f} ms over the "
                   f"points evaluated"))
    return dict(max_abs_err=0.0, ms=ms, device_ms=dms, split=split,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                operations=ops, bytes=nbytes,
                bound_points_asked_ms=bound_ref,
                operations_points_asked=ops_ref,
                slot_bound_ms=_slot_bound_ms(ops), live=live,
                evaluated=evaluated, table_slots=before.slots.numel(),
                keys_held=counts[1],
                issue_floor_ms=None if fl is None else fl["issue_floor_ms"],
                sass_per_row=None if fl is None else fl["sass_per_row"],
                shape=list(args[1].shape))


def _mesher_site(name, args):
    """Where in the fine stage a U1-P / U2-B call comes from, by its
    kernel and list shape."""
    if name == "leaf_masks":
        return "leaf"
    if name == "merge_topo":
        return "collapse round"
    if name == "level_active":
        return "levels"
    if name == "unrolled_edges":
        return "edges"
    if name == "unrolled_interval_boxes":
        return "levels, box planes"
    rows = args[1].shape[0] if args[1].dim() == 2 else None
    return {8: "leaf corners", 27: "lattice"}.get(rows, f"rows {rows}")


@contextlib.contextmanager
def _capture_mesher(tag, captured):
    """Records, per (scene tag, kernel, site), the call of U1-P / U2-B
    in mesh/fused.py with the most live lanes (its count read on the
    host: a warm-up build only; a sign table as it was before the call),
    and the surface cells' count of the build's edge core under (tag,
    "surface")."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.mesh import fused

    saved = {n: getattr(fused, n) for n in MESHER_KERNELS + ("edges_core",)}

    def recorder(name):
        def call(*args, **kwargs):
            live = _mesher_live(name, args)
            key = (tag, name, _mesher_site(name, args))
            if key not in captured or live > captured[key][2]:
                captured[key] = (tuple(
                    a.clone() if isinstance(a, uc.SignTable) else a
                    for a in args), kwargs, live)
            return saved[name](*args, **kwargs)
        return call

    def edges_core(ev, surf_keys, surf_mask, n_surf, *args, **kw):
        captured[(tag, "surface")] = int(n_surf)
        return saved["edges_core"](ev, surf_keys, surf_mask, n_surf, *args,
                                   **kw)

    for n in MESHER_KERNELS:
        setattr(fused, n, recorder(n))
    fused.edges_core = edges_core
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(fused, n, f)


def phase_mesh_unrolled(port, cuda, rows, built, depth=MESH_DEPTH,
                        dev="cuda"):
    """`build_mesh(Settings(eval="unrolled"))` at depth 8 (collapse on)
    on phase 11's two scenes under MESH_VIEW: the cold build of the
    generated kernels (`start_mesh_unrolled_build`, beside the earlier
    phases) and a cached one; launch counts set to 0 before the two
    builds and read after (U1-P's leaf and merge entries and edge
    search, U2-B on the levels and K4 each launched; K1 and K3 never);
    each mesh held by `check_mesh` and equal, vertices and triangles, to
    the same build on the dense glue (`_old_glue`: U1-P "sign" at every
    corner and lattice point, the edge rounds over all 12 edges and U2-B
    over box planes); a depth-5 sphere built on the card equal to the
    CPU's build, and a depth-5 gyroid sphere under an oblique rotation
    likewise (triangles equal, vertices within 1e-5); U1-P (the sign
    table's entries (`_measure_table`), "sign" on the points the dense
    glue forms for them, its edge search) and U2-B (on the levels, and
    over the union's largest level as box planes) on the inputs the
    depth-8 builds gave them, bit for bit against their plain versions,
    with time and bound (the `kernels` rows), and K4 at the
    fine stage's gradient shape; then warm builds (host clock,
    synchronized; stages by `_StageClock`; phase 11 times the same
    builds under eval="interp") and the device's busy share of one
    compiled build."""
    from fidget_tpu_torch import mesh as mesh_mod
    from fidget_tpu_torch.eval import bulk
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.mesh import collapse, fused

    t_phase = time.perf_counter()
    dev = torch.device(dev)
    steps, cold_s = built.result()
    wait_s = time.perf_counter() - t_phase
    scenes = _mesh_scenes(port)
    kernels, spills = [], {}
    for tag, _, scene in scenes:
        tape = scene.tape() if isinstance(scene, port.Shape) else scene
        for k in fused.fused_kernels(mesh_mod._get_evaluator(tape, dev,
                                                             True)):
            kernels.append(k)
            name = f"{tag} {type(k).__name__} {getattr(k, 'epilogue', '')}"
            lines, spills[name] = _ptxas_lines(k.unit())
            log(f"mesh (unrolled) {name}: " + "; ".join(lines))
    t0 = time.perf_counter()
    again = uc.build_kernels(kernels)
    cached_s = time.perf_counter() - t0
    if again or not uc.built(kernels):
        raise Failed(f"mesher kernels not cached after a build: {again}")
    log(f"mesh (unrolled) build: {len(steps)} nvcc steps in {cold_s:.1f} s "
        f"cold (started beside the earlier phases; {wait_s:.1f} s waited "
        f"here), cached {cached_s:.3f} s; spill bytes {spills}")

    settings = port.MeshSettings(depth=depth, world_to_model=MESH_VIEW,
                                 device=dev, eval="unrolled")
    captured, grads = {}, {}
    for tag, label, scene in scenes:
        # the first build settles the capacities; the second, a cached
        # chain as the main path's, gives the rows their inputs
        port.build_mesh(scene, settings)
        targets = [(bulk, "interp_grad",
                    lambda a, k, tag=tag: f"interp_grad@{tag}")]
        with _capture_mesher(tag, captured), capture_kernel_inputs(targets,
                                                                   grads):
            port.build_mesh(scene, settings)
    torch.cuda.synchronize()
    cuda.reset_launches()
    meshes, boxes = [], []
    for _, label, scene in scenes:
        with _cell_boxes(collapse, boxes):
            meshes.append(port.build_mesh(scene, settings))
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"mesh (unrolled) launches over {len(scenes)} depth-{depth} builds: "
        f"{ {k: v for k, v in launches.items() if v} }")
    missing = [k for k in KERNELS_MESH_UNROLLED if launches[k] == 0]
    interp_k = [k for k in ("interp_interval", "interp_float")
                if launches[k]]
    if missing or interp_k:
        raise Failed(f"the compiled mesher never launched {missing} or "
                     f"launched the interpreter's {interp_k}")
    for (_, label, scene), m, bx in zip(scenes, meshes, boxes):
        tape = scene.tape() if isinstance(scene, port.Shape) else scene
        ev = mesh_mod._get_evaluator(tape, dev)
        check_mesh(f"{label} (unrolled)", m, ev, bx, MESH_VIEW)
    with _old_glue():
        for (_, label, scene), m in zip(scenes, meshes):
            old = port.build_mesh(scene, settings)
            if not (np.array_equal(old.triangles, m.triangles)
                    and old.vertices.shape == m.vertices.shape
                    and np.array_equal(old.vertices, m.vertices)):
                raise Failed(f"the {label} mesh differs from the one of the "
                             f"dense glue: triangles {m.triangles.shape} / "
                             f"{old.triangles.shape}")
            log(f"{label} (unrolled): mesh equal to the dense glue's "
                f"({len(m.triangles)} triangles, {len(m.vertices)} vertices,"
                f" bit for bit)")

    from fidget_tpu_torch.scenes import gyroid_sphere

    ctx = port.Context()
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    sphere = port.lower(ctx, [ctx.sub(ctx.sqrt(ctx.add(
        ctx.square(x), ctx.add(ctx.square(y), ctx.square(z)))), 0.6)])
    for label, scene, view in (("sphere", sphere, None),
                               ("oblique gyroid sphere", gyroid_sphere(port),
                                _oblique())):
        st = port.MeshSettings(depth=MESH_DEPTH_CPU, world_to_model=view,
                               device=dev, eval="unrolled")
        got = port.build_mesh(scene, st)
        st.device = "cpu"
        want = port.build_mesh(scene, st)
        same_t = (got.triangles.shape == want.triangles.shape
                  and np.array_equal(got.triangles, want.triangles))
        diff = (np.abs(got.vertices - want.vertices).max(axis=1)
                if same_t else None)
        witnessed = 0
        if same_t and (diff > 1e-5).any():
            # the float64 witness: the CPU build again with its
            # transcendentals evaluated in float64 and rounded to f32
            # (correctly rounded); a vertex that this alone moves is
            # decided by last-place rounding, and the card's (up to 2
            # ulps) may move it up to 4x as far
            with _f64_transcendentals():
                alt = port.build_mesh(scene, st)
            moved = np.abs(alt.vertices - want.vertices).max(axis=1)
            bad = diff > 1e-5
            ok = bad & (moved > 1e-6) & (diff <= 1e-5 + 4 * moved)
            witnessed = int(ok.sum())
            for i in np.nonzero(bad)[0][:4]:
                log(f"  vertex {i}: card {got.vertices[i].tolist()}, CPU "
                    f"{want.vertices[i].tolist()}, CPU with correctly "
                    f"rounded transcendentals {alt.vertices[i].tolist()}")
            if (bad & ~ok).any():
                diff = None
        if not (len(got.triangles) and same_t and diff is not None):
            dv = (np.abs(got.vertices - want.vertices).max()
                  if got.vertices.shape == want.vertices.shape else None)
            raise Failed(f"the depth-{MESH_DEPTH_CPU} unrolled {label} mesh "
                         f"on the card differs from the CPU's: triangles "
                         f"{got.triangles.shape} / {want.triangles.shape}, "
                         f"equal {same_t}, max vertex difference {dv}")
        log(f"depth-{MESH_DEPTH_CPU} unrolled {label}: card mesh equals the "
            f"CPU's ({len(got.triangles)} triangles, max vertex difference "
            f"{diff.max():.3g}; {witnessed} vertices past 1e-5 on the float64 "
            f"witness)")

    measured = {}
    calls = {k: v for k, v in captured.items() if len(k) == 3}
    for key in sorted(calls):
        tag, name, site = key
        args, kwargs, _ = calls[key]
        if name in TABLE_ENTRIES:
            measured[key] = _measure_table(f"{tag}, {site}", name, args,
                                           kwargs)
            # U1-P "sign" on the points the dense glue forms for the same
            # call: every (corner, cell) or (candidate, lattice point) pair
            sign = _glue_sign(args[0])
            if name == "leaf_masks":
                kern, keys, n_leaf, h, mat, vv, _ = args
                glue = (sign, *uc.leaf_points(keys, h, mat)[1], vv, n_leaf)
                gsite = "leaf corners, dense glue"
            else:
                kern, pb3, ps, n_cand, h, mat, vv, _ = args
                glue = (sign, *uc.lattice_points(pb3, ps, h, mat)[1], vv)
                gsite = "lattice, dense glue"
            measured[(tag, "unrolled_points", gsite)] = _measure_mesher(
                f"{tag}, {gsite}", "unrolled_points", glue)
            continue
        measured[key] = _measure_mesher(f"{tag}, {site}", name, args, kwargs)
        if name == "unrolled_edges":
            # the same work counted as the dense rounds did, over all 12
            # edges of every surface cell
            n12 = 12 * captured[(tag, "surface")]
            live = measured[key]["live"]
            measured[key]["bound_all_12_edges_ms"] = measured[key][
                "bound_ms"] * n12 / max(1, live)
        if name == "level_active":
            # U2-B's box-plane entry on the same boxes, formed in torch
            kern, keys, n_in, h_child, pos, neg, off3, vv = args
            _, mlo, mhi = uc.level_boxes(keys, h_child, pos, neg, off3)
            measured[(tag, "unrolled_interval_boxes", "levels, box planes")] = (
                _measure_mesher(f"{tag}, levels, box planes",
                                "unrolled_interval_boxes",
                                (kern, mlo, mhi, vv, n_in)))
    heads = {"leaf_masks": "leaf", "merge_topo": "collapse round",
             "unrolled_points": "leaf corners, dense glue",
             "unrolled_edges": "edges", "level_active": "levels",
             "unrolled_interval_boxes": "levels, box planes"}
    for name, site in heads.items():
        head = ("union", name, site)
        rows[name] = {
            "name": name, "route": "cuda", "source": UNROLLED_SOURCE,
            "replaces": UNROLLED_REPLACES, "launches": launches[name],
            "launches_per_build": launches[name] / len(scenes),
            **measured[head], "library_ms": None,
            "at": {", ".join((k[0], k[2])): v for k, v in measured.items()
                   if k[1] == name and k != head},
            "build": {"steps": len(steps), "cold_s": cold_s,
                      "cached_s": cached_s, "spill_bytes": spills},
        }
    # the table's growths between collapse rounds (SignTable.reserve),
    # which merge_topo's rows time and hold with the table
    rows["merge_topo"]["table_grow_launches"] = launches["table_grow"]
    for key in sorted(grads):
        name, tag = key.split("@")
        args, kwargs = grads[key]
        rows[name][f"at_mesh_unrolled_{tag}"] = dict(
            launches=launches[name],
            **_measure_sliced(f"{name} at the {tag} compiled mesh's "
                              f"gradient shape", name, args, kwargs))

    for tag, label, scene in scenes:
        totals, stages = [], []
        for _ in range(MESH_REPS):
            clock = mesh_mod._StageClock(True, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            port.build_mesh(scene, settings, clock=clock)
            torch.cuda.synchronize()
            totals.append((time.perf_counter() - t0) * 1e3)
            stages.append(_stage_table(clock.stages))
        med = float(np.median(totals))
        k = int(np.argsort(totals)[len(totals) // 2])
        log(f"mesh build, {label}, depth {depth}, unrolled: warm median "
            f"{med:.1f} ms, min {min(totals):.1f} ms over {MESH_REPS} "
            f"builds (host clock; phase 11 times eval=\"interp\"); stages "
            f"of the median build (ms): " + ", ".join(
                f"{s} {ms:.1f}" for s, ms in stages[k].items()))
        busy = _log_busy(f"{label} compiled build", _device_busy(
            lambda: port.build_mesh(scene, settings), 1), med)
        for name in heads:
            rows[name].setdefault("builds", {})[tag] = {
                "unrolled_ms": totals, "unrolled_busy_ms": busy}
    log(f"phase 11b: {time.perf_counter() - t_phase:.1f} s")


#: the per-shape compiled path (render/unrolled2d.py) at its defaults:
#: 8-px cull tiles, 256-px union blocks; U1 and U2 replace the Pallas
#: probe P1 (U2 is its interval twin)
UNROLLED_T0 = 8
UNROLLED_BLOCK = 256
UNROLLED_SOURCE = "fidget_tpu_torch/csrc/unrolled.cuh"
UNROLLED_REPLACES = "demos/exp_unrolled_kernel.py:49"
UNROLLED_KERNELS = ("unrolled_float", "unrolled_interval")
#: frames of each unrolled mode: the kernels it must launch
UNROLLED_MODES = {
    "union": ("unrolled_interval", "unrolled_float"),
    "full": ("unrolled_interval", "unrolled_float"),
    "full-interp": ("interp_interval", "unrolled_float"),
    "dense": ("unrolled_float",),
}


def _ptxas_lines(unit):
    """(registers / spill lines of nvcc's logs of a generated unit and its
    program objects, total spill bytes)."""
    import re

    logs = [unit.dir / "kernel.log"] + [o.dir / "prog.log" for o in unit.objects]
    lines, spill = [], 0
    for p in dict.fromkeys(logs):
        if not p.exists():
            continue
        for line in p.read_text().splitlines():
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spill += int(m.group(1)) + int(m.group(2))
            if "registers" in line or (m and int(m.group(1)) + int(m.group(2))):
                lines.append(line.strip())
    return lines, spill


def phase_unrolled_build(port, tape, param_tape):
    """Builds every generated kernel of the unrolled phases in one batch,
    all nvcc processes started together: U1 of the stand-in's full tape
    and of its union plan (the programs of 256-px blocks at the first
    view, plus the full-tape fallback), U2 with the proofs and the
    violation epilogues, and U1 of the parametrized stand-in (the
    gradient phase). Prints the union plan's host build time, the cold and the
    cached build seconds (each step, and the batch's wall) and every
    generated kernel's registers and spills. Returns the renderer (its
    plan installed), the plan's build ms and the build record."""
    from fidget_tpu_torch.compiler.unions import build_union_plan
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.render import unrolled2d as u2

    r = port.PixelRenderer(tape, port.ImageSize(SIZE, SIZE))
    T0 = UNROLLED_T0
    n0x = n0y = SIZE // T0
    t0 = time.perf_counter()
    plan = build_union_plan(tape, T0, n0x, n0y, r._mat4(FRAMES[0]), 0.0,
                            r._var_vec(None), r.axis_of,
                            block_px=UNROLLED_BLOCK)
    plan_ms = (time.perf_counter() - t0) * 1e3
    st = u2.state(r)
    st.plans[(T0, UNROLLED_BLOCK)] = plan
    fb_cap = max(128, -(-(n0x * n0y // 64) // 128) * 128)
    union = u2.union_tables(r, plan, fb_cap).kernel
    log(f"unrolled: union plan of {n0x * n0y} tiles at {T0} px, "
        f"{UNROLLED_BLOCK}-px blocks, built on the host in {plan_ms:.1f} ms: "
        f"{plan.stats()}")
    rp = port.PixelRenderer(param_tape, port.ImageSize(SIZE, SIZE))
    kernels = {"U1 full": st.float_full, "U1 union": union,
               **{f"U2 {e}": st.interval(e) for e in ("proofs", "violation")},
               "U1 full (parametrized)": u2.state(rp).float_full}
    t0 = time.perf_counter()
    steps = uc.build_kernels(list(kernels.values()))
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = uc.build_kernels(list(kernels.values()))
    cached = time.perf_counter() - t0
    if again or not uc.built(list(kernels.values())):
        raise Failed(f"generated kernels not cached after a build: {again}")
    names = {k.unit().key: label for label, k in kernels.items()}
    for label, k in kernels.items():
        part = "program" if isinstance(k, uc.FloatKernel) else "warp stream"
        for o in k.unit().objects:
            names.setdefault(o.key, f"{part} of {label}")
    log(f"unrolled build: {len(steps)} nvcc steps (program objects, kernel "
        f"units, links) in {cold:.1f} s wall, cold; cached {cached:.3f} s "
        f"(nothing rebuilt)")
    for key, sec in sorted(steps.items(), key=lambda p: p[1]):
        base = key.split(":")[0]
        log(f"  {names.get(base, base)}{' link' if ':' in key else ''} "
            f"({base}): done at {sec:.1f} s")
    record = {"cold_s": cold, "cached_s": cached, "steps": steps,
              "plan_ms": plan_ms, "spill_bytes": {}}
    for label, k in kernels.items():
        lines, spill = _ptxas_lines(k.unit())
        record["spill_bytes"][label] = spill
        log(f"  {label}: {len(k.unit().objects) + 1} unit(s), spill bytes "
            f"{spill}; " + " | ".join(lines[:4]))
    return r, rp, record


#: classes of SASS opcodes (`sass_counts`); every other opcode is "rest"
SASS_CLASSES = {
    "fp32": {"FADD", "FMUL", "FFMA", "FRND", "FCHK", "F2F", "F2I", "I2F",
             "FSWZADD"},
    "mufu": {"MUFU"},
    "cmp_sel": {"FSETP", "FSEL", "FMNMX", "ISETP", "SEL", "PLOP3", "FCMP",
                "ICMP", "P2R", "R2P"},
    "branch": {"BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "JMP", "JMX",
               "BRX", "WARPSYNC", "BREAK"},
    "local": {"LDL", "STL"},
}
#: MUFU results a clock on one SM of the H100 (four a quarter)
MUFU_PER_SM_CLOCK = 16


def sass_counts(lib):
    """{class: static SASS instructions} of every function in the
    library `lib` (`cuobjdump -sass`; NOPs not counted), with the most
    registers and stack bytes a function of it uses (`max_regs`,
    `max_stack`, from `cuobjdump -res-usage`), or None where cuobjdump
    is missing or fails."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for what in ("-res-usage", "-sass"):
        try:
            res = subprocess.run([tool, what, str(lib)], capture_output=True,
                                 text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if res.returncode != 0:
            return None
        out[what] = res.stdout
    counts = dict.fromkeys([*SASS_CLASSES, "rest"], 0)
    counts["max_regs"] = max(
        (int(r) for r in re.findall(r"REG:(\d+)", out["-res-usage"])),
        default=0)
    counts["max_stack"] = max(
        (int(r) for r in re.findall(r"STACK:(\d+)", out["-res-usage"])),
        default=0)
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z0-9_]+)",
                         out["-sass"]):
        op = m.group(1)
        if op == "NOP":
            continue
        cls = next((c for c, ops in SASS_CLASSES.items() if op in ops), "rest")
        counts[cls] += 1
    return counts


@functools.lru_cache(maxsize=None)
def program_sass(lib):
    """Static SASS instructions (NOPs not counted) of the float programs
    (`fidget_uprog_*`) in the library `lib`, or None where cuobjdump is
    missing or fails; disassembled once a library."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if res.returncode != 0:
        return None
    total, inside = 0, False
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = m.group(1).startswith("fidget_uprog_")
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?"
                      r"([A-Z0-9_]+)", line)
        if inside and m and m.group(1) != "NOP":
            total += 1
    return total


def unrolled_floors(kern, rows_lanes):
    """SASS instructions a row and lane of a generated kernel (its
    library's static count over its programs' rows), and the two floors they give for `rows_lanes` row-lane
    evaluations: the issue floor (warp instructions over the card's
    schedulers at SM_CLOCK_HZ) and the MUFU floor. None where the
    disassembly is not at hand."""
    counts = sass_counts(kern.unit().lib)
    if counts is None or SM_CLOCK_HZ is None:
        return None
    if hasattr(kern, "tapes"):
        rows = sum(len(t) for t in {id(t): t for t in kern.tapes}.values())
    else:
        rows = len(kern.tape)
    total = sum(v for c, v in counts.items() if not c.startswith("max_"))
    per_row = total / rows
    issue_ms = rows_lanes * per_row / 32 / (SCHEDULERS * SM_CLOCK_HZ) * 1e3
    mufu_ms = (rows_lanes * counts["mufu"] / rows
               / (MUFU_PER_SM_CLOCK * SCHEDULERS / 4 * SM_CLOCK_HZ) * 1e3)
    return {"sass": counts, "sass_per_row": per_row,
            "mufu_per_row": counts["mufu"] / rows,
            "issue_floor_ms": issue_ms, "mufu_floor_ms": mufu_ms}


def _unrolled_bound(name, args, kwargs, out):
    """(bound_ms, bound_by, slot_bound_ms) of one U1 / U2 call: U1 counts
    one operation per row of the program a valid slot runs, per pixel
    (the work this call's data needs), and moves the slot corners and
    flags once and its distances once; U2 counts two operations (lo,
    hi) per row per tile and moves the tile corners, the flags and the
    epilogue's words."""
    kern = args[0]
    if name == "unrolled_float":
        _, cx0, _, valid, params, seg = args[:6]
        n, pp = cx0.shape[0], kwargs["pp"]
        bounds = list(seg) + [n]
        ops = sum(int(valid[bounds[s]:bounds[s + 1]].sum()) * pp * len(t)
                  for s, t in enumerate(kern.tapes))
        nbytes = n * 9 + params.nbytes + out.nbytes
    else:
        x0 = args[1]
        n = x0.shape[0]
        ops = 2 * n * len(kern.tape)
        extra = out[2]
        u = args[5] if len(args) > 5 else None
        nbytes = n * 10 + (0 if extra is None else extra.nbytes) + (
            0 if u is None else u.nbytes)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, _slot_bound_ms(ops), ops, nbytes


def _measure_unrolled(label, name, args, kwargs):
    """One captured U1 / U2 call: kernel against its plain version on the
    card (U1 distances exactly, or at K3's standard, rtol = atol = 2e-5,
    where a program holds an op outside EXACT_OPS; U2 flags and words
    exactly), CUDA-event ms (which holds the host's enqueue where that is
    slower than the kernel), the profiler's device ms, plain ms, the
    bound, and the SASS counts and floors (`unrolled_floors`)."""
    from fidget_tpu_torch.compiler.tape import TapeOp
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    fn = getattr(uc, name)
    plain = getattr(uc, name + "_plain")
    got = fn(*args, **kwargs)
    want, plain_ms = _time_plain(plain, args, kwargs)
    if name == "unrolled_float":
        inexact = {TapeOp(int(o)).name for t in args[0].tapes
                   for o in np.unique(t.op)} - EXACT_OPS - {
            "INPUT", "OUTPUT", "COPY", "LOAD", "STORE"}
        tol = 2e-5 if inexact else 0.0
        err = check(f"{name} {label}", got, want, tol, tol)
    else:
        for g, w in zip(got, want):
            if (g is None) != (w is None) or (g is not None
                                              and not torch.equal(g, w)):
                raise Failed(f"{name} {label}: flags or words differ from "
                             f"plain")
        err = 0.0
    ms = time_cuda(lambda: fn(*args, **kwargs), reps=20)
    dms = device_ms(lambda: fn(*args, **kwargs), "fidget_" + name)
    bound_ms, by, slot_ms, ops, nbytes = _unrolled_bound(name, args, kwargs,
                                                         got)
    floors = unrolled_floors(args[0], ops if name == "unrolled_float"
                             else ops // 2)
    shape = tuple(args[1].shape)
    fl = ("SASS not measured" if floors is None else
          f"{floors['sass_per_row']:.2f} SASS instructions a row and lane "
          f"({floors['mufu_per_row']:.3f} MUFU; {floors['sass']}), issue "
          f"floor {floors['issue_floor_ms']:.5f} ms, MUFU floor "
          f"{floors['mufu_floor_ms']:.5f} ms")
    log(f"kernel {name} ({label}): {shape[0]} lanes-or-slots, "
        f"{ops} operations, {nbytes} bytes; max abs err {err:.3g}, "
        f"{ms:.4f} ms (CUDA events), device {dms} ms (profiler), plain "
        f"{plain_ms:.1f} ms, bound {bound_ms:.5f} ms ({by}), "
        f"scheduler-slot bound {slot_ms:.5f} ms; {fl}")
    return dict(max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=by, slot_bound_ms=slot_ms,
                **(floors or {}))


#: the unrolled guard's var values: SPICY and three denormals
GUARD_DENORMALS = [1e-40, -1e-40, 1.4e-45]
#: the guard's image (256^2 in 8-px tiles) and its two screen -> model
#: matrices: the unit square, and one that scales by 1e30 (so squares
#: and products overflow to infinities)
GUARD_SIZE = 256


def _guard_matrices():
    n = GUARD_SIZE
    unit = np.array([[2.0 / n, 0, 0, -1.0], [0, -2.0 / n, 0, 1.0],
                     [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    wide = unit.copy()
    wide[:2] *= np.float32(1e30)
    return unit, wide


def _common_inputs(pkg, tape, kinds):
    """`tape` with its INPUT rows renumbered to the layout `kinds` (a
    list of "x", "y" or Vars), so that tapes of different inputs share
    one U1 launch."""
    from_arrays = importlib.import_module(
        pkg.__name__ + ".compiler.tape").Tape.from_arrays
    index = {(v.kind if v.kind in "xyz" else v): i
             for v, i in tape.var_map.items()}
    back = {i: kinds.index(k) for k, i in index.items()}
    aux = np.array(tape.aux)
    inp = np.asarray(tape.op) == 1  # TapeOp.INPUT
    aux[inp] = [back[int(a)] for a in aux[inp]]
    return from_arrays(tape.op, tape.out, tape.a, tape.b, tape.imm, aux,
                       tape.reg_count, tape.mem_count, tape.choice_count,
                       tape.output_count, kinds)


def _guard_tapes(pkg):
    """(op tapes, combined tapes, kinds): one tape per unary op over each
    input and per binary op (MIN / MAX / AND / OR included) register with
    register, register with immediate and immediate with register, over
    the inputs x, y, a, b; and combined tapes that hold every exact op
    (`EXACT_OPS`), every other op, and the nan_div shape of
    tests/test_torch_cuda.py, each op feeding a choice row. Every tape in
    the layout kinds = [x, y, a, b]."""
    ops = importlib.import_module(pkg.__name__ + ".core.ops")
    a_var, b_var = pkg.Var.new(), pkg.Var.new()
    kinds = ["x", "y", a_var, b_var]
    op_tapes = []
    for op in ops.UnaryOp:
        for src in ("x", "a"):
            ctx = pkg.Context()
            v = ctx.x() if src == "x" else ctx.input(a_var)
            op_tapes.append((op.name, pkg.lower(ctx, [ctx.op_unary(op, v)])))
    for op in ops.BinaryOp:
        for variant in ("x_a", "y_b", "b_imm", "imm_a"):
            ctx = pkg.Context()
            x, y = ctx.x(), ctx.y()
            a, b = ctx.input(a_var), ctx.input(b_var)
            l, r = {"x_a": (x, a), "y_b": (y, b), "b_imm": (b, 0.5),
                    "imm_a": (-2.0, a)}[variant]
            op_tapes.append((op.name,
                             pkg.lower(ctx, [ctx.op_binary(op, l, r)])))

    def combined(names):
        ctx = pkg.Context()
        x, y = ctx.x(), ctx.y()
        a, b = ctx.input(a_var), ctx.input(b_var)
        srcs = [x, y, a, b, ctx.op_binary(ops.BinaryOp.SUB, x, a),
                ctx.op_binary(ops.BinaryOp.ADD, y, b)]
        vals = []
        for i, op in enumerate(u for u in ops.UnaryOp if u.name in names):
            vals.append(ctx.op_unary(op, srcs[i % len(srcs)]))
        for op in ops.BinaryOp:
            if op.name not in names or op in ops.CHOICE_OPS:
                continue
            vals += [ctx.op_binary(op, x, a), ctx.op_binary(op, b, 0.5),
                     ctx.op_binary(op, -2.0, y)]
        if "DIV" in names:  # an immediate 0, and a denominator across 0
            vals += [ctx.op_binary(ops.BinaryOp.DIV, y, 0.0),
                     ctx.op_binary(ops.BinaryOp.DIV, x,
                                   ctx.op_binary(ops.BinaryOp.ADD, y, a))]
        folds = [ops.BinaryOp.MIN, ops.BinaryOp.MAX, ops.BinaryOp.AND,
                 ops.BinaryOp.OR]
        k = 0
        while len(vals) > 1:
            nxt = []
            for i in range(0, len(vals) - 1, 2):
                op = folds[k % 4]
                imm = (0.25, -0.5, 0.0, 1.0)[k % 4]
                nxt.append(ctx.op_binary(op, ctx.op_binary(op, vals[i], imm)
                                         if k % 3 == 0 else vals[i],
                                         vals[i + 1]))
                k += 1
            if len(vals) % 2:
                nxt.append(vals[-1])
            vals = nxt
        return pkg.lower(ctx, vals)

    exact = combined(EXACT_OPS)
    other = combined({op.name for op in ops.UnaryOp} - EXACT_OPS | {"ATAN2"})
    ctx = pkg.Context()
    x, y = ctx.x(), ctx.y()
    r = ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y)))
    d = ctx.min(ctx.sub(r, 0.6),
                ctx.max(ctx.sqrt(ctx.sub(x, 0.25)), ctx.sub(ctx.abs(x), 0.9)))
    d = ctx.max(d, ctx.min(ctx.div(ctx.sub(y, 0.1), 0.0), ctx.sub(r, 0.95)))
    d = ctx.min(d, ctx.max(ctx.div(ctx.sub(x, 0.3), ctx.add(y, 0.05)),
                           ctx.sub(r, 0.4)))
    nan_div = pkg.lower(ctx, [ctx.or_(ctx.and_(d, ctx.sub(r, 0.5)),
                                      ctx.sub(ctx.abs(y), 0.8))])
    tapes = [(name, _common_inputs(pkg, t, kinds)) for name, t in op_tapes]
    comb = [(name, _common_inputs(pkg, t, kinds), tol) for name, t, tol in (
        ("exact ops", exact, 0.0), ("other ops", other, 2e-4),
        ("nan_div", nan_div, 0.0))]
    return tapes, comb, kinds


def _guard_pairs():
    """(a, b) var values at each of the two `_guard_matrices`: every
    SPICY value and denormal as a at the first and as b at the second."""
    from fidget_tpu_torch.scenes import SPICY

    vals = [float(v) for v in np.concatenate(
        [SPICY, np.array(GUARD_DENORMALS, np.float32)])]
    n = len(vals)
    return ([(vals[i], vals[(7 * i + 3) % n]) for i in range(n)],
            [(vals[(11 * i + 5) % n], vals[i]) for i in range(n)])


def _violation_words(words, rng):
    """Reference words u for U2's violation epilogue from a tape's own
    choice words [cw, n] on the tiles (its plain capture): ORed with
    random bits, so that no lane violates, but for every third lane,
    where the lowest set bit of word lane % cw is cleared, so that it
    violates in that word alone."""
    w = words.cpu().numpy().view(np.uint32).astype(np.int64)
    u = w | rng.integers(0, 2**32, w.shape, dtype=np.int64)
    if w.shape[0]:
        lanes = np.arange(1, w.shape[1], 3)
        j = lanes % w.shape[0]
        u[j, lanes] &= ~(w[j, lanes] & -w[j, lanes])
    return torch.from_numpy(u.astype(np.uint32).view(np.int32)).to(
        words.device)


def _guard_kernels(pkg):
    """Phase 6e's tapes and kernels of `pkg`, their units fixed (the
    global-word ones under a SHARED_LIMIT of 0), not built: (module,
    op tapes, combined tapes, kinds, the op-matrix kernel, singles,
    intervals, and the 3D variants on the combined tapes: U1-3D with
    each tape's tolerance, U2-3D; none where `pkg` has no 3D
    variants)."""
    uc = importlib.import_module(pkg.__name__ + ".eval.unrolled_cuda")
    op_tapes, comb, kinds = _guard_tapes(pkg)
    axis = {"x": 0, "y": 1}
    V = len(kinds)
    matrix = uc.FloatKernel([t for _, t in op_tapes], axis, V)
    singles = [(name, uc.FloatKernel([t], axis, V), tol)
               for name, t, tol in comb]
    # (tape name, epilogue, kernels): U2 per tape and epilogue, and on the
    # exact ops with the words in global memory, where a tape's past
    # SHARED_LIMIT go
    intervals = [(name, epi, [uc.IntervalKernel(t, axis, V, epi)])
                 for name, t, _ in comb for epi in uc.EPILOGUES]
    limit = getattr(uc, "SHARED_LIMIT", None)
    uc.SHARED_LIMIT = 0
    try:
        for name, epi, ks in intervals:
            if name == comb[0][0] and epi != "proofs":
                ks.append(uc.IntervalKernel(ks[0].tape, axis, V, epi))
                ks[-1].unit()
    finally:
        uc.SHARED_LIMIT = limit
    voxels3, intervals3 = [], []
    if hasattr(uc, "VoxelKernel"):
        voxels3 = [(name, uc.VoxelKernel(t, axis, V), tol)
                   for name, t, tol in comb]
        # U2-3D at every layout the frames can take, the rule's at the
        # fewest and the most boxes (one kernel a tape where the package
        # has a single one)
        layouts = None
        if hasattr(uc, "proofs3_warps"):
            layouts = sorted({uc.proofs3_warps(1), uc.proofs3_warps(1 << 30)})
        intervals3 = [
            (name if layouts is None else f"{name} k={k}",
             uc.Interval3Kernel(t, axis, V) if layouts is None
             else uc.Interval3Kernel(t, axis, V, warps=k))
            for name, t, _ in comb for k in (layouts or (None,))]
    points, boxes, edges = [], [], []
    if hasattr(uc, "PointsKernel"):
        points = [(name, uc.PointsKernel(t, axis, V, epi), tol)
                  for name, t, tol in comb for epi in uc.POINT_EPILOGUES]
        boxes = [(name, uc.BoxesKernel(t, axis, V)) for name, t, _ in comb]
    if hasattr(uc, "EdgesKernel"):
        edges = [(name, uc.EdgesKernel(t, axis, V), tol)
                 for name, t, tol in comb]
    return (uc, op_tapes, comb, kinds, matrix, singles, intervals, voxels3,
            intervals3, points, boxes, edges)


def start_guard_build(pkg):
    """Phase 6e's kernels (`_guard_kernels`, made on the calling thread,
    which sets the module's SHARED_LIMIT for a moment) with their nvcc
    steps started in a thread of their own, so that they run on the
    host's idle cores while the phases before 6e use the card. Returns a
    future of (kernels, steps, build seconds)."""
    guard = _guard_kernels(pkg)
    (uc, _, _, _, matrix, singles, intervals, voxels3, intervals3, points,
     boxes, edges) = guard
    kernels = ([matrix] + [k for _, k, _ in singles]
               + [k for _, _, ks in intervals for k in ks]
               + [k for _, k, _ in voxels3] + [k for _, k in intervals3]
               + [k for _, k, _ in points] + [k for _, k in boxes]
               + [k for _, k, _ in edges])

    def build():
        t0 = time.perf_counter()
        steps = uc.build_kernels(kernels)
        return guard, steps, time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(build)
    pool.shutdown(wait=False)
    return future


def phase_unrolled_guard(pkg, dev="cuda", label="tree", built=None):
    """U1 and U2 of `pkg` against their plain versions beyond the
    stand-in (`_guard_tapes`): U1 over one launch of the op tapes (each
    a program on its segment of slots, held at `_matrix_tolerance` of
    its op) and over each combined tape alone (one program a launch;
    exact but for the "other ops" tape, 2e-4), U2 under all three
    epilogues on the combined tapes, flags and words exactly (the
    violation flags against `_violation_words`), and capture and
    violation on the exact ops again with the words in global memory (as
    a tape's past `SHARED_LIMIT` are); over 256^2 in 8-px tiles at two
    matrices, with the vars a and b taking the values of `_guard_pairs`.
    All kernels in one build batch, `built` (`start_guard_build`) or
    started here. Returns the phase's seconds, the build's wait
    included."""
    t_start = time.perf_counter()
    guard, steps, build_s = (built or start_guard_build(pkg)).result()
    (uc, op_tapes, comb, kinds, matrix, singles, intervals, voxels3,
     intervals3, points, boxes, edges) = guard
    n_t = GUARD_SIZE // UNROLLED_T0
    gx, gy = np.meshgrid(np.arange(n_t) * UNROLLED_T0,
                         np.arange(n_t) * UNROLLED_T0)
    x0 = torch.tensor(gx.reshape(-1), dtype=torch.float32, device=dev)
    y0 = torch.tensor(gy.reshape(-1), dtype=torch.float32, device=dev)
    n = x0.shape[0]
    valid = torch.arange(n, device=dev) % 9 != 4
    P = len(op_tapes)
    seg = [i * (n // P) for i in range(P)]
    seg_op = np.repeat(np.arange(P), np.diff(seg + [n]))
    tol = torch.tensor([_matrix_tolerance(name) for name, _ in op_tapes],
                       device=dev)[torch.from_numpy(seg_op).to(dev)][:, None]
    rng = np.random.default_rng(10)
    errs = {}
    launches = 0
    n_pairs = 0
    for mat, pairs in zip(_guard_matrices(), _guard_pairs()):
        n_pairs += len(pairs)
        for a_val, b_val in pairs:
            params = uc.params_tensor(
                torch.tensor(mat, device=dev), torch.zeros((), device=dev),
                torch.tensor([0.0, 0.0, a_val, b_val], dtype=torch.float32,
                             device=dev))
            kw = dict(tw=UNROLLED_T0, pp=UNROLLED_T0 * UNROLLED_T0)
            args = (x0, y0, valid, params)
            got = uc.unrolled_float(matrix, *args, seg, **kw)
            want = uc.unrolled_float_plain(matrix, *args, seg, **kw)
            errs["op matrix"] = max(errs.get("op matrix", 0.0), check(
                f"unrolled guard ({label}) U1 op matrix at a={a_val}, "
                f"b={b_val}", got, want, tol, tol))
            for name, k, t in singles:
                got = uc.unrolled_float(k, *args, [0], **kw)
                want = uc.unrolled_float_plain(k, *args, [0], **kw)
                errs[name] = max(errs.get(name, 0.0), check(
                    f"unrolled guard ({label}) U1 {name} at a={a_val}, "
                    f"b={b_val}", got, want, t, t))
            captured = {}
            for name, epi, ks in intervals:
                u = (_violation_words(captured[name], rng)
                     if epi == "violation" else None)
                want = uc.unrolled_interval_plain(ks[0], x0, y0, params,
                                                  float(UNROLLED_T0), u)
                if epi == "capture":
                    captured[name] = want[2]
                for k in ks:
                    got = uc.unrolled_interval(k, x0, y0, params,
                                               float(UNROLLED_T0), u)
                    for g, w_ in zip(got, want):
                        if (g is None) != (w_ is None) or (
                                g is not None and not torch.equal(g, w_)):
                            raise Failed(
                                f"unrolled guard ({label}) U2 {name} {epi}"
                                f"{' (global words)' if k is not ks[0] else ''}"
                                f" at a={a_val}, b={b_val}: flags or words "
                                f"differ from plain")
                launches += len(ks)
            launches += 1 + len(singles)
    torch.cuda.synchronize()
    launches3 = _guard3d(uc, voxels3, intervals3, label, dev)
    launches3 += _guard_mesher(uc, points, boxes, label, dev)
    launches3 += _guard_mesher_levels(uc, boxes, edges, label, dev)
    secs = time.perf_counter() - t_start
    log(f"unrolled guard ({label}): {P} op tapes in one U1 launch, "
        f"{len(singles)} combined tapes ({', '.join(n for n, _, _ in comb)}; "
        f"{', '.join(str(len(t)) for _, t, _ in comb)} rows) through U1 and "
        f"U2 x {len(uc.EPILOGUES)} epilogues (and capture and violation "
        f"of the {comb[0][0]} with the words in global memory), {n_pairs} "
        f"var pairs over two matrices, {launches} launches: all equal to "
        f"plain "
        f"(U2 flags and words exactly); U1 max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f"; {len(steps)} nvcc steps in {build_s:.1f} s"
        + (" (started with the run, beside the phases before this)"
           if built else "") + f", phase {secs:.1f} s"
        + (f"; the 3D and mesher variants: {launches3} launches, see above"
           if launches3 else ""))
    return secs


def _guard_mesher(uc, points, boxes, label, dev):
    """Phase 6e for the mesher's kernels: U1-P under both epilogues and
    U2-B on the combined tapes, over the model-space points of the 2D
    guard's 256^2 pixels (a [4, 16384] list, 12,000 live columns) and
    the boxes of its 8-px tiles (a [2, 512] list, 400 live columns)
    under its two matrices, with the vars of `_guard_pairs`, against the
    plain versions: distances exactly (the transcendental tape at its
    2e-4, as U1), signs exactly but where the plain distance of the
    point lies within that tolerance of 0 on that tape, proofs exactly
    (dead lanes included: 0, False, no proof). Returns the launches."""
    if not points:
        return 0
    n, T0 = GUARD_SIZE, float(UNROLLED_T0)
    g = torch.arange(n * n, device=dev)
    px, py = (g % n).float(), (g // n).float()
    t = torch.arange(0, n, UNROLLED_T0, dtype=torch.float32, device=dev)
    ty, tx = (a.reshape(-1) for a in torch.meshgrid(t, t, indexing="ij"))
    count = torch.tensor([12000], dtype=torch.int32, device=dev)
    bcount = torch.tensor([400], dtype=torch.int32, device=dev)
    dist = {name: k for name, k, _ in points if k.epilogue == "distance"}
    launches, witnessed = 0, 0
    for mat, pairs in zip(_guard_matrices(), _guard_pairs()):
        m = torch.tensor(mat, device=dev)

        def row(r, a, b):
            return m[r, 0] * a + m[r, 1] * b + m[r, 3]

        x, y = (row(r, px, py).reshape(4, -1) for r in (0, 1))
        z = torch.zeros_like(x)
        lo, hi = [], []
        for r in (0, 1):
            c0, c1 = row(r, tx, ty), row(r, tx + T0, ty + T0)
            lo.append(torch.minimum(c0, c1).reshape(2, -1))
            hi.append(torch.maximum(c0, c1).reshape(2, -1))
        lo.append(torch.zeros_like(lo[0]))
        hi.append(torch.zeros_like(lo[0]))
        for a_val, b_val in pairs:
            params = torch.tensor([0.0, 0.0, a_val, b_val],
                                  dtype=torch.float32, device=dev)
            at = f"at a={a_val}, b={b_val}"
            for name, k, tol in points:
                got = uc.unrolled_points(k, x, y, z, params, count)
                want = uc.unrolled_points_plain(k, x, y, z, params, count)
                if k.epilogue == "distance":
                    check(f"unrolled guard ({label}) U1-P {name} {at}", got,
                          want, tol, tol)
                    continue
                bad = got != want
                if bad.any():
                    d = uc.unrolled_points_plain(dist[name], x, y, z, params,
                                                 count)[bad]
                    if tol == 0 or not bool((d.abs() <= tol).all()):
                        raise Failed(
                            f"unrolled guard ({label}) U1-P {name} signs {at}: "
                            f"{int(bad.sum())} differ from plain (plain "
                            f"distances there {d[:4].tolist()})")
                    witnessed += int(bad.sum())
            for name, k in boxes:
                got = uc.unrolled_interval_boxes(k, lo, hi, params, bcount)
                want = uc.unrolled_interval_boxes_plain(k, lo, hi, params,
                                                        bcount)
                if not all(torch.equal(g_, w_) for g_, w_ in zip(got, want)):
                    raise Failed(f"unrolled guard ({label}) U2-B {name} {at}: "
                                 f"proofs differ from plain")
            launches += len(points) + len(boxes)
    torch.cuda.synchronize()
    log(f"unrolled guard ({label}) mesher: U1-P (distance, sign) and U2-B "
        f"on the {len(boxes)} combined tapes over {n}^2 points and "
        f"{len(tx)} boxes with live counts, two matrices, {launches} "
        f"launches: distances, signs and proofs equal to plain "
        f"({witnessed} signs of the transcendental tape within its "
        f"tolerance of the surface)")
    return launches


#: the mesher guard's lattice (cells of a depth-GUARD_DEPTH octree), its
#: crossing list and its parents: slots / parents, live among them
GUARD_DEPTH = 7
GUARD_SLOTS, GUARD_SLOTS_LIVE = 4096, 3000
GUARD_PARENTS, GUARD_PARENTS_LIVE = 2048, 1500
#: the edge search's (samples, rounds): the mesher's, and two that take
#: a group of 8 lanes and two chunks of a warp's lanes
GUARD_SEARCHES = ((16, 4), (5, 3), (40, 2))


def _guard_world_matrices():
    """World -> model [3, 4] matrices of the mesher guard: an oblique
    rotation with an offset (coefficients of both signs), and the same
    scaled by 1e30 (so that squares and products overflow)."""
    m = _oblique()[:3].astype(np.float32)
    m[:, 3] = (0.25, -0.125, 0.5)
    wide = m.copy()
    wide[:2] *= np.float32(1e30)
    return m, wide


def _guard_mesher_levels(uc, boxes, edges, label, dev):
    """Phase 6e for the mesher's redesigned kernels on the combined
    tapes: U1-P's edge search (`unrolled_edges`) over a random crossing
    list of cells of a depth-GUARD_DEPTH lattice (random corner masks
    and edges, dead slots past the live count) at each of
    GUARD_SEARCHES (the first at every var pair, the others at every
    fourth), and U2-B on a level (`level_active`) over random
    parents (some keys -1, dead parents past the count), under both
    `_guard_world_matrices`, with the vars of `_guard_pairs`, against
    the plain versions: every output of the search exactly (NaN where
    plain is NaN) but on the transcendental tape, where a slot's
    brackets may differ only where the plain search met a sample within
    its tolerance of 0 (the distance then within it); the flags and the
    children's keys exactly. Returns the launches."""
    if not edges:
        return 0
    rng = np.random.default_rng(16)
    G, ks = 1 << GUARD_DEPTH, uc.LATTICE_KS

    def keys(n, g):
        c = rng.integers(0, g, (3, n))
        return (c[0] * ks + c[1]) * ks + c[2]

    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)  # noqa: E731
    key = i32(keys(GUARD_SLOTS, G))
    mask = i32(rng.integers(1, 255, GUARD_SLOTS))
    slot = i32(12 * rng.integers(0, 1 << 16, GUARD_SLOTS)
               + rng.integers(0, 12, GUARD_SLOTS))
    count = i32([GUARD_SLOTS_LIVE])
    pk = keys(GUARD_PARENTS, G // 2)
    pk[rng.random(GUARD_PARENTS) < 0.1] = -1
    parents, n_in = i32(pk), i32([GUARD_PARENTS_LIVE])
    launches, witnessed = 0, 0
    for m, pairs in zip(_guard_world_matrices(), _guard_pairs()):
        mat = torch.tensor(m, device=dev)
        A = torch.tensor(m[:, :3], device=dev)
        pos, neg = torch.clamp_min(A, 0.0), torch.clamp_max(A, 0.0)
        off3 = mat[:, 3].contiguous()
        for i, (a_val, b_val) in enumerate(pairs):
            params = torch.tensor([0.0, 0.0, a_val, b_val],
                                  dtype=torch.float32, device=dev)
            at = f"at a={a_val}, b={b_val}"
            for (name, k, tol), (_, kb) in zip(edges, boxes):
                # the mesher's search at every pair, the others at every
                # fourth
                for samples, rounds in GUARD_SEARCHES[:1 if i % 4 else 3]:
                    kw = dict(samples=samples, rounds=rounds)
                    args = (k, key, mask, slot, count, mat, params, 2.0 / G)
                    got = uc.unrolled_edges(*args, **kw)
                    want, near = uc.unrolled_edges_plain(*args, margin=True,
                                                         **kw)
                    what = (f"unrolled guard ({label}) U1-P edges {name} "
                            f"{samples} x {rounds} {at}")
                    if tol == 0:
                        check(what, got, want, 0.0, 0.0)
                    else:
                        same = ((got[:8] == want[:8])
                                | (got[:8].isnan() & want[:8].isnan())).all(0)
                        if not bool((same | (near <= tol)).all()):
                            raise Failed(f"{what}: brackets differ from plain "
                                         f"away from the surface")
                        check(what, got[8][same], want[8][same], tol, tol)
                        witnessed += int((~same).sum())
                    launches += 1
                got = uc.level_active(kb, parents, n_in, 1.0 / G, pos, neg,
                                      off3, params)
                want = uc.level_active_plain(kb, parents, n_in, 1.0 / G, pos,
                                             neg, off3, params)
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise Failed(f"unrolled guard ({label}) U2-B level "
                                 f"{name} {at}: flags or keys differ from "
                                 f"plain")
                launches += 1
    torch.cuda.synchronize()
    log(f"unrolled guard ({label}) mesher levels and edges: U1-P's edge "
        f"search ({GUARD_SLOTS} slots, {GUARD_SLOTS_LIVE} live, at (samples, "
        f"rounds) {GUARD_SEARCHES[0]}, and {GUARD_SEARCHES[1:]} at every "
        f"fourth var pair) and U2-B's levels ({GUARD_PARENTS} "
        f"parents, {GUARD_PARENTS_LIVE} live) on the {len(edges)} combined "
        f"tapes, two matrices, {launches} launches: equal to plain "
        f"({witnessed} slots of the transcendental tape whose search met a "
        f"sample within its tolerance of the surface)")
    return launches


#: the 3D guard's volume edge and subtile edge
GUARD3 = 64
GUARD3_SUB = 8


def _guard_matrices3():
    """Screen -> model matrices of the 3D guard's 64^3 volume: the unit
    cube seen through a perspective w row (w = 1 + 0.3 z), and the same
    with x and y scaled by 1e30 (so squares and products overflow)."""
    n = GUARD3
    unit = np.array([[2.0 / n, 0, 0, -1.0], [0, -2.0 / n, 0, 1.0],
                     [0, 0, 2.0 / n, -1.0], [0, 0, 0, 1]], np.float32)
    persp = np.eye(4, dtype=np.float32)
    persp[3, 2] = 0.3
    p = (persp @ unit).astype(np.float32)
    wide = p.copy()
    wide[:2] *= np.float32(1e30)
    return p, wide


def _voxel_distance(uc, kern, params, px, py, pz):
    """The plain float distance of `kern`'s tape at screen points."""
    from fidget_tpu_torch.eval.unrolled_fast import eval_tape_float_fast
    from fidget_tpu_torch.render.transform import transform_points

    pts = transform_points(params[:16].reshape(4, 4), px, py, pz)
    inputs = [params[uc.PARAM_VARS + i].expand(px.shape)
              for i in range(kern.V)]
    for kind, plane in zip("xyz", pts):
        idx = kern.axis_of.get(kind)
        if idx is not None:
            inputs[idx] = plane
    return eval_tape_float_fast(kern.tapes[0], inputs)[0]


def _depth_witness(uc, k, params, tol, got, want, bx, by, label,
                   y_base=0.0):
    """Holds U1-3D's depth columns `got` to plain's `want` ([n, sub, sub],
    or a slab's floor [H, W] with bx / by None, its first row y_base):
    bit for bit, or on a tape with a tolerance only where the plain
    distance of the voxel the two disagree on lies within it of 0.
    Returns the columns witnessed."""
    bad = (got != want).nonzero()
    if not len(bad):
        return 0
    z = torch.maximum(got, want)[tuple(bad.T)] - 1
    if bx is None:
        px, py = bad[:, 1].float(), bad[:, 0].float() + y_base
    else:
        slot, vy, vx = bad.T
        px, py = bx[slot] + vx.float(), by[slot] + vy.float()
    d = _voxel_distance(uc, k, params, px, py, z.float())
    if tol == 0 or not bool((d.abs() <= tol).all()):
        raise Failed(f"{label}: {len(bad)} depth columns differ from plain "
                     f"(plain distances there {d[:4].tolist()})")
    return len(bad)


def _covering_pairs(pairs):
    """The indices of every other var pair of `pairs` (`_guard_pairs`)
    where those pairs still take every value that `pairs` takes (as a or
    as b; all of them where they do not)."""
    def values(ps):
        return {repr(v) for p in ps for v in p}

    half = range(0, len(pairs), 2)
    if values(pairs[i] for i in half) == values(pairs):
        return set(half)
    return set(range(len(pairs)))


def _guard_worklists(dev):
    """Phase 6e's stratum worklists for U1-3D's frame entry over the 64^3
    volume taken as one stratum of 64^3 roots: (label, sub, nl, order,
    count, z_lo, y_base, floor) with fewer active subtiles than slots,
    more than slots on a slab of the lower 32 rows (y_base 32), and
    none, at subtile edges 8 and 16."""
    from fidget_tpu_torch.render.render3d import _compact_stratum

    out = []
    rng = np.random.default_rng(17)
    for sub in (GUARD3_SUB, 2 * GUARD3_SUB):
        nl = GUARD3 // sub
        for label, rows, over, share in (("below cap", GUARD3, 1.3, 0.3),
                                         ("over cap, slab", GUARD3 // 2, 0.7,
                                          0.3),
                                         ("none", GUARD3, 1.0, 0.0)):
            ny2, nx2 = rows // sub, GUARD3 // sub
            act = torch.from_numpy(rng.random(nl * ny2 * nx2) < share).to(dev)
            count = int(act.sum())
            cap = max(8, int(max(count, 8) * over))
            order = _compact_stratum(act, nl=nl, ny2=ny2, nx2=nx2,
                                     cap_s=cap, decode=False)["order"]
            floor = torch.from_numpy(rng.integers(
                0, GUARD3 // 2, (rows, GUARD3)).astype(np.int32)).to(dev)
            out.append((f"{label}, sub {sub}", sub, nl, order,
                        act.sum(), torch.zeros(1, device=dev),
                        float(GUARD3 - rows), floor))
    return out


def _guard3d(uc, voxels3, intervals3, label, dev):
    """Phase 6e for the 3D variants on the combined tapes, at the two
    `_guard_matrices3` with the vars of `_guard_pairs`, against the plain
    versions: U1-3D's explicit entry over every 8^3 subtile of a 64^3
    volume (every ninth slot invalid) and, where the package has them,
    its frame entry on `_guard_worklists`, both at every lanes-a-column
    group that fits the subtile; U2-3D's explicit entry over the same
    subtiles' boxes at edges 8 and 32 and its frame entry over the
    volume's roots of 32 and 16 with their subtiles of 8, at every layout
    (`intervals3` holds one kernel a layout). Proofs, depths and floors
    bit for bit; on the tape of transcendentals (tolerance 2e-4, as U1
    there) a depth column may differ only where the plain distance of
    the voxel in question lies within that tolerance of 0. Returns the
    launches."""
    if not voxels3:
        return 0
    frame_entries = hasattr(uc, "unrolled_voxel_fold")
    groups = getattr(uc, "VOXEL_GROUPS", (None,))
    sub = GUARD3_SUB
    g = np.arange(GUARD3 // sub) * sub
    gz, gy, gx = np.meshgrid(g, g, g, indexing="ij")
    bx, by, bz = (torch.tensor(a.reshape(-1), dtype=torch.float32,
                               device=dev) for a in (gx, gy, gz))
    n = bx.shape[0]
    valid = torch.arange(n, device=dev) % 9 != 4
    worklists = _guard_worklists(dev) if frame_entries else []
    roots = {}
    if frame_entries:
        for ts in (4 * sub, 2 * sub):
            t = np.arange(GUARD3 // ts) * ts
            tz, ty, tx = np.meshgrid(t, t, t, indexing="ij")
            roots[ts] = tuple(torch.tensor(a.reshape(-1), dtype=torch.float32,
                                           device=dev) for a in (tx, ty, tz))
    by_tape = {}
    for name, k in intervals3:
        by_tape.setdefault(id(k.tape), []).append((name, k))
    launches, witnessed, hit = 0, 0, 0
    for mat, pairs in zip(_guard_matrices3(), _guard_pairs()):
        # the frame entries' own code (decoding, corners, groups, the
        # fold) does not see the vars: they run at every other pair, which
        # still takes every SPICY value and denormal at each matrix
        framed = _covering_pairs(pairs)
        for i, (a_val, b_val) in enumerate(pairs):
            frame_pair = i in framed
            params = uc.params_tensor(
                torch.tensor(mat, device=dev), torch.zeros((), device=dev),
                torch.tensor([0.0, 0.0, a_val, b_val], dtype=torch.float32,
                             device=dev))
            at = f"at a={a_val}, b={b_val}"
            for name, k, tol in voxels3:
                want = uc.unrolled_voxel_depth_plain(k, bx, by, bz, valid,
                                                     params, sub=sub)
                hit += int((want > 0).sum())
                for G in groups:
                    if G is not None and G > sub:
                        continue
                    kw = {} if G is None else {"group": G}
                    got = uc.unrolled_voxel_depth(k, bx, by, bz, valid,
                                                  params, sub=sub, **kw)
                    witnessed += _depth_witness(
                        uc, k, params, tol, got, want, bx, by,
                        f"unrolled guard ({label}) U1-3D {name} group {G} "
                        f"{at}")
                    launches += 1
                for wl, s_, nl, order, count, z_lo, y_base, floor in \
                        (worklists if frame_pair else ()):
                    want_f = uc.unrolled_voxel_fold_plain(
                        k, order, count, z_lo, params, floor.clone(),
                        sub=s_, nl=nl, y_base=y_base)
                    for G in groups:
                        if G > s_:
                            continue
                        got_f = uc.unrolled_voxel_fold(
                            k, order, count, z_lo, params, floor.clone(),
                            sub=s_, nl=nl, y_base=y_base, group=G)
                        witnessed += _depth_witness(
                            uc, k, params, tol, got_f, want_f, None, None,
                            f"unrolled guard ({label}) U1-3D fold {name} "
                            f"({wl}) group {G} {at}", y_base)
                        launches += 1
            for ks in by_tape.values():  # a tape's layouts, one plain
                for edge in (sub, 4 * sub):
                    want = uc.unrolled_interval3_plain(ks[0][1], bx, by, bz,
                                                       params, edge)
                    for name, k in ks:
                        got = uc.unrolled_interval3(k, bx, by, bz, params,
                                                    edge)
                        if not all(torch.equal(g_, w_)
                                   for g_, w_ in zip(got, want)):
                            raise Failed(
                                f"unrolled guard ({label}) U2-3D {name} edge "
                                f"{edge} {at}: proofs differ from plain")
                        launches += 1
                for ts, (x0, y0, z0) in (roots.items() if frame_pair
                                         else ()):
                    want = uc.unrolled_proofs3_plain(ks[0][1], x0, y0, z0,
                                                     params, ts, sub)
                    for name, k in ks:
                        got = uc.unrolled_proofs3(k, x0, y0, z0, params, ts,
                                                  sub)
                        if not all(torch.equal(g_, w_)
                                   for g_, w_ in zip(got, want)):
                            raise Failed(
                                f"unrolled guard ({label}) U2-3D frame entry "
                                f"{name} roots {ts} {at}: proofs differ from "
                                f"plain")
                        launches += 1
    torch.cuda.synchronize()
    log(f"unrolled guard ({label}) 3D: U1-3D (explicit"
        + (f" and frame entries at groups {groups}, {len(worklists)} "
           f"worklists, the frame entries at every other var pair, which "
           f"take every value" if frame_entries else "")
        + f") and U2-3D (edges {sub}, {4 * sub}"
        + (f"; frame entry over roots {sorted(roots)}" if roots else "")
        + f"; {len(intervals3)} kernels: layouts a tape) on the "
        f"{len(voxels3)} combined tapes over the {n} subtiles of "
        f"{GUARD3}^3, perspective and overflowing matrices, {launches} "
        f"launches: U2-3D proofs and U1-3D depths and floors equal to plain "
        f"({hit} hit columns; {witnessed} columns of the transcendental tape "
        f"within its tolerance of the surface)")
    return launches


def _wait_refresh(r, timeout=600):
    """Waits for a union plan's background refresh (and its nvcc) to end."""
    from fidget_tpu_torch.render import unrolled2d as u2

    st = u2.state(r)
    t0 = time.time()
    while any(st.refreshing.values()):
        if time.time() - t0 > timeout:
            raise Failed("a union plan refresh did not finish")
        time.sleep(0.2)


def phase_unrolled(r, cuda, std_images, brutes, build, rows):
    """The per-shape compiled path on the stand-in at 1024^2 over the
    three views: `render_unrolled(leaf="union")`, `leaf="full"` with
    `cull` unrolled and interp, and `render_dense`, each with the launch
    counts set to 0 before its three frames and read after; occupancy
    equal to `render_brute` and to `render()`'s, distances allclose
    (1e-5, 1e-6) where evaluated; U1 and U2 on the inputs each mode gave
    them against their plain versions; warm frames timed (median and min ms, Mpix/s, device busy share and ops
    a frame). Adds the U1 and U2 rows to `rows`."""
    from fidget_tpu_torch.render import unrolled2d as u2

    modes = {
        "union": lambda v: r.render_unrolled(v, leaf="union"),
        "full": lambda v: r.render_unrolled(v, leaf="full"),
        "full-interp": lambda v: r.render_unrolled(v, leaf="full",
                                                   cull="interp"),
        "dense": lambda v: r.render_dense(v),
    }
    captured = {}
    saved = {n: getattr(u2, n) for n in UNROLLED_KERNELS}
    current = [None]

    def recorder(name):
        def call(*args, **kwargs):
            if current[0] is not None:
                captured[(current[0], name)] = (args, kwargs)
            return saved[name](*args, **kwargs)
        return call

    totals = dict.fromkeys(UNROLLED_KERNELS, 0)
    n_frames = 0
    timing = {}
    for n in UNROLLED_KERNELS:
        setattr(u2, n, recorder(n))
    try:
        for label, fn in modes.items():
            current[0] = label
            fn(FRAMES[0])  # warm-up; its inputs feed the kernel checks
            current[0] = None
            _wait_refresh(r)
            torch.cuda.synchronize()
            cuda.reset_launches()
            images, stats = [], []
            for view in FRAMES:
                images.append(fn(view))
                stats.append(getattr(r, "union_stats", None))
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
            log(f"unrolled {label}: launches over {len(FRAMES)} frames: "
                f"{launches}")
            missing = [k for k in UNROLLED_MODES[label] if not launches.get(k)]
            extra = set(launches) - set(UNROLLED_MODES[label])
            if missing or extra:
                raise Failed(f"unrolled {label} frames launched {launches}")
            for k in UNROLLED_KERNELS:
                totals[k] += launches.get(k, 0)
            n_frames += len(FRAMES)
            for k, (img, view) in enumerate(zip(images, FRAMES)):
                ink, evaluated = check_frame(r, img, view, brutes[k])
                if not torch.equal(img.inside(), std_images[k].inside()):
                    raise Failed(f"unrolled {label} frame {k}: occupancy "
                                 f"differs from render()'s")
                fb = ""
                if label == "union":
                    s = stats[k]
                    fb = (f"; fallback {s['n_fallback']} of {s['n_active']} "
                          f"active tiles "
                          f"({s['n_fallback'] / max(1, s['n_active']):.4f})")
                log(f"unrolled {label} frame {k}: occupancy equals "
                    f"render_brute and render() ({ink:.4f} inside, "
                    f"{evaluated:.3f} of pixels evaluated){fb}")
            _wait_refresh(r)
            fn(FRAMES[1])  # settle the plan at the timed view
            _wait_refresh(r)
            med, mn = _median_ms(lambda: fn(FRAMES[1]), 10)
            mpix = SIZE * SIZE / (med * 1e-3) / 1e6
            log(f"unrolled {label} warm frame (view 1): median {med:.3f} ms, "
                f"min {mn:.3f} ms, {mpix:.1f} Mpix/s (host clock, "
                f"synchronized, 10 frames)")
            busy = _device_busy(lambda: fn(FRAMES[1]), 5)
            _log_busy(f"unrolled {label}", busy, med)
            _wait_refresh(r)
            timing[label] = {"median_ms": med, "min_ms": mn, "mpix_s": mpix,
                             "device_busy_ms": None if busy is None else busy[0],
                             "device_ops": None if busy is None else busy[2]}
            if label == "union":
                s = r.union_stats
                timing[label]["fallback_share"] = (
                    s["n_fallback"] / max(1, s["n_active"]))
    finally:
        current[0] = None
        for n, f in saved.items():
            setattr(u2, n, f)

    measured = {}
    for (label, name), (args, kwargs) in sorted(captured.items()):
        measured[(label, name)] = _measure_unrolled(label, name, args, kwargs)

    for name in UNROLLED_KERNELS:
        head = measured[("union", name)]
        rows[name] = {
            "name": name, "route": "cuda", "source": UNROLLED_SOURCE,
            "replaces": UNROLLED_REPLACES, "launches": totals[name],
            "launches_per_frame": totals[name] / n_frames, **head,
            "library_ms": None,
            "at": {f"{label}": m for (label, n), m in measured.items()
                   if n == name and label != "union"},
            "build": {"cold_s": build["cold_s"], "cached_s": build["cached_s"],
                      "spill_bytes": build["spill_bytes"]},
            "frames": timing, "union_plan_ms": build["plan_ms"],
        }


def phase_grad_unrolled(rp, vars_, rows, N=SIZE, reps=5):
    """The shape-parameter gradient through the per-shape compiled
    frames of the parametrized stand-in: `_dense` and the pixel_perfect
    full-leaf unrolled frame (`_frame_unrolled`, K1 cull); loss
    sum(img^2) / N^2 by backward() held to phase 10's loss through the
    interpreter frame `_frame` on the same tape and vector (rtol 1e-4:
    all three evaluate every pixel), exactly 0 at the axis entries of
    the var vector, which the transform overwrites, and held to
    `torch.func.jacfwd` (rtol 1e-5, atol 1e-6) and central differences
    (h = 1e-2; rtol 2e-2, atol 1e-5, against gradients of 3e-4 to
    6e-3); forward + backward step times. Each step's Jacobian is one K4
    launch of 3 planes (the value and the two shape parameters' tangents;
    the axis inputs are not differentiated), held to the plain version
    on the unrolled frame's inputs."""
    from fidget_tpu_torch.eval import cuda, interp

    dev = rp.device
    mat = rp._mat4(None)
    vec0 = rp._var_vec(vars_)
    V = len(vec0)
    axes = [rp.axis_of[k] for k in ("x", "y", "z") if k in rp.axis_of]
    v = torch.tensor(vec0, device=dev, requires_grad=True)
    ((rp._frame(mat, 0.0, v, pixel_perfect=True)[0][:N, :N] ** 2).sum()
     / (N * N)).backward()
    g_ref = v.grad.double().cpu().numpy()
    if not np.any(g_ref) or np.any(g_ref[axes]):
        raise Failed(f"_frame's gradient {g_ref}: all zero, or not 0 at "
                     f"the axis entries {axes}")
    frames = {
        "dense": lambda v: rp._dense(mat, 0.0, v),
        "unrolled": lambda v: rp._frame_unrolled(
            mat, 0.0, v, pixel_perfect=True, cull="interp")[0][:N, :N],
    }
    for label, frame in frames.items():
        loss = lambda v: (frame(v) ** 2).sum() / (N * N)

        def step():
            v = torch.tensor(vec0, device=dev, requires_grad=True)
            loss(v).backward()
            return v.grad

        captured = {}
        with capture_kernel_inputs([(interp, "interp_grad", _k4_key)],
                                   captured):
            step()
        torch.cuda.synchronize()
        cuda.reset_launches()
        g_rev = step().double().cpu().numpy()
        torch.cuda.synchronize()
        k4 = cuda.LAUNCHES["interp_grad"]
        if k4 != 1 or list(captured) != ["interp_grad@P3"]:
            raise Failed(f"{label}: a step launched K4 {k4} times, widths "
                         f"{list(captured)}, not once at 3 planes")
        g_fwd = torch.func.jacfwd(loss)(torch.tensor(vec0, device=dev))
        g_fwd = g_fwd.double().cpu().numpy()
        if np.any(g_rev[axes]):
            raise Failed(f"{label}: reverse {g_rev} is not 0 at the axis "
                         f"entries {axes}")
        if not np.allclose(g_rev, g_ref, rtol=1e-4, atol=0.0):
            raise Failed(f"{label}: reverse {g_rev} differs from _frame's "
                         f"{g_ref}")
        if not np.allclose(g_rev, g_fwd, rtol=1e-5, atol=1e-6):
            raise Failed(f"{label}: reverse {g_rev} differs from forward "
                         f"mode {g_fwd}")
        fd = np.zeros(V)
        with torch.no_grad():
            for k in range(V):
                e = np.zeros(V, np.float32)
                e[k] = H_FD
                lo = float(loss(torch.tensor(vec0 - e, device=dev)))
                hi = float(loss(torch.tensor(vec0 + e, device=dev)))
                fd[k] = (hi - lo) / (2 * H_FD)
        if not np.allclose(g_rev, fd, rtol=2e-2, atol=1e-5):
            raise Failed(f"{label}: reverse {g_rev} differs from central "
                         f"differences {fd}")
        step_ms = _median_ms(step, reps)
        log(f"gradient through the {label} frame: reverse {g_rev.tolist()} "
            f"(_frame's {g_ref.tolist()}, axis entries {axes} exactly 0), "
            f"jacfwd {g_fwd.tolist()}, central differences {fd.tolist()}; "
            f"step {step_ms[0]:.3f} ms median ({step_ms[1]:.3f} min), one "
            f"K4 launch of 3 planes")
        if label == "unrolled":
            args, kwargs = captured["interp_grad@P3"]
            rows["interp_grad"]["at_unrolled_gradient"] = {"P3": {
                "launches": k4, "step_ms": step_ms[0],
                **_measure_sliced("interp_grad@P3 in the unrolled gradient "
                                  "step", "interp_grad", args, kwargs),
                "geometry": _geometry("interp_grad", tuple(args[4].shape),
                                      kwargs),
            }}


def _same_or_nan(got, want):
    """Bit for bit, any NaN matching any NaN."""
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | (torch.isnan(got) & torch.isnan(want))).all())


def _interleave_cases(dev):
    """(label, args, nf, s0) of the inputs phase 12 holds P2 to its plain
    version on."""
    from fidget_tpu_torch.demos import exp_interleave as p2
    from fidget_tpu_torch.scenes import (
        interleave_op_arena,
        mixed_class_tapes,
        prefixed_random_tapes,
    )

    on = lambda arrays: [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for a in arrays]
    ref = p2.split_streams(*p2.reference_inputs(dev))
    w1, w2, imm, rng = prefixed_random_tapes(2 * 64, p2.L_REF, p2.NF_REF, 3,
                                             seed=7)
    vars_ = rng.normal(size=(64, 3, p2.S0_REF, 128)).astype(np.float32)
    full = np.full(64, p2.NF_REF + p2.L_REF, np.int32)
    short = rng.integers(0, p2.NF_REF + p2.L_REF, 64).astype(np.int32)
    pre = (w1[:64], w2[:64], imm[:64], w1[64:], w2[64:], imm[64:])
    # classed and switch rows in every chunk, at an odd length
    L_mix = p2.L_REF + 1
    m1, m2, mimm, mrng = mixed_class_tapes(2 * 64, L_mix, p2.NF_REF, 3,
                                           seed=8)
    mvars = mrng.normal(size=(64, 3, p2.S0_REF, 128)).astype(np.float32)
    mixed = (m1[:64], m2[:64], mimm[:64], m1[64:], m2[64:], mimm[64:],
             np.full(64, p2.NF_REF + L_mix, np.int32), mvars)
    *ops, ops_vars, _ = interleave_op_arena(8, past_nf=True)
    ops_lens = np.full(ops[0].shape[0], ops[0].shape[1], np.int32)
    return [
        ("reference tapes (random_tape, registers from 0)", ref, p2.NF_REF,
         p2.S0_REF),
        ("INPUT-prefixed random tapes", on((*pre, full, vars_)), p2.NF_REF,
         p2.S0_REF),
        ("the same with lens short of Lcap", on((*pre, short, vars_)),
         p2.NF_REF, p2.S0_REF),
        ("one tape per opcode 0-30, 31, 40, 127, registers past nf",
         on((*ops, ops_lens, ops_vars)), 8, 8),
        ("classed and switch rows mixed in every chunk, odd length",
         on(mixed), p2.NF_REF, p2.S0_REF),
    ]


def _smem_floor_ms(lane_rows):
    """The shared-memory floor of an interpreter whose register file lies
    in shared memory: SMEM_ROW_BYTES a lane and row over the card's SMs
    at SMEM_BYTES_PER_SM_CLOCK and the SM clock."""
    return (lane_rows * SMEM_ROW_BYTES
            / (SMEM_BYTES_PER_SM_CLOCK * SCHEDULERS / 4 * SM_CLOCK_HZ) * 1e3)


def phase_interleave(cuda, dev="cuda"):
    """12. The probe P2 (`fidget_tpu_torch.demos.exp_interleave`): the
    two-stream kernel against its plain version bit for bit on the
    reference's tapes at its shapes (T / 2 = 128 instances, Lcap 1024,
    nf 32, S0 32), on INPUT-prefixed random tapes with full and short
    lens (equal to each other too), on one tape per opcode with
    immediates, an aux past V and registers past nf, and on tapes that
    mix classed and switch rows in every chunk (odd length), each at
    the geometry's lanes a thread and at 4, 2 and 1; then the probe's
    `main()` with the launch counts set to 0 before and read after
    (variant A launches K3, variant B P2); then A, B and B at 4, 2 and 1
    lanes a thread timed by CUDA events and the profiler's device time,
    the bound of B, its scheduler-slot and shared-memory floors and the
    plain version's time."""
    from fidget_tpu_torch.demos import exp_interleave as p2
    from fidget_tpu_torch.eval.interp import interp_float

    dev = torch.device(dev)
    results = {}
    for label, args, nf, s0 in _interleave_cases(dev):
        want = p2.interp_float2_plain(*args, nf=nf, s0=s0)
        for r in (0, 4, 2, 1):  # the geometry's choice, then each layout
            got = p2.interp_float2(*args, nf=nf, s0=s0, lanes_per_thread=r)
            if not _same_or_nan(got, want):
                raise Failed(f"interp_float2 on {label} at lanes_per_thread "
                             f"{r} differs from plain")
        results[label] = got
        log(f"interp_float2 on {label} {tuple(args[7].shape)}: bit-equal to "
            f"plain; {int(torch.isfinite(got).sum())} of {got.numel()} "
            f"outputs finite")
    full, short = (results[k] for k in list(results)[1:3])
    if not _same_or_nan(full, short):
        raise Failed("interp_float2 read lens: short lens changed its result")

    cuda.reset_launches()
    res = p2.main(device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"probe launches: {launches}")
    missing = [k for k in ("interp_float", "interp_float2") if not launches[k]]
    if missing:
        raise Failed(f"the interleave probe never launched {missing}")

    w1, w2, imm, lens, vars_ = p2.reference_inputs(dev)
    args_b = p2.split_streams(w1, w2, imm, lens, vars_)
    nf, s0, T, L = p2.NF_REF, p2.S0_REF, w1.shape[0], w1.shape[1]
    run_a = lambda: interp_float(w1, w2, imm, lens, vars_, nf=nf,
                                 n_inputs=p2.V_REF, n_outputs=1, s0=s0)
    run_b = lambda: p2.interp_float2(*args_b, nf=nf, s0=s0)
    r_a = res["geometry_a"].r
    ms_a, ms_b = time_cuda(run_a, reps=20), time_cuda(run_b, reps=20)
    dev_a = device_ms(run_a, "interp_float_kernel")
    dev_b = device_ms(run_b, "interp_float2_kernel")
    by_lanes = {}
    for r in (4, 2, 1):
        run = lambda: p2.interp_float2(*args_b, nf=nf, s0=s0,
                                       lanes_per_thread=r)
        ms = time_cuda(run, reps=20)
        by_lanes[r] = {"ms": ms, "device_ms": device_ms(
            run, "interp_float2_kernel"), "ns_per_step": ms / (T * L) * 1e6}
    _, plain_ms = _time_plain(
        lambda *a: p2.interp_float2_plain(*a, nf=nf, s0=s0), args_b, {})
    lanes = s0 * 128
    ops = T * L * lanes  # one per lane, row and stream (B: T / 2 x 2 streams)
    nbytes = 12 * T * L + vars_[: T // 2].nbytes + T * lanes * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    bound_ms, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                         else "operations")
    slot_ms = _slot_bound_ms(ops)
    smem_ms = _smem_floor_ms(ops)
    steps = T * L
    log(f"interleave probe: A (K3, {T} instances, "
        f"{res['geometry_a'].r} lanes a thread) {ms_a:.4f} ms, device "
        f"{dev_a} ms, {ms_a / steps * 1e6:.4f} ns/step; B (P2, {T // 2} "
        f"instances of 2 streams, {res['geometry_b'].r} lanes a thread) "
        f"{ms_b:.4f} ms, device {dev_b} ms, {ms_b / steps * 1e6:.4f} "
        f"ns/step; B's speedup x{ms_a / ms_b:.3f} (events), "
        f"x{(dev_a or 0) / (dev_b or 1):.3f} (device); B at 4, 2, 1 "
        f"lanes a thread "
        + ", ".join(f"{v['ms']:.4f} ms (device {v['device_ms']})"
                    for v in by_lanes.values()) + "; "
        f"{ops} operations, "
        f"{nbytes} bytes: bound {bound_ms:.5f} ms ({by}), scheduler-slot "
        f"bound {slot_ms:.5f} ms, shared-memory floor {smem_ms:.5f} ms "
        f"({SMEM_ROW_BYTES} bytes a lane and row); plain {plain_ms:.1f} ms")
    src, replaces = KERNEL_INFO["interp_float2"]
    return {
        "name": "interp_float2", "route": "cuda", "source": src,
        "replaces": replaces, "launches": launches["interp_float2"],
        "max_abs_err": 0.0, "ms": ms_b, "device_ms": dev_b,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
        "slot_bound_ms": slot_ms, "smem_floor_ms": smem_ms,
        # no PyTorch call computes a tape interpreter
        "library_ms": None, "ns_per_step": ms_b / steps * 1e6,
        "lanes_per_thread": res["geometry_b"].r,
        "variant_a": {"ms": ms_a, "device_ms": dev_a,
                      "ns_per_step": ms_a / steps * 1e6,
                      "lanes_per_thread": r_a},
        "by_lanes": by_lanes,
        "probe": {k: res[k] for k in ("ms_a", "ms_b", "ns_a", "ns_b",
                                      "speedup")},
    }


def phase_grid_overhead(cuda, dev="cuda"):
    """13. The probe P3 (`fidget_tpu_torch.demos.exp_grid_overhead`): the
    grid-step kernel against its plain version bit for bit at every
    (T, G) of the probe; then the probe's `main()` with the launch counts
    set to 0 before and read after: ms per call and us per grid step of
    `many` (K = 64 calls) in one CUDA graph and eagerly, each mode's fit
    of ms per call against CTAs, and the graph's acc equal to the eager
    one; then the kernel alone at each (T, G) by CUDA events and the
    profiler's device time beside its bound (2 T 4 KiB over the memory
    rate), and the bound of one call of `many` with the glue's bytes
    (the scaling reads and writes x, the kernel reads and writes it, the
    sum reads two floats and writes one: 4 T 4 KiB + 12 bytes)."""
    from fidget_tpu_torch.demos import exp_grid_overhead as p3

    dev = torch.device(dev)
    xs = {}
    for T in p3.TS:
        xs[T] = torch.from_numpy((np.random.default_rng(T).normal(
            size=(T, 8, 128)) * 1000).astype(np.float32)).to(dev)
        for G in p3.GS:
            if not torch.equal(p3.grid_step(xs[T], G),
                               p3.grid_step_plain(xs[T], G)):
                raise Failed(f"grid_step at T={T}, G={G} differs from plain")
    log(f"grid_step bit-equal to plain at T in {p3.TS}, G in {p3.GS}")

    cuda.reset_launches()
    res = p3.main(device=dev)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    log(f"probe launches: {launches}")
    if not launches["grid_step"]:
        raise Failed("the grid-overhead probe never launched grid_step")
    for (T, G), (graph_acc, eager_acc) in res["acc"].items():
        if graph_acc != eager_acc:
            raise Failed(f"many at T={T}, G={G}: graph acc {graph_acc} "
                         f"differs from eager {eager_acc}")

    probe = {mode: {(r["T"], r["G"]): r for r in res[mode]}
             for mode in ("graph", "eager")}
    at = {}
    for T in p3.TS:
        nbytes = 2 * T * 8 * 128 * 4
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * p3.REPS * T * 8 * 128 / F32_OPS_PER_S * 1e3
        call_ms = (2 * nbytes + 12) / HBM_BYTES_PER_S * 1e3
        for G in p3.GS:
            run = lambda: p3.grid_step(xs[T], G)
            ms = time_cuda(run, reps=20)
            dms = device_ms(run, "grid_step_kernel")
            row = at[f"T={T},G={G}"] = {
                "ms": ms, "device_ms": dms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "call_bound_ms": call_ms,
            }
            for mode, by_size in probe.items():
                got = by_size.get((T, G), {})
                row[f"{mode}_ms_per_call"] = got.get("ms")
                row[f"{mode}_us_per_step"] = got.get("us_per_step")
            log(f"grid_step T={T} G={G} ({T // G} CTAs): kernel {ms:.4f} ms "
                f"(events), device {dms} ms, bound {max(t_bytes, t_ops):.5f} "
                f"ms ({nbytes} bytes); many per call: graph "
                f"{row['graph_ms_per_call']} ms, eager "
                f"{row['eager_ms_per_call']} ms, bound with the glue "
                f"{call_ms:.5f} ms")
    T, G = p3.TS[-1], p3.GS[0]
    _, plain_ms = _time_plain(p3.grid_step_plain, (xs[T], G), {})
    main_row = at[f"T={T},G={G}"]
    src, replaces = KERNEL_INFO["grid_step"]
    return {
        "name": "grid_step", "route": "cuda", "source": src,
        "replaces": replaces, "launches": launches["grid_step"],
        "max_abs_err": 0.0, "ms": main_row["ms"],
        "device_ms": main_row["device_ms"], "plain_ms": plain_ms,
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None, "shape": f"T={T},G={G}", "at": at,
        "fit": res["fit"],
    }


# ---------------------------------------------------------------------
# 14. the application layer: the CLI on the card

#: the volume edge of phase 14's render3d command
CLI_SIZE3 = 512


def cli_commands():
    """Phase 14's commands: (label, argv after the model path, model
    file, output suffix, the kernels its default --eval must launch)."""
    return [
        ("render2d", ["-s", str(SIZE), "--mode", "mono", "-N", "3"],
         "standin.vm", ".png", ("interp_interval", "liveness_codes",
                                "interp_float")),
        ("render3d", ["-s", str(CLI_SIZE3), "--mode", "shaded", "--ssao",
                      "-N", "3"],
         "gyroid.rhai", ".png", ("interp_interval", "liveness_codes",
                                 "interp_voxel_depth", "interp_grad")),
        ("mesh", ["--depth", str(MESH_DEPTH), "-N", "2"],
         "gyroid.rhai", ".stl", ("interp_interval", "interp_float",
                                 "interp_grad")),
    ]


#: CUDA-event repetitions of each effect in phase 14
EFFECT_REPS = 20
#: the effects' tolerances against the CPU (tests/test_torch_effects.py)
EFFECT_ATOL = 1e-6
SSAO_EQUAL_SHARE = 0.999
SHADE_WITHIN_ONE_SHARE = 0.99
SHADE_MAX_LEVELS = 4


def start_tape_compiler_build(port):
    """The g++ build of the native `.vm` tape compiler (phase 14 loads
    the stand-in through it), started in a thread of its own at the start
    of the run. Returns a future of the build seconds."""
    from fidget_tpu_torch import native

    def build():
        t0 = time.perf_counter()
        native.available()
        return time.perf_counter() - t0

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(build)
    pool.shutdown(wait=False)
    return future


def _stl_triangles(path) -> np.ndarray:
    import struct

    data = path.read_bytes()
    (n,) = struct.unpack("<I", data[80:84])
    rec = np.frombuffer(data[84:], dtype=[("d", "<f4", 12), ("attr", "<u2")])
    if len(rec) != n:
        raise Failed(f"STL holds {len(rec)} records, its header says {n}")
    return rec["d"][:, 3:].reshape(n, 3, 3)


@contextlib.contextmanager
def _recording(owner, name, store):
    """Appends every result of `owner.name` to `store` while the
    context lasts (the call itself runs unchanged)."""
    real = getattr(owner, name)

    def rec(*args, **kwargs):
        out = real(*args, **kwargs)
        store.append(out)
        return out

    setattr(owner, name, rec)
    try:
        yield
    finally:
        setattr(owner, name, real)


def _run_cli(cuda, argv, kernels):
    """One command through `cli.main` with the launch counts set to 0
    just before and read just after; its standard output is logged.
    Returns (the command's wall seconds, the best ms it reported)."""
    import io

    from fidget_tpu_torch import cli

    out = io.StringIO()
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    for line in out.getvalue().splitlines():
        log(f"  | {line}")
    if rc != 0:
        raise Failed(f"`{' '.join(argv[:1])}` exited {rc}")
    missing = [k for k in kernels if not launches.get(k)]
    log(f"  launches: {launches}")
    if missing:
        raise Failed(f"`{argv[0]}` never launched {missing}")
    best = [float(w[:-2]) for w in out.getvalue().split() if w.endswith("ms")]
    return wall, best[-1]


def _effects_against_cpu(fx, depth, normal, vdepth, png):
    """The effects of the card on the CLI's depth and normals, held to
    the same functions on the CPU at the CPU tests' tolerances, and the
    CLI's written image to the card's shading of them."""
    dn = fx.denoise_normals(depth, normal)
    s_raw = fx.compute_ssao(depth, dn, vdepth=vdepth)
    s_blur = fx.blur_ssao(s_raw)
    shaded = fx.apply_shading(depth, dn, vdepth=vdepth, ssao=True)
    if not np.array_equal(torch.flip(shaded, dims=[0]).cpu().numpy(), png):
        raise Failed("the CLI's image is not the card's shading of its frame")
    d_c, n_c = depth.cpu(), normal.cpu()
    dn_c = fx.denoise_normals(d_c, n_c)
    err_dn = float((dn.cpu() - dn_c).abs().max())
    if err_dn > EFFECT_ATOL:
        raise Failed(f"denoise_normals: card and CPU differ by {err_dn}")
    s_c = fx.compute_ssao(d_c, dn_c, vdepth=vdepth)
    filled = d_c > 0
    if not torch.equal(torch.isnan(s_raw.cpu()), ~filled):
        raise Failed("compute_ssao: NaN where the pixel is not empty")
    diff = (s_raw.cpu() - s_c)[filled].abs()
    equal = float((diff == 0).double().mean())
    if equal < SSAO_EQUAL_SHARE or not torch.all(
            (diff == 0) | (diff == 1.0 / 64)):
        raise Failed(f"compute_ssao: {equal:.5f} of filled pixels equal "
                     f"the CPU's, largest difference {float(diff.max())}")
    err_blur = float(np.nanmax(np.abs(
        fx.blur_ssao(s_raw.cpu()).numpy() - s_blur.cpu().numpy())))
    if err_blur > EFFECT_ATOL:
        raise Failed(f"blur_ssao: card and CPU differ by {err_blur}")
    lv = np.abs(shaded.cpu().numpy().astype(int) - fx.apply_shading(
        d_c, dn_c, vdepth=vdepth, ssao=True).numpy().astype(int))
    within = float((lv <= 1).mean())
    if within < SHADE_WITHIN_ONE_SHARE or lv.max() > SHADE_MAX_LEVELS:
        raise Failed(f"apply_shading: {within:.4f} of pixels within a "
                     f"level of the CPU's, largest {lv.max()}")
    log(f"  effects on the card vs the CPU on the CLI's frame: denoise max "
        f"err {err_dn:.3g}, SSAO equal at {equal:.6f} of "
        f"{int(filled.sum())} filled pixels ({int((diff > 0).sum())} differ "
        f"by 1/64), blur max err {err_blur:.3g}, shading within 1 level at "
        f"{within:.5f} of pixels, largest {lv.max()}")
    return dn


def _time_effects(fx, depth, normal, dn, vdepth):
    """CUDA-event ms of each effect at the frame's size, and the device
    ops and busy share of one profiled shading with SSAO."""
    s = fx.compute_ssao(depth, dn, vdepth=vdepth)
    sb = fx.blur_ssao(s)
    ms = {
        "denoise": time_cuda(lambda: fx.denoise_normals(depth, normal),
                             EFFECT_REPS),
        "ssao": time_cuda(lambda: fx.compute_ssao(depth, dn, vdepth=vdepth),
                          EFFECT_REPS),
        "blur": time_cuda(lambda: fx.blur_ssao(s), EFFECT_REPS),
        "shade": time_cuda(lambda: fx._shade(depth, dn, sb, vdepth=vdepth),
                           EFFECT_REPS),
    }

    def all_effects():
        d = fx.denoise_normals(depth, normal)
        return fx.apply_shading(depth, d, vdepth=vdepth, ssao=True)

    total = time_cuda(all_effects, EFFECT_REPS)
    H, W = depth.shape
    log(f"  effects at {W}x{H} (CUDA events, {EFFECT_REPS} calls): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ms.items())
        + f"; denoise + shading with SSAO {total:.3f} ms")
    wall_ms, _ = _median_ms(all_effects, 5)
    busy = _device_busy(all_effects, 1)
    _log_busy("denoise + shading with SSAO", busy, wall_ms)
    return ms, total, busy


def phase_cli(port, cuda, brute2d, tape_build):
    """14. The port's application layer through its command line on the
    card (`fidget_tpu_torch.cli.main`, the function behind `python -m
    fidget_tpu_torch`): the 7,203-op stand-in written as `.vm` by
    `Context.export` and loaded through the native tape compiler (its g++
    build started with the run), the gyroid sphere written as a `.rhai`
    script; `render2d` at 1024^2 (mono), `render3d` at 512^3 (shaded with
    SSAO) and `mesh` at depth 8, each on its default `--eval`, launch
    counts set to 0 before and read after. The 2D PNG equals the mono
    image of a direct `PixelRenderer.render` of the same loaded tape, and
    its occupancy `render_brute`'s (phase 4's, of the same view and
    shape); the 3D frame's depth (recorded from the command's
    `VoxelRenderer.render`) equals a direct render's, its written image
    the card's effects of that frame, and the effects on the card the
    same functions on the CPU; the STL's triangle count equals a direct
    `build_mesh`'s, and the command's mesh is held by `check_mesh`. Logs
    each command's wall time and best repeat, and the effects' CUDA-event
    times, device ops and busy share."""
    import tempfile

    from fidget_tpu_torch import cli, mesh as mesh_mod
    from fidget_tpu_torch.gui import View2, View3
    from fidget_tpu_torch.io.image import png_pixels
    from fidget_tpu_torch.mesh import collapse
    from fidget_tpu_torch.native import compile_vm
    from fidget_tpu_torch.render import effects as fx, render3d
    from fidget_tpu_torch.scenes import GYROID_SPHERE_RHAI, standin_shape

    t_phase = time.perf_counter()
    log(f"tape compiler: g++ build {tape_build.result():.1f} s (in a thread "
        f"from the start of the run)")
    dev = torch.device("cuda")
    times = {}
    with tempfile.TemporaryDirectory(prefix="fidget_cli_") as tmp:
        tmp = pathlib.Path(tmp)
        ctx = port.Context()
        (tmp / "standin.vm").write_text(ctx.export(standin_shape(ctx)))
        (tmp / "gyroid.rhai").write_text(GYROID_SPHERE_RHAI)
        frames, meshes, boxes = [], [], []
        outs = {}
        for label, argv, model, suffix, kernels in cli_commands():
            out = tmp / f"{label}{suffix}"
            outs[label] = out
            log(f"cli: {label} {model} {' '.join(argv)}")
            with contextlib.ExitStack() as stack:
                if label == "render3d":
                    stack.enter_context(_recording(
                        render3d.VoxelRenderer, "render", frames))
                if label == "mesh":
                    stack.enter_context(_recording(mesh_mod, "build_mesh",
                                                   meshes))
                    stack.enter_context(_cell_boxes(collapse, boxes))
                wall, best = _run_cli(
                    cuda, [label, str(tmp / model), *argv, "-o", str(out)],
                    kernels)
            times[label] = (wall, best)
            log(f"  {label}: command {wall:.2f} s wall (load, build, "
                f"repeats, output); best repeat {best:.2f} ms")

        # 2D: the PNG against a direct render of the same loaded tape
        tape2d = compile_vm((tmp / "standin.vm").read_text())
        r = port.PixelRenderer(tape2d, port.ImageSize(SIZE, SIZE))
        inside = r.render(View2().world_to_model()).inside()
        inside = inside.cpu().numpy()
        png = png_pixels(outs["render2d"].read_bytes())
        mono = np.where(inside[..., None], 255, 0).astype(np.uint8)
        if not np.array_equal(png, np.broadcast_to(mono, png.shape)):
            raise Failed("render2d's PNG differs from a direct render")
        if not np.array_equal(inside, brute2d < 0):
            raise Failed(f"render2d's occupancy differs from render_brute at "
                         f"{int((inside != (brute2d < 0)).sum())} px")
        log(f"  render2d: PNG equals a direct PixelRenderer.render bit for "
            f"bit, occupancy equals render_brute ({inside.mean():.4f} inside)")

        # 3D: depth against a direct render; effects against the CPU
        img = frames[-1]
        tape3d = cli._tape(cli._load(str(tmp / "gyroid.rhai")))
        n3 = CLI_SIZE3
        direct = port.VoxelRenderer(tape3d, port.VoxelSize(n3, n3, n3))
        want = direct.render(View3().world_to_model()).depth
        if not torch.equal(img.depth, want):
            raise Failed(f"render3d's depth differs from a direct render at "
                         f"{int((img.depth != want).sum())} px")
        log(f"  render3d: depth equals a direct VoxelRenderer.render "
            f"({float((img.depth > 0).float().mean()):.4f} filled)")
        png3 = png_pixels(outs["render3d"].read_bytes())
        dn = _effects_against_cpu(fx, img.depth, img.normal, n3, png3)
        effect_ms, effects_total, busy = _time_effects(
            fx, img.depth, img.normal, dn, n3)

        # mesh: the STL against a direct build, the command's mesh checked
        tris = _stl_triangles(outs["mesh"])
        want_mesh = port.build_mesh(tape3d, port.MeshSettings(
            depth=MESH_DEPTH, device=dev))
        if not (len(tris) == len(meshes[-1].triangles)
                == len(want_mesh.triangles)):
            raise Failed(f"mesh: STL {len(tris)} triangles, the command's "
                         f"mesh {len(meshes[-1].triangles)}, a direct build "
                         f"{len(want_mesh.triangles)}")
        ev = mesh_mod._get_evaluator(tape3d, dev)
        check_mesh("cli mesh", meshes[-1], ev, boxes[-1], np.eye(4))
        log(f"  mesh: STL holds the {len(tris)} triangles of a direct "
            f"build_mesh")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s; command walls "
        + ", ".join(f"{k} {w:.2f} s (best {b:.2f} ms)"
                    for k, (w, b) in times.items()))
    return times, effect_ms, effects_total, busy



# ======================================================================
# phase 15: the solver and the sharded entry points

#: ranks of the multi-rank world on the one card: gloo ranks that share
#: cuda:0 (NCCL refuses two ranks on one GPU)
SHARD_WORLD = 2
#: seconds that world may take, its ranks' start-up included, before
#: they are killed and the phase fails
SHARD_TIMEOUT = 420
#: points of the solver's chain: 2 (n - 1) equations over as many free
#: variables
CHAIN_POINTS = 128
#: the view of the sharded 3D frames (`VIEWS3`)
SHARD_VIEW3 = VIEWS3[1]
#: the kernels each path of phase 15 must launch
SHARD_PATHS = {
    "solve": ("interp_float", "interp_grad"),
    "render_tiles_sharded": ("interp_interval", "liveness_codes",
                             "interp_float"),
    "render_unrolled_sharded": ("unrolled_interval", "unrolled_float"),
    "render_voxels_sharded interp": ("interp_interval", "liveness_codes",
                                     "interp_voxel_depth", "interp_grad"),
    "render_voxels_sharded unrolled": ("unrolled_proofs3",
                                       "unrolled_voxel_fold", "interp_grad"),
    "render_sharded": ("unrolled_float",),
    "fit_step unrolled": ("unrolled_float", "interp_grad"),
    "fit_step interp": ("interp_float", "interp_grad"),
}
#: fit_step's learning rate; it starts from (shift, grow) = 0 toward a
#: target rendered at GRAD_PARAMS
SHARD_LR = 0.5


def _residual_bound(x):
    """The solver's residual bound at a solution `x`: 1e-5, widened by
    two f32 spacings of its largest coordinate. A residual such as
    |p_{k+1} - p_k|^2 - 1 cannot fall below the rounding of coordinates
    that large: on the CPU both packages end the 128-point chain at
    1.32e-5 (x up to 120, spacing 7.6e-6)."""
    return 1e-5 + 2 * float(np.spacing(np.float32(np.abs(x).max())))


def _check_launches(label, launches):
    """Every path launched its kernels; a fit step's Jacobian in the
    stand-in's four inputs launched K4 once (unrolled: the two shape
    parameters, 3 planes) or twice (interp: every input, 4 planes and
    2)."""
    for path, want in SHARD_PATHS.items():
        if path not in launches:
            continue
        missing = [k for k in want if not launches[path].get(k)]
        if missing:
            raise Failed(f"{label}: {path} never launched {missing}")
    for path, want in (("fit_step unrolled", 1), ("fit_step interp", 2)):
        k4 = launches.get(path, {}).get("interp_grad", want)
        if k4 != want:
            raise Failed(f"{label}: {path} launched K4 {k4} times, not "
                         f"{want}")


def phase_solve(port, cuda):
    """15a. `solve` on the card: the constraint demo's linkage and a
    chain of CHAIN_POINTS points (`scenes.linkage_system`,
    `chain_system`), each through a `Solver` on the card and on the CPU
    (the plain versions): solutions equal within 1e-4, the card's
    residuals within `_residual_bound`; K3 and K4 launches an LM
    iteration and ms a solve (host clock, each solve from the start);
    `fidget_tpu_torch.solve` (the card by default) equal to the
    Solver."""
    from fidget_tpu_torch import solver as S
    from fidget_tpu_torch.scenes import chain_system, linkage_system

    for label, (eqs, start) in (
        ("linkage", linkage_system(port)),
        (f"chain of {CHAIN_POINTS}", chain_system(port, CHAIN_POINTS)),
    ):
        free = [v for v, (_, f) in start.items() if f]
        fixed = [v for v, (_, f) in start.items() if not f]
        params = {v: S.Parameter.Free(x) if f else S.Parameter.Fixed(x)
                  for v, (x, f) in start.items()}
        s = S.Solver(eqs, free, fixed)
        cuda.reset_launches()
        sol = s.solve(params)
        torch.cuda.synchronize()
        counts = {k: n for k, n in cuda.LAUNCHES.items() if n}
        _check_launches(f"solve {label}", {"solve": counts})
        iters = counts.get("interp_grad", 0) // -(-s.V // 3)
        x = np.array([sol[v] for v in free], np.float32)
        t0 = time.perf_counter()
        cpu = S.Solver(eqs, free, fixed, device="cpu").solve(params)
        cpu_s = time.perf_counter() - t0
        x_cpu = np.array([cpu[v] for v in free], np.float32)
        err = float(np.abs(x - x_cpu).max())
        if err > 1e-4:
            raise Failed(f"solve {label}: card and CPU solutions differ by "
                         f"{err}")
        res = float(np.abs(s.residuals(x)).max())
        bound = _residual_bound(x)
        if res > bound:
            raise Failed(f"solve {label}: residual {res} past {bound}")
        public = port.solve(eqs, params)
        if any(public[v] != sol[v] for v in free):
            raise Failed(f"solve {label}: fidget_tpu_torch.solve differs "
                         f"from the Solver")
        passes = [0.0]

        def timed(fn):
            def run(cur):
                t0 = time.perf_counter()
                out = fn(cur)
                passes[0] += time.perf_counter() - t0
                return out
            return run

        s.residuals, s.jacobian = timed(s.residuals), timed(s.jacobian)
        med, mn = _median_ms(lambda: s.solve(params), 5)
        passes_ms = passes[0] * 1e3 / 5
        log(f"solve {label}: {len(eqs)} equations over {len(free)} free "
            f"variables; {iters} LM iterations, K3 {counts.get('interp_float', 0)}"
            f" launches ({counts.get('interp_float', 0) / max(iters, 1):.1f} an"
            f" iteration), K4 {counts.get('interp_grad', 0)} ({-(-s.V // 3)} a "
            f"Jacobian); max residual {res:.3g} (bound {bound:.3g}); equal to "
            f"the CPU solve within {err:.3g} ({cpu_s:.1f} s there); "
            f"{med:.3f} ms a solve median, {mn:.3f} min (host clock, 5 solves),"
            f" {passes_ms:.3f} ms of it in the K3 / K4 passes (launch, kernel, "
            f"read back), the rest the host's float64 LM loop")


def _shard_scenes(port):
    """Phase 15's scenes: the 2D stand-in, the parametrized stand-in with
    its two Vars, the gyroid sphere."""
    from fidget_tpu_torch.scenes import gyroid_sphere, standin_shape

    ctx = port.Context()
    return (port.lower(ctx, [standin_shape(ctx)]), _param_standin(port),
            gyroid_sphere(port))


def _sharded_calls(port, cuda, mesh, scenes, label=None):
    """Every sharded entry point on `mesh` at full width: the stand-in at
    SIZE^2 through `render_tiles_sharded` and `render_unrolled_sharded`
    over FRAMES, the gyroid sphere at SIZE3^3 through
    `render_voxels_sharded` at SHARD_VIEW3 (interpreter leaf; leaf and
    proofs unrolled), the parametrized stand-in through `render_sharded`
    at GRAD_PARAMS and `fit_step` from 0 toward that image with both
    pipelines. Each call runs four times: the first gives its result and
    launches (counted from 0), then three more are timed (median, host
    clock, synchronized); with a `label`, each call's ms is logged as it ends.
    Returns (results on the host, launches by path, ms by call)."""
    from fidget_tpu_torch.parallel import sharding as sh

    tape, (ptape, shift, grow), gyroid = scenes
    size = port.ImageSize(SIZE, SIZE)
    size3 = port.VoxelSize(SIZE3, SIZE3, SIZE3)
    out, launches, ms = {}, {}, {}

    def run(path, key, fn):
        cuda.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        counts = launches.setdefault(path, {})
        for k, n in cuda.LAUNCHES.items():
            if n:
                counts[k] = counts.get(k, 0) + n
        ms[key] = _median_ms(fn, 3)[0]
        if label:
            log(f"  {label}: {key} {ms[key]:.1f} ms")
        return res

    for k, view in enumerate(FRAMES):
        img = run("render_tiles_sharded", f"tiles {k}",
                  lambda v=view: sh.render_tiles_sharded(
                      tape, size, mesh, world_to_model=v))
        out[f"tiles{k}_distance"] = img.distance.cpu()
        out[f"tiles{k}_fill"] = img.fill.cpu()
        img, counts = run("render_unrolled_sharded", f"unrolled {k}",
                          lambda v=view: sh.render_unrolled_sharded(
                              tape, size, mesh, world_to_model=v,
                              _debug_counts=True))
        out[f"unrolled{k}_distance"] = img.distance.cpu()
        out[f"unrolled{k}_fill"] = img.fill.cpu()
        out[f"unrolled{k}_counts"] = counts.cpu()
    for mode, kw in (("interp", {}),
                     ("unrolled", dict(leaf="unrolled", proofs="unrolled"))):
        img = run(f"render_voxels_sharded {mode}", f"voxels {mode}",
                  lambda kw=kw: sh.render_voxels_sharded(
                      gyroid, size3, mesh, world_to_model=SHARD_VIEW3[1],
                      **kw))
        out[f"voxels_{mode}_depth"] = img.depth.cpu()
        out[f"voxels_{mode}_normal"] = img.normal.cpu()
    target = run("render_sharded", "render_sharded",
                 lambda: sh.render_sharded(
                     ptape, size, mesh,
                     params={shift: GRAD_PARAMS[0], grow: GRAD_PARAMS[1]}))
    out["dense"] = target.cpu()
    for pipeline in ("unrolled", "interp"):
        new, loss = run(f"fit_step {pipeline}", f"fit_step {pipeline}",
                        lambda p=pipeline: sh.fit_step(
                            ptape, size, mesh, {shift: 0.0, grow: 0.0},
                            target, lr=SHARD_LR, pipeline=p))
        out[f"fit_{pipeline}"] = torch.tensor([new[shift], new[grow], loss],
                                              dtype=torch.float64)
    return out, launches, ms


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _shard_rank(rank, world, port_no, path, start):
    """One rank of the gloo world on cuda:0 (run in a spawned process):
    every sharded call of `_sharded_calls`, saved to `path`."""
    global START
    START = start
    sys.path.insert(0, str(ROOT))
    import torch.distributed as dist

    import fidget_tpu_torch as port
    from fidget_tpu_torch.eval import cuda
    from fidget_tpu_torch.parallel import sharding as sh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port_no}",
                            rank=rank, world_size=world)
    mesh = sh.make_mesh(device="cuda:0")
    if (mesh.rank, mesh.size, mesh.backend) != (rank, world, "gloo"):
        raise Failed(f"rank {rank}: mesh {mesh}")
    out, launches, ms = _sharded_calls(port, cuda, mesh, _shard_scenes(port),
                                       f"gloo rank {rank}")
    torch.save({"out": out, "launches": launches, "ms": ms}, path)
    dist.destroy_process_group()
    log(f"  gloo rank {rank} of {world}: done")


def _run_world(world):
    """Spawns `world` gloo ranks on the card (`_shard_rank`, a free local
    port for the rendezvous) and returns what each saved; fails, killing
    every rank, when one fails or SHARD_TIMEOUT runs out."""
    import multiprocessing
    import multiprocessing.connection
    import tempfile

    mpc = multiprocessing.get_context("spawn")
    port_no = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        procs = [mpc.Process(target=_shard_rank,
                             args=(k, world, port_no, str(tmp / f"rank{k}.pt"),
                                   START))
                 for k in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + SHARD_TIMEOUT
        try:
            while any(p.is_alive() for p in procs):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise Failed(f"the world of {world} ranks did not end "
                                 f"within {SHARD_TIMEOUT} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.is_alive()], left)
                bad = [k for k, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    raise Failed(f"rank(s) {bad} of {world} failed "
                                 f"(exit codes "
                                 f"{[procs[k].exitcode for k in bad]})")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(tmp / f"rank{k}.pt") for k in range(world)]


def _same_results(label, got, want):
    """Bit-equal results, normals within 1e-4 and the fit within rtol
    1e-5 (loss) / 1e-4 (parameters); the deal's counts are checked by
    the caller."""
    for key, w in want.items():
        g = got[key]
        if key.endswith("_counts"):
            continue
        if key.endswith("_normal"):
            check(f"{label} {key}", g, w, 1e-4, 1e-4)
        elif key.startswith("fit_"):
            check(f"{label} {key} loss", g[2:], w[2:], 1e-5, 0.0)
            check(f"{label} {key} parameters", g[:2], w[:2], 1e-4, 1e-7)
        elif not torch.equal(g, w):
            raise Failed(f"{label}: {key} differs at "
                         f"{int((g != w).sum())} elements")


def _check_deal(label, counts, total, world):
    if int(counts.sum()) != total or int(counts.max()) > -(-total // world):
        raise Failed(f"{label}: the deal {counts.tolist()} of {total} "
                     f"active tiles is not even over {world} ranks")


def phase_sharded(port, cuda, brutes):
    """15. The solver (15a), then every sharded entry point of
    `fidget_tpu_torch.parallel.sharding` at full width in a world of 1
    under NCCL (15b) and in a world of SHARD_WORLD gloo ranks sharing
    the card (15c, spawned processes with a timeout and a kill), the only
    place where the card runs the cross-rank code (the deal, the gathers,
    the gradient sum). World 1: each 2D frame's occupancy equal to phase
    4's `render_brute` (`brutes`), and every result equal bit for bit to
    the single-device frame of its binding (`PixelRenderer(specialize=
    True)`, `render_unrolled`, `render_dense`, the per-shape and the
    compiled `VoxelRenderer`; normals within 1e-4), the deal's counts
    even, fit_step's two pipelines agreeing (rtol 1e-5 loss, 1e-4
    parameters); each call's ms beside the single-device frame's. World
    SHARD_WORLD: every rank's results equal to world 1's (normals within
    1e-4, the fit within rtol 1e-5 / 1e-4), its deals even. Every path
    launches its kernels (SHARD_PATHS) in each world."""
    import torch.distributed as dist

    from fidget_tpu_torch.parallel import sharding as sh

    t_phase = time.perf_counter()
    phase_solve(port, cuda)

    # ---- 15b: a world of 1 under NCCL ------------------------------
    scenes = _shard_scenes(port)
    tape, (ptape, shift, grow), gyroid = scenes
    torch.cuda.set_device(0)
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = sh.make_mesh()
        if (mesh.size, mesh.backend) != (1, "nccl"):
            raise Failed(f"world of 1: mesh {mesh}")
        out1, launches1, ms1 = _sharded_calls(port, cuda, mesh, scenes)
    finally:
        dist.destroy_process_group()
    _check_launches("world of 1 (NCCL)", launches1)
    log(f"sharded, world of 1 (NCCL): launches by path {launches1}")

    # the single-device frames of the same bindings
    size = port.ImageSize(SIZE, SIZE)
    size3 = port.VoxelSize(SIZE3, SIZE3, SIZE3)
    per_shape = port.PixelRenderer(tape, size, specialize=True)
    unrolled = port.PixelRenderer(tape, size)
    dense = port.PixelRenderer(ptape, size)
    voxels = {
        "interp": port.VoxelRenderer(gyroid, size3, tile_size=64,
                                     sub_size=16),
        "unrolled": port.VoxelRenderer(gyroid, size3, tile_size=64,
                                       sub_size=16, leaf="unrolled",
                                       proofs="unrolled"),
    }
    want, single_ms = {}, {}

    def single_frame(key, fn):
        res = fn()  # the first frame settles capacities
        res = fn()
        single_ms[key] = _median_ms(fn, 3)[0]
        return res

    for k, view in enumerate(FRAMES):
        for key, fn in (("tiles", per_shape.render),
                        ("unrolled", unrolled.render_unrolled)):
            img = single_frame(f"{key} {k}", lambda fn=fn, v=view: fn(v))
            want[f"{key}{k}_distance"] = img.distance.cpu()
            want[f"{key}{k}_fill"] = img.fill.cpu()
            check_frame(per_shape, port.Image2D(out1[f"{key}{k}_distance"],
                                                out1[f"{key}{k}_fill"]),
                        view, brutes[k])
        # the active tiles: those of the default 8-px tiles left unfilled
        fill = want[f"unrolled{k}_fill"][::8, ::8]
        total = int((fill == 0).sum())
        _check_deal(f"world of 1, view {k}", out1[f"unrolled{k}_counts"],
                    total, 1)
    for mode, r3 in voxels.items():
        img = single_frame(f"voxels {mode}",
                           lambda r3=r3: r3.render(SHARD_VIEW3[1]))
        want[f"voxels_{mode}_depth"] = img.depth.cpu()
        want[f"voxels_{mode}_normal"] = img.normal.cpu()
    vars_ = {shift: GRAD_PARAMS[0], grow: GRAD_PARAMS[1]}
    want["dense"] = single_frame(
        "render_sharded", lambda: dense.render_dense(vars=vars_)
    ).distance.cpu()
    _same_results("world of 1 against the single-device frames", out1,
                  want)
    check("fit_step interp against unrolled, loss", out1["fit_interp"][2:],
          out1["fit_unrolled"][2:], 1e-5, 0.0)
    check("fit_step interp against unrolled, parameters",
          out1["fit_interp"][:2], out1["fit_unrolled"][:2], 1e-4, 1e-7)
    log(f"  fit_step from (0, 0) toward {GRAD_PARAMS}: unrolled "
        f"{out1['fit_unrolled'].tolist()}, interp "
        f"{out1['fit_interp'].tolist()} (shift, grow, loss)")
    for key, t in ms1.items():
        log(f"  {key}: sharded {t:.3f} ms, single-device "
            f"{single_ms.get(key, float('nan')):.3f} ms (host clock, "
            f"synchronized; one card cannot show a gain from sharding)")
    log("  world of 1: every result equals the single-device frame "
        "(normals within 1e-4), occupancy equals render_brute")

    # ---- 15c: a world of SHARD_WORLD gloo ranks on the card ---------
    t0 = time.perf_counter()
    ranks = _run_world(SHARD_WORLD)
    log(f"sharded, world of {SHARD_WORLD} (gloo, all on cuda:0): "
        f"{time.perf_counter() - t0:.1f} s, start-up included")
    for k, got in enumerate(ranks):
        label = f"gloo rank {k} of {SHARD_WORLD}"
        _check_launches(label, got["launches"])
        _same_results(f"{label} against the world of 1", got["out"], out1)
        for v in range(len(FRAMES)):
            total = int(out1[f"unrolled{v}_counts"].sum())
            _check_deal(f"{label}, view {v}",
                        got["out"][f"unrolled{v}_counts"], total,
                        SHARD_WORLD)
        log(f"  {label}: launches by path {got['launches']}")
        counts = {f"view {v}": got["out"][f"unrolled{v}_counts"].tolist()
                  for v in range(len(FRAMES))}
        if k == 0:
            log(f"  the deal's active tiles a rank: {counts}")
    log(f"  world of {SHARD_WORLD}: every rank's results equal the world of"
        f" 1 (normals within 1e-4, fit within rtol 1e-5 / 1e-4)")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    global START
    START = t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT))
    import fidget_tpu_torch as port
    from fidget_tpu_torch.eval import cuda, simplify_device
    from fidget_tpu_torch.render import render2d, render3d
    from fidget_tpu_torch.scenes import standin_shape

    dev = torch.device("cuda")
    smi = phase_device()
    phase_build(cuda)
    tape_build = start_tape_compiler_build(port)
    guard_build = start_guard_build(port)
    from fidget_tpu_torch.scenes import sphere_union_shape

    ctx3 = port.Context()
    compiled3 = start_compiled3d_build(
        port, port.lower(ctx3, [sphere_union_shape(ctx3)]))
    mesh_built = start_mesh_unrolled_build(port, compiled3[1])
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
    t0 = time.time()
    brutes = concurrently([lambda v=view: r.render_brute(v)
                           for view in FRAMES])
    log(f"render_brute of {len(FRAMES)} views in {time.time() - t0:.1f} s")
    for k, (img, view) in enumerate(zip(images, FRAMES)):
        ink, evaluated = check_frame(r, img, view, brutes[k])
        log(f"frame {k}: occupancy equals render_brute ({ink:.4f} inside, "
            f"{evaluated:.3f} of pixels evaluated)")

    rows = phase_kernels(captured, launches, len(FRAMES), r.n0)
    log("standard frame stages:")
    phase_stages(r, FRAMES[1])
    rows["interp_float_coded"] = phase_coded(r, images, brutes, cuda, render2d)
    per_shape = phase_per_shape(port, tape, images, brutes, cuda, render2d,
                                simplify_device, rows)
    phase_compare_frames(r, per_shape, FRAMES[1])

    param_tape, shift, grow = _param_standin(port)
    ru, rp, build = phase_unrolled_build(port, tape, param_tape)
    phase_unrolled(ru, cuda, images, brutes, build, rows)
    phase_unrolled_guard(port, built=guard_build)

    r3, captured3, launches3, n3, brutes3 = phase_main3d(
        port, cuda, render3d, render2d, simplify_device
    )
    ru3, union_brute = phase_union3d(port, cuda)
    phase_kernels3d(r3, captured3, launches3, n3, rows)
    phase_stages3d(r3, VIEWS3[1][1])
    rps3, _ = phase_per_shape3d(port, cuda, render3d, simplify_device,
                                brutes3, rows)
    phase_compiled3d(port, cuda, render3d, r3, rps3, brutes3, ru3,
                     union_brute, compiled3, rows)

    phase_grad(port, cuda, rows)
    phase_grad_unrolled(rp, {shift: GRAD_PARAMS[0], grow: GRAD_PARAMS[1]},
                        rows)
    phase_mesh(port, cuda, rows)
    phase_mesh_unrolled(port, cuda, rows, mesh_built)

    rows["interp_float2"] = phase_interleave(cuda)
    rows["grid_step"] = phase_grid_overhead(cuda)
    phase_cli(port, cuda, brutes[0], tape_build)
    phase_sharded(port, cuda, brutes)

    log(f"chip_smoke wall time: {time.perf_counter() - t_start:.1f} s, "
        f"builds included")
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
