"""Kernels generated per tape: emitting, building and launching them.

The per-shape compiled path (`PixelRenderer.render_unrolled`,
`render_dense`) runs each tape as straight-line code, the counterpart of
the straight-line XLA that `fidget_tpu.eval.unrolled_fast` traces and
of the Pallas probe `demos/exp_unrolled_kernel.py` (`build_unrolled_
kernel`). Two kernels, both written for Hopper in CUDA C++
(csrc/unrolled.cuh holds their fixed parts):

- U1 `unrolled_float`: the float program of one or more tapes over a
  compacted worklist of tiles (pixels of each slot's tile), one
  program per segment of slots, the union frame's programs and the
  full-tape fallback in one launch;
- U2 `unrolled_interval`: the interval program of one tape over cull
  tiles, with the proofs and one epilogue fixed when the code is
  generated: "proofs", "capture" (packed choice words) or "violation"
  (the fused subset test against a plan's union words).

The 3D renderer's compiled frames (`VoxelRenderer(leaf="unrolled",
proofs="unrolled")`) run two 3D variants of them, the counterparts of
the unrolled `stratum_leaf` and of `_unrolled_interval3` in
`fidget_tpu.render.render3d`:

- U1-3D (`VoxelKernel`): U1's program of the whole tape behind a kernel
  unit of its own, over the voxels of a worklist of subtiles, with a
  depth epilogue: a group of `voxel_group` lanes walks one column from
  the top, a chunk of voxels at a time, and stops at the first chunk
  with a voxel inside. Its frame entry `unrolled_voxel_fold` reads a
  stratum's compacted worklist and count on the device and folds the
  depths into the floor; `unrolled_voxel_depth` takes explicit corners
  and returns the candidates;
- U2-3D (`Interval3Kernel`): U2 over 3D boxes (a z interval per tile
  instead of the 2D plane's fixed z), proofs only, at `proofs3_warps`
  warps a group. Its frame entry `unrolled_proofs3` proves a frame's
  root tiles and all their subtiles in one launch, forming the
  subtiles' corners itself; `unrolled_interval3` takes explicit boxes.

The mesher's compiled path (`build_mesh(Settings(eval="unrolled"))`,
mesh/fused.py) runs two more, the counterparts of `eval_tape_float_fast`
and `eval_tape_interval_fast` in `fidget_tpu.mesh.fused`'s cores:

- U1-P `unrolled_points` (`PointsKernel`): U1's program of the whole
  tape behind a kernel unit over a flat list of model-space points,
  with the distance or the sign `d < 0` as its epilogue; its sign table
  (`TableKernel`, `SignTable`): the leaf core's `leaf_masks` and the
  collapse rounds' `merge_topo` form their points from keys on the
  card, evaluate each distinct lattice point of a build once and form
  the corner masks / the topology test there; and its edge
  search `unrolled_edges` (`EdgesKernel`): the same program behind a
  kernel unit in which a group of lanes walks every round of the N-ary
  search of one crossing (cell, edge) slot with its brackets in
  registers;
- U2-B `level_active` (the level core: a thread decodes a parent's key
  and forms one child's box) and `unrolled_interval_boxes` (explicit
  model-space boxes), both `BoxesKernel`: the tape's interval rows as
  one stream, one thread a box, proofs only.

All take a live count from device memory (lane g of a [rows, cols]
list is live when g % cols < count), so that a chain of octree levels
never waits on the host; a dead lane does no work and gets 0 or no
proof, as the plain versions mask it.

The emitter writes one statement per tape row. U1's thread evaluates
one pixel; every program, a launch of one program included, is a device
function of its own translation unit (programs of a few rows share
one), linked into its kernel with -rdc. U2 renames the tape into values
(`IntervalSchedule`) and spreads its rows over the INTERVAL_WARPS warps
of a group of 32 tiles; values that cross warps go through shared
memory, with a block barrier between stages; each warp's stream is a
device function of its own unit. So the units of a frame compile in
parallel. MIN / MAX (and the interval
folds of ABS, SQUARE and DIV) are one min.NaN / max.NaN instruction.
Builds use `cuda.NVCC_FLAGS` (without -shared for the objects; U2's
units add INTERVAL_FLAGS) and go
to `fidget_tpu_torch/_build/unrolled-<hash>/`, keyed by a hash of the
emitter, the template, `ops.cuh`, the flags, the tape fields and the
variant, so a second frame or a second process rebuilds nothing. A
failed build or launch raises; nothing falls back to the plain versions
on a CUDA tensor.

`unrolled_float` / `unrolled_interval` / `unrolled_voxel_depth` /
`unrolled_voxel_fold` / `unrolled_interval3` / `unrolled_proofs3` /
`unrolled_points` / `leaf_masks` / `merge_topo` /
`unrolled_edges` / `level_active` /
`unrolled_interval_boxes` dispatch on the device of their tensors: on
the CPU
they run their `_plain` versions (eval/unrolled_fast.py's evaluators),
which take tensors on any device, so the kernels can be held against
them on the card. `cuda.LAUNCHES` counts each kernel under its own
name. A kernel's source and key are emitted at its first `unit()`, a
span of `utils` (`fidget.kernels.emit`), as are the builds
(`fidget.kernels.build`, counted in `kernels.built`) and the loads
(`fidget.kernels.load`, `kernels.loaded`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import pathlib
import subprocess
import threading

import numpy as np
import torch

from ..compiler.tape import (
    BINARY_TAPE_OPS,
    CHOICE_TAPE_OPS,
    IMM,
    UNARY_TAPE_OPS,
    Tape,
    TapeOp,
)
from ..render.transform import transform_intervals, transform_points
from ..utils import count, span
from . import cuda
from .arith import IntervalMode
from .unrolled_fast import eval_tape_float_fast, eval_tape_interval_fast

TEMPLATE = cuda.CSRC / "unrolled.cuh"
#: the files every generated build depends on besides its own source
SOURCES = (pathlib.Path(__file__).resolve(), TEMPLATE, cuda.CSRC / "ops.cuh")
EPILOGUES = {"proofs": 0, "capture": 1, "violation": 2}
#: U1-P's epilogues: the f32 distance, or the sign d < 0
POINT_EPILOGUES = ("distance", "sign")
#: U1 programs of at most this many rows (one-op probes, tiny shapes)
#: share one translation unit: nvcc's fixed cost a unit is most of
#: their build, so apart they cost steps and save no time (chip_smoke.py
#: phase 6e's 78 one-op programs on the 8 cores of an H100 machine: 147
#: nvcc steps in 45.8 s apart, 70 in 27.1 s shared)
SMALL_PROGRAM_ROWS = 16
#: U2's warps a group of 32 tiles (4 beat 2, 8 and 16 on the stand-in)
INTERVAL_WARPS = 4
#: U2's units at most 128 registers a thread: 16 warps an SM, four
#: blocks of 4, so that the stand-in's 512 blocks (16,384 tiles) run in
#: one wave on the card's 132 SMs; at 131 registers three blocks fit and
#: the violation epilogue took 1.77x (`PERF.md` §6)
INTERVAL_FLAGS = ("-maxrregcount=128",)
#: params layout of both kernels: mat [4, 4], z, then the V input values
PARAM_VARS = 17
#: the mesher's packed lattice key: (x * KS + y) * KS + z, coordinates
#: <= 1024 (depth <= 10) at any level
LATTICE_KS = 1025
#: rows of `unrolled_edges`' output: the brackets ta, tb, the
#: intersection's world x, y, z, its model x, y, z and the distance there
EDGE_OUTS = 9
#: U2-B's threads a block and its units' nvcc flags (one thread a box)
BOX_BLOCK = 128
BOX_FLAGS = INTERVAL_FLAGS
#: U2-3D's layouts, warps a group of 32 boxes: the ones measured
#: (`probe_kernels.py --compiled3d`); `proofs3_warps` picks 1 or
#: INTERVAL_WARPS
PROOFS3_WARPS = (1, 4, 8, 16)
#: U2-3D takes one thread a box from this many groups of 32 boxes on: a
#: warp for each of the card's 528 schedulers (the gyroid's 1,040 groups
#: ran 1.7x faster at one thread a box than at 4 warps a group, the
#: union's 18 groups 2.6x slower: `PERF.md` §6)
PROOFS3_ONE_THREAD_GROUPS = 132 * 4
#: U1-3D's lanes a column (`voxel_group`), and the threads it aims for:
#: twice the 2,048 resident on each of the card's 132 SMs (the union's
#: 128 slots ran fastest at 16 lanes; the gyroid's strata of 640-1,024
#: slots at 2 and 4 alike, both ahead of 1 and 8: `PERF.md` §6)
VOXEL_GROUPS = (1, 2, 4, 8, 16)
FILL_THREADS = 2 * 132 * 2048

_UNARY = frozenset(int(o) for o in UNARY_TAPE_OPS)
_BINARY = frozenset(int(o) for o in BINARY_TAPE_OPS)
_CHOICE = frozenset(int(o) for o in CHOICE_TAPE_OPS)


# ======================================================================
# emitter


def _lit(x: float) -> str:
    """An exact f32 literal."""
    x = float(np.float32(x))
    if math.isnan(x):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(x):
        return "__int_as_float(0x7f800000)" if x > 0 else \
            "__int_as_float(0xff800000)"
    return f"{x.hex()}f"


def _decls(tape: Tape) -> str:
    """A float local per tape register and memory slot."""
    names = [f"r{i}" for i in range(max(tape.reg_count, 1))]
    names += [f"m{i}" for i in range(tape.mem_count)]
    return "".join(f"  float {n} = 0.f;\n" for n in names)


def _float_rows(tape: Tape):
    """One statement per tape row, float mode (eval_tape_float_fast)."""
    for op, out, a, b, imm, aux in tape.rows():
        op = int(op)
        A = _lit(imm) if a == IMM else f"r{a}"
        B = _lit(imm) if b == IMM else f"r{b}"
        name = TapeOp(op).name
        if op == TapeOp.INPUT:
            yield f"r{out} = i{aux};"
        elif op == TapeOp.OUTPUT:
            yield f"o = r{out};" if aux == 0 else f"/* OUTPUT[{aux}] */;"
        elif op == TapeOp.COPY:
            yield f"r{out} = {A};"
        elif op == TapeOp.LOAD:
            yield f"r{out} = m{aux};"
        elif op == TapeOp.STORE:
            yield f"m{aux} = r{out};"
        elif op == TapeOp.MIN:
            yield f"r{out} = u_fmin({A}, {B});"
        elif op == TapeOp.MAX:
            yield f"r{out} = u_fmax({A}, {B});"
        elif op == TapeOp.AND:
            yield f"r{out} = ({A} == 0.f) ? {A} : {B};"
        elif op == TapeOp.OR:
            yield f"r{out} = ({A} != 0.f) ? {A} : {B};"
        elif op in _BINARY:
            yield f"r{out} = f_binary(OP_{name}, {A}, {B});"
        elif op in _UNARY:
            yield f"r{out} = f_unary(OP_{name}, {A});"
        else:
            raise ValueError(f"cannot emit op {op}")


def _axis_defines(axis_of: dict) -> str:
    ax = [axis_of.get(k, -1) for k in ("x", "y", "z")]
    return (f"#define U_AX {ax[0]}\n#define U_AY {ax[1]}\n"
            f"#define U_AZ {ax[2]}\n")


def _tape_digest(tape: Tape) -> bytes:
    h = hashlib.sha256()
    for f in (tape.op, tape.out, tape.a, tape.b, tape.imm, tape.aux):
        h.update(np.ascontiguousarray(f).tobytes())
    h.update(repr((tape.reg_count, tape.mem_count, tape.choice_count,
                   tape.output_count)).encode())
    return h.digest()


def cache_key(*parts) -> str:
    """The build key of a generated unit: a hash of the emitter, the
    template, ops.cuh, the nvcc flags and `parts` (tape digests and the
    variant)."""
    h = hashlib.sha256()
    for p in SOURCES:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(cuda.NVCC_FLAGS).encode())
    for part in parts:
        h.update(part if isinstance(part, bytes) else repr(part).encode())
    return h.hexdigest()[:20]


_PROGRAM_HEAD = '#include "unrolled.cuh"\nusing namespace fidget;\n'


def _float_function(tape: Tape, V: int, name: str) -> str:
    """`float name(float i0, ..., float i{V-1})`: one tape's program."""
    args = ", ".join(f"float i{k}" for k in range(V))
    body = "".join(f"  {st}\n" for st in _float_rows(tape))
    return (
        f'extern "C" __device__ __noinline__ float {name}({args}) {{\n'
        f"{_decls(tape)}  float o = 0.f;\n{body}  return o;\n}}\n"
    )


def emit_float_program(tape: Tape, V: int, name: str) -> str:
    """A float program in a unit of its own:
    `float name(float i0, ..., float i{V-1})`."""
    return _PROGRAM_HEAD + _float_function(tape, V, name)


def emit_float_kernel(names: list, V: int, axis_of: dict,
                      kernel: str = "U_FLOAT_KERNEL") -> str:
    """U1's kernel unit: the dispatch of segment s to program names[s]
    (the last segment and beyond: the last program), each in a unit
    that `FloatKernel.unit` builds; `kernel` the template's kernel
    macro (U1-3D: U_VOXEL_KERNEL)."""
    args = ", ".join("float" for _ in range(V))
    call = ", ".join(f"in[{k}]" for k in range(V))
    decls = "".join(f'extern "C" __device__ float {n}({args});\n'
                    for n in dict.fromkeys(names))
    cases = "".join(f"    case {s}: return {n}({call});\n"
                    for s, n in enumerate(names[:-1]))
    return (
        f"#define U_V {V}\n{_axis_defines(axis_of)}"
        f'#include "unrolled.cuh"\n#define U_NSEG {len(names)}\n{decls}'
        "static __device__ __forceinline__ float u_run(int s, const float* in) "
        "{\n  (void)s;\n  switch (s) {\n"
        f"{cases}    default: return {names[-1]}({call});\n  }}\n}}\n"
        f"{kernel}\n"
    )


# ----------------------------------------------------------------------
# U2: the tape's rows over the k warps of a group

#: a group's hand-off slots (32 Ivals each) may take this much shared
#: memory; a tape that needs more gets fewer warps a group
SLOT_BUDGET = 40 * 1024
#: shared memory a block of U2 may take in all (hand-off slots, choice
#: words, violation flags): the card's 227 KB less room for the runtime.
#: A tape whose words would pass it keeps them in global memory.
SHARED_LIMIT = 200 * 1024


class IntervalSchedule:
    """U2's rows spread over the k warps of a group.

    The tape is renamed into values: a computing row defines the value
    ("row", i); INPUT, COPY, LOAD and STORE only rename, so that a value
    is ("row", i), ("in", aux) or ("imm", x) (an unwritten register or
    memory slot reads ("imm", 0.0)). The computing rows are ordered
    depth-first from the output (operand a before b; rows that do not
    reach it follow in tape order), and that order is cut into k runs of
    equal length, one a warp (weighting rows by an estimate of their
    op's cost moved 5 of the stand-in's 7,200 rows and left U2's time
    as it was: `PERF.md` §6). A row's stage is the latest of its
    operands' stages, plus one for an operand of another warp; a warp
    runs its rows stage by stage, in that order, with a block barrier
    between stages. A value read by another warp goes to a hand-off slot,
    stored in its producer's stage and read (once a consumer warp, at its
    first use) in later ones; a slot is reused by a value stored after
    the stage of the previous value's last read.

    Attributes: k; order (computing rows); warp_of, stage_of; n_stages;
    operands[i] = (A, B) value refs (B None for unary ops); b_imm[i] (b
    is the row's immediate, which DIV treats apart); choice_of[i] = j;
    slot_of[i] and last_read[i] of the values that cross warps; n_slots;
    out, the output's value ref (None without an OUTPUT 0 row); runs[w]
    = [[rows of stage s] for s]; flush[w] = {row: word} where warp w's
    part of a word is done.
    """

    def __init__(self, tape: Tape, k: int):
        self.tape = tape
        self.k = k
        self.operands, self.b_imm, self.choice_of = {}, {}, {}
        self.op = {}
        zero = ("imm", 0.0)
        cur, mem = {}, {}
        self.out = None
        rows = []
        for i, (op, out, a, b, imm, aux) in enumerate(tape.rows()):
            op, out, a, b, aux = int(op), int(out), int(a), int(b), int(aux)

            def ref(sel):
                return ("imm", float(imm)) if sel == IMM else cur.get(sel, zero)

            if op == TapeOp.INPUT:
                cur[out] = ("in", aux)
            elif op == TapeOp.OUTPUT:
                if aux == 0:
                    self.out = cur.get(out, zero)
            elif op == TapeOp.COPY:
                cur[out] = ref(a)
            elif op == TapeOp.LOAD:
                cur[out] = mem.get(aux, zero)
            elif op == TapeOp.STORE:
                mem[aux] = cur.get(out, zero)
            elif op in _BINARY or op in _UNARY:
                self.op[i] = op
                self.operands[i] = (ref(a), ref(b) if op in _BINARY else None)
                self.b_imm[i] = b == IMM
                if op in _CHOICE:
                    self.choice_of[i] = len(self.choice_of)
                cur[out] = ("row", i)
                rows.append(i)
            else:
                raise ValueError(f"cannot emit op {op}")
        if len(self.choice_of) != tape.choice_count:
            raise ValueError("tape.choice_count does not match its choice ops")
        self.producers = {
            i: [v[1] for v in self.operands[i] if v is not None and v[0] == "row"]
            for i in rows
        }
        self.order = self._depth_first(rows)
        self._partition()

    def _depth_first(self, rows):
        order, seen = [], set()
        roots = ([self.out[1]] if self.out and self.out[0] == "row" else [])
        for root in roots + rows:
            stack = [(root, False)]
            while stack:
                i, done = stack.pop()
                if done:
                    order.append(i)
                    continue
                if i in seen:
                    continue
                seen.add(i)
                stack.append((i, True))
                stack.extend((p, False) for p in reversed(self.producers[i])
                             if p not in seen)
        return order

    def _partition(self):
        k = self.k
        total = len(self.order) or 1
        self.warp_of, self.stage_of = {}, {}
        for at, i in enumerate(self.order):
            self.warp_of[i] = min(k - 1, int((at + 0.5) * k / total))
        for i in self.order:
            self.stage_of[i] = max(
                [self.stage_of[p] + (self.warp_of[p] != self.warp_of[i])
                 for p in self.producers[i]], default=0)
        self.n_stages = max(self.stage_of.values(), default=0) + 1
        self.runs = [[[] for _ in range(self.n_stages)] for _ in range(k)]
        for i in self.order:
            self.runs[self.warp_of[i]][self.stage_of[i]].append(i)
        # the stage of each consumer warp's first read of a crossing value
        first = {}
        for i in self.order:
            for p in set(self.producers[i]):
                if self.warp_of[p] != self.warp_of[i]:
                    key = (p, self.warp_of[i])
                    first[key] = min(first.get(key, self.n_stages),
                                     self.stage_of[i])
        self.last_read = {}
        for (p, _), s in first.items():
            self.last_read[p] = max(self.last_read.get(p, 0), s)
        pos = {i: n for n, i in enumerate(self.order)}
        self.slot_of, free_at = {}, []
        for p in sorted(self.last_read, key=lambda p: (self.stage_of[p],
                                                       pos[p])):
            s = self.stage_of[p]
            slot = next((j for j, f in enumerate(free_at) if f <= s), None)
            if slot is None:
                slot = len(free_at)
                free_at.append(0)
            free_at[slot] = self.last_read[p] + 1
            self.slot_of[p] = slot
        self.n_slots = len(free_at)
        self.flush = []
        for w in range(k):
            seq = [i for run in self.runs[w] for i in run if i in self.choice_of]
            fl = {}
            for i, nxt in zip(seq, seq[1:] + [None]):
                word = self.choice_of[i] // 16
                if nxt is None or self.choice_of[nxt] // 16 != word:
                    fl[i] = word
            self.flush.append(fl)

    def shared_bytes(self) -> int:
        """The hand-off slots' shared memory."""
        return self.n_slots * 32 * 8


def schedule_interval(tape: Tape, warps: int) -> IntervalSchedule:
    """The schedule at `warps` warps a group, or at half as many (down
    to 1) while its hand-off slots exceed SLOT_BUDGET."""
    k = warps
    while True:
        sched = IntervalSchedule(tape, k)
        if k == 1 or sched.shared_bytes() <= SLOT_BUDGET:
            return sched
        k //= 2


def _ival(v) -> str:
    """The C++ expression of a value ref."""
    kind, x = v
    if kind == "row":
        return f"v{x}"
    if kind == "in":
        return f"in[{x}]"
    L = _lit(x)
    return f"Ival{{{L}, {L}}}"


def _interval_expr(sched: IntervalSchedule, i: int) -> str:
    op = sched.op[i]
    A, B = (_ival(v) if v is not None else None for v in sched.operands[i])
    name = TapeOp(op).name
    if op == TapeOp.MIN:
        return f"u_min({A}, {B}, c_)"
    if op == TapeOp.MAX:
        return f"u_max({A}, {B}, c_)"
    if op in (TapeOp.AND, TapeOp.OR):
        return f"i_choice(OP_{name}, {A}, {B}, &c_)"
    if op == TapeOp.DIV:
        if not sched.b_imm[i]:
            return f"u_div({A}, {B})"
        if sched.operands[i][1][1] != 0.0:
            return f"u_div_corners({A}, {B})"
        return "Ival{f_nan(), f_nan()}"
    if op == TapeOp.SQUARE:
        return f"u_square({A})"
    if op == TapeOp.ABS:
        return f"u_abs({A})"
    if op in _BINARY:
        return f"i_binary(OP_{name}, {A}, {B})"
    return f"i_unary(OP_{name}, {A})"


def interval_warp_rows(sched: IntervalSchedule, w: int) -> list:
    """Warp w's statements: its rows stage by stage with U_BAR() between
    stages, crossing values loaded from their slots at first use and
    stored after they are computed, the choices' U_CHOICE / U_WORD and
    the output's U_OUT."""
    lines, loaded = [], set()
    if w == 0 and (sched.out is None or sched.out[0] != "row"):
        v = ("imm", 0.0) if sched.out is None else sched.out
        lines.append(f"U_OUT({_ival(v)});")
    for s, run in enumerate(sched.runs[w]):
        if s:
            lines.append("U_BAR();")
        for i in run:
            for p in sched.producers[i]:
                if sched.warp_of[p] != w and p not in loaded:
                    loaded.add(p)
                    lines.append(f"const Ival v{p} = U_SH({sched.slot_of[p]});")
            line = f"const Ival v{i} = {_interval_expr(sched, i)};"
            j = sched.choice_of.get(i)
            if j is not None:
                line += f" U_CHOICE({2 * (j % 16)}, c_);"
                if i in sched.flush[w]:
                    line += f" U_WORD({sched.flush[w][i]});"
            lines.append(line)
            if i in sched.slot_of:
                lines.append(f"U_SH({sched.slot_of[i]}) = v{i};")
            if sched.out == ("row", i):
                lines.append(f"U_OUT(v{i});")
    return lines


def _interval_defines(V: int, axis_of: dict, epilogue: str, k: int,
                      z3: bool = False, box: bool = False) -> str:
    return (f"#define U_EPI {EPILOGUES[epilogue]}\n#define U_V {V}\n"
            f"{_axis_defines(axis_of)}#define U_K {k}\n"
            + ("#define U_Z3 1\n" if z3 else "")
            + ("#define U_BOX 1\n" if box else ""))


def emit_interval_warp(sched: IntervalSchedule, w: int, V: int,
                       axis_of: dict, epilogue: str, name: str,
                       z3: bool = False, box: bool = False) -> str:
    """Warp w's stream of U2 as a device function of its own unit
    (`z3`: of U2-3D, over 3D boxes; `box`: of U2-B, over explicit
    boxes)."""
    body = "".join(f"  {r}\n" for r in interval_warp_rows(sched, w))
    return (
        f"{_interval_defines(V, axis_of, epilogue, sched.k, z3, box)}"
        f'#include "unrolled.cuh"\nU_WARP_BEGIN({name})\n{body}U_WARP_END\n'
    )


def emit_interval_kernel(sched: IntervalSchedule, V: int, axis_of: dict,
                         epilogue: str, names: list, gw: bool,
                         z3: bool = False) -> str:
    """U2's kernel unit: warp w calls the stream names[w]; the blocks'
    choice words in a global scratch (gw) or in their shared memory
    (`z3`: U2-3D, whose streams take the boxes' z0 too)."""
    decls = "".join(f'extern "C" __device__ void {n}(U_WARP_ARGS);\n'
                    for n in names)
    if z3:
        args = ("x0, y0, z0, params, T0, Ts, nl, sh, wd, rin, rout, tile, "
                "live")
    else:
        args = "x0, y0, params, T0, sh, wd, rin, rout, tile, live"
    cases = "".join(f"    case {w}: {n}({args}); break;\n"
                    for w, n in enumerate(names[:-1]))
    return (
        f"{_interval_defines(V, axis_of, epilogue, sched.k, z3)}"
        f"#define U_SLOTS {sched.n_slots}\n"
        f"#define U_CW {-(-sched.tape.choice_count // 16)}\n"
        f"#define U_GW {int(gw)}\n"
        f'#include "unrolled.cuh"\n{decls}'
        "static __device__ __forceinline__ void u_warps(int w, U_WARP_ARGS) {\n"
        f"  switch (w) {{\n{cases}    default: {names[-1]}({args});\n"
        f"  }}\n}}\nU_INTERVAL_KERNEL\n"
    )


def emit_box_kernel(name: str, V: int, axis_of: dict, block: int) -> str:
    """U2-B's kernel unit: the stream `name` (one thread a box) behind
    U_BOX_KERNEL (box planes) and U_LEVEL_KERNEL (a parent's children),
    `block` threads a block."""
    return (
        f"{_interval_defines(V, axis_of, 'proofs', 1, box=True)}"
        f"#define U_BLOCK {block}\n#define U_KS {LATTICE_KS}\n"
        f'#include "unrolled.cuh"\n'
        f'extern "C" __device__ fidget::Ival {name}(U_WARP_ARGS);\n'
        f"#define u_box {name}\nU_BOX_KERNEL\nU_LEVEL_KERNEL\n"
    )


def emit_edge_tables() -> str:
    """The edge search's tables (mesh/tables.py: each edge's corners) and
    the key stride, for U_EDGE_KERNEL."""
    from ..mesh.tables import EDGE_HI, EDGE_LO

    def table(name, a):
        return (f"static __constant__ int {name}[12] = "
                f"{{{', '.join(str(int(v)) for v in a)}}};\n")

    return (table("u_edge_lo", EDGE_LO) + table("u_edge_hi", EDGE_HI)
            + f"#define U_KS {LATTICE_KS}\n")


def emit_table_defs() -> str:
    """The sign table's constants for U_TABLE_KERNEL: the key stride and
    mesh/collapse.py's topology test as lattice indices (the corners,
    the 12 edge checks (mid, a, b), the 6 face checks (mid, 4 corners),
    the centre) with the corner masks whose VERT_COUNT is 1 as a bit a
    mask."""
    from ..mesh.collapse import (_CENTER_LAT, _CORNER_LAT, _EDGE_CHECKS,
                                 _FACE_CHECKS)
    from ..mesh.tables import VERT_COUNT

    def table(ctype, name, vals):
        return (f"static __constant__ {ctype} {name}[{len(vals)}] = "
                f"{{{', '.join(vals)}}};\n")

    def ints(a):
        return [str(int(v)) for v in np.asarray(a).reshape(-1)]

    one = (np.asarray(VERT_COUNT) == 1).reshape(8, 32)
    vc1 = [f"{sum(1 << b for b in np.nonzero(w)[0].tolist())}u" for w in one]
    return (f"#define U_KS {LATTICE_KS}\n"
            f"#define U_TOPO_CENTER {int(_CENTER_LAT)}\n"
            + table("int", "u_topo_corner", ints(_CORNER_LAT))
            + table("int", "u_topo_edge", ints(_EDGE_CHECKS))
            + table("int", "u_topo_face", ints(_FACE_CHECKS))
            + table("unsigned", "u_topo_vc1", vc1))


# ======================================================================
# building


class _Unit:
    """One generated build product: a library (`lib.so`) linked from the
    kernel's unit and the objects it calls (float programs or warp
    streams); `flags` are added to the kernel unit's nvcc."""

    def __init__(self, key, source, objects, flags=()):
        self.key = key
        self.source = source
        self.objects = list(objects)  # _Object
        self.flags = tuple(flags)
        self.dir = cuda.BUILD_ROOT / f"unrolled-{key}"
        self.lib = self.dir / "lib.so"


class _Object:
    """A float program or a warp stream of an interval kernel, compiled
    into a relocatable object (`flags` added to its nvcc)."""

    def __init__(self, key, source, flags=()):
        self.key = key
        self.source = source
        self.flags = tuple(flags)
        self.dir = cuda.BUILD_ROOT / f"unrolled-{key}"
        self.obj = self.dir / "prog.o"


def _write_source(d: pathlib.Path, name: str, text: str) -> pathlib.Path:
    d.mkdir(parents=True, exist_ok=True)
    p = d / name
    if not p.exists() or p.read_text() != text:
        p.write_text(text)
    return p


def build(units) -> dict:
    """Builds every unit of `units` that has no library yet: every
    missing object (programs or warp streams) and every kernel unit with
    one `nvcc -rdc=true -c` each, all started together, then the links,
    together.
    Returns {step: seconds from its batch's start to its end}
    of the steps that ran; raises with nvcc's output if any fails.
    `<name>.log` beside each product keeps nvcc's output (registers,
    spills)."""
    nvcc = cuda._nvcc()
    flags = [f for f in cuda.NVCC_FLAGS if f != "-shared"]
    compile_ = [nvcc, *flags, "-rdc=true", "-I", str(cuda.CSRC), "-c"]
    todo = list({u.key: u for u in units if not u.lib.exists()}.values())
    objs = {o.key: o for u in todo for o in u.objects if not o.obj.exists()}
    steps = [
        (o.key, [*compile_, *o.flags,
                 str(_write_source(o.dir, "prog.cu", o.source))],
         o.obj, o.dir / "prog.log")
        for o in objs.values()
    ] + [
        (u.key, [*compile_, *u.flags,
                 str(_write_source(u.dir, "kernel.cu", u.source))],
         u.dir / "kernel.o", u.dir / "kernel.log")
        for u in todo
    ]
    seconds = {}
    if not steps:
        return seconds
    with span("fidget.kernels.build"):
        _run(steps, seconds)
        links = [
            (u.key + ":link",
             [nvcc, *cuda.NVCC_FLAGS, "-rdc=true", str(u.dir / "kernel.o"),
              *(str(o.obj) for o in {o.key: o for o in u.objects}.values())],
             u.lib, u.dir / "link.log")
            for u in todo
        ]
        _run(links, seconds)
    count("kernels.built", len(steps))
    return seconds


def _run(steps, seconds):
    """Runs every step (label, nvcc command, product, log) at once, each
    writing its product under a temporary name that is renamed when it
    succeeds; raises after all have ended if any failed."""
    import time

    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.perf_counter()
    procs = []
    for label, cmd, final, log in steps:
        tmp = final.with_name(f"{final.name}.{tag}")
        with open(log, "w") as f:
            procs.append((label, tmp, final, log, subprocess.Popen(
                [*cmd, "-o", str(tmp)], stdout=f, stderr=subprocess.STDOUT)))
    failed = []
    pending = list(procs)
    while pending:
        for item in list(pending):
            label, tmp, final, log, proc = item
            if proc.poll() is None:
                continue
            pending.remove(item)
            seconds[label] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append((label, log))
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, final)
        time.sleep(0.02)
    if failed:
        logs = "\n".join(
            f"{label}:\n{log.read_text()[-3000:]}" for label, log in failed
        )
        raise RuntimeError(f"nvcc failed for {len(failed)} generated "
                           f"unit(s):\n{logs}")


_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # cx0 cy0 valid params seg | nseg | out | n_slots tw pp | stream
    "fidget_unrolled_float_launch": [_P] * 5 + [_I, _P] + [_I] * 3 + [_P],
    # x0 y0 params | T0 | u rin rout words viol scratch | n | stream
    "fidget_unrolled_interval_launch": [_P] * 3 + [_F] + [_P] * 6 + [_I, _P],
    # bx by bz valid params out | n_slots sub group | stream
    "fidget_unrolled_voxel_depth_launch": [_P] * 6 + [_I] * 3 + [_P],
    # order count z_lo | y_base | ny2 nx2 | params floor | n_slots sub
    # group | stream
    "fidget_unrolled_voxel_fold_launch": [_P] * 3 + [_F] + [_I] * 2
    + [_P] * 2 + [_I] * 3 + [_P],
    # x0 y0 z0 params | T0 Ts | nl | u rin rout words viol scratch | n |
    # stream
    "fidget_unrolled_interval3_launch": [_P] * 4 + [_F] * 2 + [_I]
    + [_P] * 6 + [_I, _P],
    # x y z params count | cols | out | n | stream
    "fidget_unrolled_points_launch": [_P] * 5 + [_I, _P, _I, _P],
    # box params count | cols | rin rout | n | stream
    "fidget_unrolled_interval_boxes_launch": [_P] * 3 + [_I] + [_P] * 2
    + [_I, _P],
    # key mask slot count mat params | h | samples rounds group | out |
    # cap | stream
    "fidget_unrolled_edges_launch": [_P] * 6 + [_F] + [_I] * 3 + [_P, _I, _P],
    # keys count | cin | pos neg off3 params | hc | act kid | stream
    "fidget_unrolled_level_launch": [_P] * 2 + [_I] + [_P] * 4 + [_F]
    + [_P] * 3,
    # keys n_leaf | cl | mat params | h | slots | cap | list count | out
    # stream
    "fidget_unrolled_leaf_masks_launch": [_P] * 2 + [_I] + [_P] * 2 + [_F]
    + [_P, _I] + [_P] * 4,
    # pb3 | kcap n_cand half | mat params | h | slots | cap | list count |
    # topo stream
    "fidget_unrolled_merge_topo_launch": [_P] + [_I] * 3 + [_P] * 2 + [_F]
    + [_P, _I] + [_P] * 4,
    # old | old_cap | slots | cap | count stream
    "fidget_unrolled_table_grow_launch": [_P, _I, _P, _I, _P, _P],
}


def _load(unit: _Unit) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(unit.key)
        if lib is None:
            if not unit.lib.exists():
                build([unit])
            with span("fidget.kernels.load"):
                lib = ctypes.CDLL(str(unit.lib))
            count("kernels.loaded")
            for fn, argtypes in _ARGTYPES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _LIBS[unit.key] = lib
        return lib


# ======================================================================
# kernels


class FloatKernel:
    """U1 for a list of tapes sharing their inputs (V, axes): tape s
    serves the slots of segment s, the last one every slot from its
    segment's first on. Each program is a unit of its own, so that a
    frame's programs compile in parallel; programs of at most
    SMALL_PROGRAM_ROWS rows, where there are several, share one."""

    #: the unit's kind in its cache key
    KIND = "float-kernel"

    def __init__(self, tapes: list, axis_of: dict, V: int):
        self.tapes = list(tapes)
        self.axis_of = dict(axis_of)
        self.V = V
        self._unit = None
        self._segs = {}

    def seg_tensor(self, seg, device) -> torch.Tensor:
        """`seg` as an int32 tensor on `device`, kept with the kernel."""
        key = (tuple(seg), str(device))
        t = self._segs.get(key)
        if t is None:
            t = torch.tensor(key[0], dtype=torch.int32, device=device)
            self._segs[key] = t
        return t

    def _programs(self):
        """(objects, names): the program units and each tape's program
        name."""
        objects, names, small = [], [], {}
        for t in self.tapes:
            src = emit_float_program(t, self.V, "@")
            key = cache_key("float-program", _tape_digest(t), src)
            name = f"fidget_uprog_{key}"
            if len(t) <= SMALL_PROGRAM_ROWS:
                small[key] = _float_function(t, self.V, name)
            else:
                objects.append(_Object(
                    key, emit_float_program(t, self.V, name)))
            names.append(name)
        if small:  # a lone program keeps its own key
            key = (next(iter(small)) if len(small) == 1
                   else cache_key("float-programs", *small))
            objects.append(_Object(
                key, _PROGRAM_HEAD + "".join(small.values())))
        return objects, names

    def unit(self) -> _Unit:
        """The kernel's build unit, emitted at the first ask."""
        if self._unit is None:
            with span("fidget.kernels.emit"):
                objects, names = self._programs()
                source = emit_float_kernel(names, self.V, self.axis_of,
                                           self._macro())
                self._unit = _Unit(cache_key(self.KIND, source), source,
                                   objects)
        return self._unit

    def _macro(self) -> str:
        """The template's kernel macro (and what it needs defined)."""
        return "U_FLOAT_KERNEL"


class VoxelKernel(FloatKernel):
    """U1-3D for one tape: U1's program unit (shared with U1's of the
    same tape) behind the voxel-depth kernel unit."""

    KIND = "voxel-kernel"

    def __init__(self, tape: Tape, axis_of: dict, V: int):
        super().__init__([tape], axis_of, V)

    def _macro(self) -> str:
        return "U_VOXEL_KERNEL"


class PointsKernel(FloatKernel):
    """U1-P for one tape: U1's program unit (shared with U1's and
    U1-3D's of the same tape) behind the points kernel unit, with the
    epilogue ("distance" or "sign") fixed when the code is generated."""

    KIND = "points-kernel"

    def __init__(self, tape: Tape, axis_of: dict, V: int,
                 epilogue: str = "distance"):
        if epilogue not in POINT_EPILOGUES:
            raise ValueError(f"unknown points epilogue {epilogue!r}")
        super().__init__([tape], axis_of, V)
        self.epilogue = epilogue

    def _macro(self) -> str:
        return f"U_POINTS_KERNEL({int(self.epilogue == 'sign')})"


class EdgesKernel(FloatKernel):
    """U1-P's edge search for one tape: U1's program unit (shared with
    U1-P's) behind the edge kernel unit (U_EDGE_KERNEL)."""

    KIND = "edges-kernel"

    def __init__(self, tape: Tape, axis_of: dict, V: int):
        super().__init__([tape], axis_of, V)

    def _macro(self) -> str:
        return emit_edge_tables() + "U_EDGE_KERNEL"


class TableKernel(FloatKernel):
    """U1-P's sign table for one tape: U1's program unit (shared with
    U1-P's) behind the table kernel unit (U_TABLE_KERNEL: the insert,
    evaluation, mask and topology passes of `leaf_masks` and
    `merge_topo`)."""

    KIND = "table-kernel"

    def __init__(self, tape: Tape, axis_of: dict, V: int):
        super().__init__([tape], axis_of, V)

    def _macro(self) -> str:
        return emit_table_defs() + "U_TABLE_KERNEL"


class IntervalKernel:
    """U2 for one tape and one epilogue ("proofs", "capture",
    "violation"), its rows over INTERVAL_WARPS warps a group (fewer where
    the hand-offs pass SLOT_BUDGET)."""

    #: whether the tiles are 3D boxes (U2-3D)
    Z3 = False

    def __init__(self, tape: Tape, axis_of: dict, V: int, epilogue: str):
        if epilogue not in EPILOGUES:
            raise ValueError(f"unknown epilogue {epilogue!r}")
        self.tape = tape
        self.axis_of = dict(axis_of)
        self.V = V
        self.epilogue = epilogue
        self._sched = None
        self._unit = None

    @property
    def cw(self) -> int:
        return -(-self.tape.choice_count // 16)

    def schedule(self) -> IntervalSchedule:
        if self._sched is None:
            self._sched = schedule_interval(self.tape, INTERVAL_WARPS)
        return self._sched

    def _shared_bytes(self, words_shared: bool) -> int:
        words = (self.cw * 32 * 4 if words_shared
                 and self.epilogue != "proofs" else 0)
        flags = self.schedule().k * 32 if self.epilogue == "violation" else 0
        return self.schedule().shared_bytes() + words + flags

    @functools.cached_property
    def words_global(self) -> bool:
        """Whether the blocks' choice words live in a global scratch:
        where a block's shared memory would pass SHARED_LIMIT with them
        (fixed at the first ask)."""
        return self._shared_bytes(True) > SHARED_LIMIT

    def shared_bytes(self) -> int:
        """A block's shared memory: hand-off slots, choice words (capture,
        violation, unless `words_global`) and the warps' violation
        flags."""
        return self._shared_bytes(not self.words_global)

    def unit(self) -> _Unit:
        """The kernel's build unit, emitted at the first ask."""
        if self._unit is None:
            with span("fidget.kernels.emit"):
                self._unit = self._emit()
        return self._unit

    def _emit(self) -> _Unit:
        sched = self.schedule()
        args = (self.V, self.axis_of, self.epilogue)
        objects, names = [], []
        for w in range(sched.k):
            src = emit_interval_warp(sched, w, *args, "@", self.Z3)
            key = cache_key("interval-warp", _tape_digest(self.tape), src,
                            INTERVAL_FLAGS)
            name = f"fidget_uiw_{key}"
            objects.append(_Object(
                key, emit_interval_warp(sched, w, *args, name, self.Z3),
                INTERVAL_FLAGS))
            names.append(name)
        source = emit_interval_kernel(sched, *args, names,
                                      self.words_global, self.Z3)
        key = cache_key("interval-kernel", source, INTERVAL_FLAGS)
        return _Unit(key, source, objects, INTERVAL_FLAGS)


class Interval3Kernel(IntervalKernel):
    """U2-3D for one tape: U2's schedule and proofs over 3D boxes, at
    `warps` warps a group of 32 boxes (fewer where the hand-offs pass
    SLOT_BUDGET; 1: one thread a box, one stream, no barrier). The
    renderer takes `proofs3_warps` of its frame's box count."""

    Z3 = True

    def __init__(self, tape: Tape, axis_of: dict, V: int, *,
                 warps: int = INTERVAL_WARPS):
        if warps not in PROOFS3_WARPS:
            raise ValueError(f"warps must be one of {PROOFS3_WARPS}")
        super().__init__(tape, axis_of, V, "proofs")
        self.warps = int(warps)

    def schedule(self) -> IntervalSchedule:
        if self._sched is None:
            self._sched = schedule_interval(self.tape, self.warps)
        return self._sched


class BoxesKernel(IntervalKernel):
    """U2-B for one tape: the tape's interval rows as one stream (U2's
    schedule at one warp: no hand-off and no barrier), one thread a box,
    proofs only; `block` threads a block, `flags` the units' nvcc flags
    (BOX_BLOCK, BOX_FLAGS by default)."""

    #: proofs only: no choice words anywhere
    words_global = False

    def __init__(self, tape: Tape, axis_of: dict, V: int, *,
                 block: int | None = None, flags=None):
        super().__init__(tape, axis_of, V, "proofs")
        self.block = BOX_BLOCK if block is None else int(block)
        self.flags = BOX_FLAGS if flags is None else tuple(flags)

    def schedule(self) -> IntervalSchedule:
        if self._sched is None:
            self._sched = IntervalSchedule(self.tape, 1)
        return self._sched

    def _emit(self) -> _Unit:
        sched = self.schedule()
        args = (self.V, self.axis_of, self.epilogue)
        src = emit_interval_warp(sched, 0, *args, "@", box=True)
        key = cache_key("box-stream", _tape_digest(self.tape), src,
                        self.flags)
        name = f"fidget_ubox_{key}"
        obj = _Object(key, emit_interval_warp(sched, 0, *args, name,
                                              box=True), self.flags)
        source = emit_box_kernel(name, self.V, self.axis_of, self.block)
        key = cache_key("box-kernel", source, self.flags)
        return _Unit(key, source, [obj], self.flags)


def built(kernels) -> bool:
    """Whether every kernel's library is on disk."""
    return all(k.unit().lib.exists() for k in kernels)


def build_kernels(kernels) -> dict:
    """Builds the libraries of `kernels` (FloatKernel / IntervalKernel)
    that are missing, all together; returns the seconds of each step."""
    return build([k.unit() for k in kernels])


def params_tensor(mat, z, var_vec) -> torch.Tensor:
    """The params vector both kernels read: mat [4, 4], z, var values."""
    return torch.cat([mat.reshape(16), z.reshape(1), var_vec.reshape(-1)])


def unrolled_float(kern: FloatKernel, cx0, cy0, valid, params, seg, *,
                   tw: int, pp: int):
    """U1: f32 [n_slots, pp] distances of the pixels of a worklist of
    tiles. Slot k's pixel i lies at (cx0[k] + i % tw, cy0[k] + i // tw)
    in screen space; `seg` (host ints, ascending from 0) gives the first
    slot of each program's segment; invalid slots get 0. `params` is
    `params_tensor(mat, z, var_vec)`."""
    n = cx0.shape[0]
    if cy0.shape != (n,) or valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError("cx0, cy0 f32 [n] and valid bool [n] expected")
    if len(seg) != len(kern.tapes) or seg[0] != 0:
        raise ValueError("seg gives the first slot of each program, from 0")
    if params.shape != (PARAM_VARS + kern.V,):
        raise ValueError(f"params must be [{PARAM_VARS + kern.V}]")
    if params.device.type == "cpu":
        return unrolled_float_plain(kern, cx0, cy0, valid, params, seg,
                                    tw=tw, pp=pp)
    cuda.check_cuda(cx0, cy0, valid, params)
    out = torch.empty((n, pp), dtype=torch.float32, device=params.device)
    segt = kern.seg_tensor(seg, params.device)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fidget_unrolled_float_launch(
        cx0.data_ptr(), cy0.data_ptr(), valid.data_ptr(), params.data_ptr(),
        segt.data_ptr(), len(seg), out.data_ptr(), n, tw, pp, stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of unrolled_float failed with "
                           f"error {err}")
    cuda.LAUNCHES["unrolled_float"] += 1
    return out


def unrolled_float_plain(kern: FloatKernel, cx0, cy0, valid, params, seg, *,
                         tw: int, pp: int):
    """Plain PyTorch version of `unrolled_float` (same contract)."""
    n = cx0.shape[0]
    mat = params[:16].reshape(4, 4)
    z = params[16]
    ii = torch.arange(pp, dtype=torch.float32, device=params.device)
    bounds = list(seg) + [n]
    parts = []
    for s, tape in enumerate(kern.tapes):
        sl = slice(bounds[s], max(bounds[s], bounds[s + 1]))
        C = sl.stop - sl.start
        if C == 0:
            continue
        px = cx0[sl, None] + ii[None, :] % tw
        py = cy0[sl, None] + torch.div(ii, tw, rounding_mode="floor")[None, :]
        mx, my, mz = transform_points(mat, px, py, z)
        inputs = [params[PARAM_VARS + i].expand(C, pp)
                  for i in range(kern.V)]
        for kind, plane in (("x", mx), ("y", my), ("z", mz)):
            idx = kern.axis_of.get(kind)
            if idx is not None:
                inputs[idx] = torch.broadcast_to(plane, (C, pp))
        d = eval_tape_float_fast(tape, inputs)[0]
        parts.append(torch.where(valid[sl, None], d, torch.zeros_like(d)))
    if not parts:
        return params.new_zeros((n, pp))
    return torch.cat(parts, dim=0)


def unrolled_interval(kern: IntervalKernel, x0, y0, params, T0, u=None):
    """U2 over cull tiles [x0, x0 + T0] x [y0, y0 + T0]: returns
    (root_in, root_out, extra) bool [n] proofs (hi < 0, lo > 0) and the
    epilogue's output: None ("proofs"), int32 [cw, n] packed choice words
    ("capture"), or bool [n] violation flags against the int32 [cw', n]
    reference words `u` ("violation")."""
    n = x0.shape[0]
    if y0.shape != (n,):
        raise ValueError("x0, y0 must be f32 [n]")
    if params.shape != (PARAM_VARS + kern.V,):
        raise ValueError(f"params must be [{PARAM_VARS + kern.V}]")
    violation = kern.epilogue == "violation"
    if violation and (u is None or u.shape[1:] != (n,)
                      or u.shape[0] < kern.cw or u.dtype != torch.int32):
        raise ValueError(f"violation needs int32 u [>= {kern.cw}, {n}]")
    if params.device.type == "cpu":
        return unrolled_interval_plain(kern, x0, y0, params, T0, u)
    cuda.check_cuda(x0, y0, params)
    dev = params.device
    rin = torch.empty(n, dtype=torch.bool, device=dev)
    rout = torch.empty(n, dtype=torch.bool, device=dev)
    words = viol = scratch = None
    if kern.epilogue == "capture":
        words = torch.empty((kern.cw, n), dtype=torch.int32, device=dev)
    if violation:
        cuda.check_cuda(u)
        viol = torch.empty(n, dtype=torch.bool, device=dev)
    if kern.words_global and kern.epilogue != "proofs":
        # each block's [cw][32] words, zeroed by the block
        scratch = torch.empty(-(-n // 32) * kern.cw * 32, dtype=torch.int32,
                              device=dev)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    err = lib.fidget_unrolled_interval_launch(
        x0.data_ptr(), y0.data_ptr(), params.data_ptr(), float(T0),
        ptr(u if violation else None), rin.data_ptr(), rout.data_ptr(),
        ptr(words), ptr(viol), ptr(scratch), n, stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of unrolled_interval failed with "
                           f"error {err}")
    cuda.LAUNCHES["unrolled_interval"] += 1
    return rin, rout, words if words is not None else viol


def unrolled_interval_plain(kern: IntervalKernel, x0, y0, params, T0,
                            u=None):
    """Plain PyTorch version of `unrolled_interval` (same contract)."""
    n = x0.shape[0]
    im = IntervalMode(torch)
    mat = params[:16].reshape(4, 4)
    z = params[16]
    mxi, myi, mzi = transform_intervals(
        im, mat, (x0, x0 + T0), (y0, y0 + T0), (z, z)
    )
    inputs = []
    for i in range(kern.V):
        c = params[PARAM_VARS + i].expand(n)
        inputs.append((c, c))
    for kind, ivl in (("x", mxi), ("y", myi), ("z", mzi)):
        idx = kern.axis_of.get(kind)
        if idx is not None:
            inputs[idx] = (torch.broadcast_to(ivl[0], (n,)),
                           torch.broadcast_to(ivl[1], (n,)))
    if kern.epilogue == "capture":
        los, his, words = eval_tape_interval_fast(kern.tape, inputs,
                                                  capture=True)
        extra = (torch.stack(words) if words
                 else torch.zeros((0, n), dtype=torch.int32,
                                  device=x0.device))
    elif kern.epilogue == "violation":
        los, his, extra = eval_tape_interval_fast(kern.tape, inputs,
                                                  u_words=u)
    else:
        los, his = eval_tape_interval_fast(kern.tape, inputs)
        extra = None
    return his[0] < 0.0, los[0] > 0.0, extra


def voxel_group(n_slots: int, sub: int) -> int:
    """U1-3D's lanes a column for a launch of `n_slots` sub^3 slots: the
    most of VOXEL_GROUPS (at most `sub`, a power of two that divides it)
    whose threads, n_slots x sub^2 x G, still fit FILL_THREADS (1 where
    one lane a column passes it already)."""
    cols = max(1, int(n_slots) * int(sub) * int(sub))
    fits = [G for G in VOXEL_GROUPS
            if G <= sub and sub % G == 0 and cols * G <= FILL_THREADS]
    return max(fits, default=1)


def proofs3_warps(n_boxes: int) -> int:
    """U2-3D's layout for a frame of `n_boxes` boxes (root tiles and
    their subtiles), fixed when the kernel is generated: one thread a box
    where the boxes give a warp to every scheduler of the card
    (PROOFS3_ONE_THREAD_GROUPS groups of 32), else INTERVAL_WARPS warps a
    group, so that few groups still spread over several warps (8 and 16
    measured no faster on the union: more stages and hand-offs)."""
    groups = -(-int(n_boxes) // 32)
    return 1 if groups >= PROOFS3_ONE_THREAD_GROUPS else INTERVAL_WARPS


def _group_arg(group, n_slots, sub):
    G = voxel_group(n_slots, sub) if group is None else int(group)
    if G not in VOXEL_GROUPS or G > sub or sub % G:
        raise ValueError(f"group must be one of {VOXEL_GROUPS} dividing sub")
    return G


def unrolled_voxel_depth(kern: VoxelKernel, bx, by, bz, valid, params, *,
                         sub: int, group: int | None = None):
    """U1-3D's explicit entry: int32 [n, sub, sub] depth candidates of a
    worklist of sub^3 subtiles. Slot k's voxel (vz, vy, vx) lies at
    (bx[k] + vx, by[k] + vy, bz[k] + vz) in screen space; a column's
    value is the max over vz of `bz + vz + 1` where the tape's value
    there is < 0, else 0, and 0 on invalid slots. `params` is
    `params_tensor(mat, z, var_vec)` (z is not read); `group` the lanes
    a column (None: `voxel_group`)."""
    n = bx.shape[0]
    if by.shape != (n,) or bz.shape != (n,) or valid.shape != (n,) \
            or valid.dtype != torch.bool:
        raise ValueError("bx, by, bz f32 [n] and valid bool [n] expected")
    if params.shape != (PARAM_VARS + kern.V,):
        raise ValueError(f"params must be [{PARAM_VARS + kern.V}]")
    G = _group_arg(group, n, sub)
    if params.device.type == "cpu":
        return unrolled_voxel_depth_plain(kern, bx, by, bz, valid, params,
                                          sub=sub)
    cuda.check_cuda(bx, by, bz, valid, params)
    out = torch.empty((n, sub, sub), dtype=torch.int32, device=params.device)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fidget_unrolled_voxel_depth_launch(
        bx.data_ptr(), by.data_ptr(), bz.data_ptr(), valid.data_ptr(),
        params.data_ptr(), out.data_ptr(), n, sub, G, stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of unrolled_voxel_depth failed "
                           f"with error {err}")
    cuda.LAUNCHES["unrolled_voxel_depth"] += 1
    return out


def unrolled_voxel_depth_plain(kern: VoxelKernel, bx, by, bz, valid, params,
                               *, sub: int):
    """Plain PyTorch version of `unrolled_voxel_depth` (same contract):
    the whole tape over every voxel ((vz, vy, vx) row-major, as the
    reference's unrolled leaf forms them), then the max over vz."""
    n = bx.shape[0]
    k = torch.arange(sub**3, device=params.device)
    vx = (k % sub).to(torch.float32)
    vy = (torch.div(k, sub, rounding_mode="floor") % sub).to(torch.float32)
    vz = torch.div(k, sub * sub, rounding_mode="floor").to(torch.float32)
    mx, my, mz = transform_points(
        params[:16].reshape(4, 4), bx[:, None] + vx[None, :],
        by[:, None] + vy[None, :], bz[:, None] + vz[None, :],
    )
    inputs = [params[PARAM_VARS + i].expand(n, sub**3) for i in range(kern.V)]
    for kind, plane in (("x", mx), ("y", my), ("z", mz)):
        idx = kern.axis_of.get(kind)
        if idx is not None:
            inputs[idx] = torch.broadcast_to(plane, (n, sub**3))
    d = eval_tape_float_fast(kern.tapes[0], inputs)[0]
    inside = ((d < 0.0) & valid[:, None]).reshape(n, sub, sub, sub)
    vz_col = torch.arange(sub, dtype=torch.int32, device=params.device)
    top = (bz.to(torch.int32)[:, None, None, None]
           + vz_col[None, :, None, None] + 1)
    return torch.where(inside, top, torch.zeros_like(top)).amax(1)


def decode_worklist(order, count, *, ny2: int, nx2: int):
    """A stratum's compacted worklist (render3d.py `_compact_stratum`:
    the int64 subtile indices, every active one first, `count` of them)
    decoded: (valid, lz, gy, gx), slot k valid exactly when k < count,
    (lz, gy, gx) its slab-local subtile (int64)."""
    valid = torch.arange(order.shape[0], device=order.device) < count
    rem = order % (ny2 * nx2)
    return valid, order // (ny2 * nx2), rem // nx2, rem % nx2


def worklist_corners(lz, gy, gx, z_lo, *, sub: int, y_base: float = 0.0):
    """The screen-space base corners (bx, by, bz) f32 of decoded worklist
    slots, in render3d.py's f32 order: gx sub, gy sub (+ y_base, the
    slab's first global row, where it is not 0), lz sub + z_lo."""
    f32 = torch.float32
    by = (gy * sub).to(f32)
    if y_base:
        by = by + y_base
    return (gx * sub).to(f32), by, (lz * sub).to(f32) + z_lo


def fold_candidates(floor, dcand, order, valid, *, nl: int):
    """A stratum's depth candidates [cap, sub, sub] scattered back through
    the compaction's inverse and folded into the slab's floor [ny2 sub,
    nx2 sub] by max (a new tensor); `nl` subtiles a root tile's edge."""
    cap, sub = dcand.shape[0], dcand.shape[1]
    H, W = floor.shape
    ny2, nx2 = H // sub, W // sub
    slots = torch.arange(cap, device=order.device)
    slot_of = torch.full(
        (nl * ny2 * nx2,), cap, dtype=torch.int64, device=order.device
    ).scatter(0, order, torch.where(valid, slots, cap))
    dcand_pad = torch.cat([dcand, dcand.new_zeros((1, sub, sub))])
    slab_vox = (
        dcand_pad[slot_of]
        .reshape(nl, ny2, nx2, sub, sub)
        .permute(0, 1, 3, 2, 4)
        .reshape(nl, H, W)
        .amax(0)
    )
    return torch.maximum(floor, slab_vox)


def _fold_args(order, count, z_lo, params, floor, kern, sub):
    if order.dim() != 1 or order.dtype != torch.int64:
        raise ValueError("order must be int64 [cap]")
    if count.numel() != 1 or count.dtype != torch.int64:
        raise ValueError("count must be an int64 tensor of one element")
    if z_lo.numel() != 1 or z_lo.dtype != torch.float32:
        raise ValueError("z_lo must be an f32 tensor of one element")
    if params.shape != (PARAM_VARS + kern.V,):
        raise ValueError(f"params must be [{PARAM_VARS + kern.V}]")
    if floor.dim() != 2 or floor.dtype != torch.int32 or \
            floor.shape[0] % sub or floor.shape[1] % sub:
        raise ValueError("floor must be int32 [ny2 sub, nx2 sub]")
    return floor.shape[0] // sub, floor.shape[1] // sub


def unrolled_voxel_fold(kern: VoxelKernel, order, count, z_lo, params,
                        floor, *, sub: int, nl: int, y_base: float = 0.0,
                        group: int | None = None):
    """U1-3D's frame entry: one stratum's leaf, folded into its floor in
    place. `order` (int64 [cap]) is the stratum's compacted worklist of
    slab-local subtile indices (lz, gy, gx) row-major over [nl, ny2,
    nx2], every active one first and `count` (int64, one element, on the
    device) of them; slot k's subtile lies at screen corner (gx sub, gy
    sub + y_base, lz sub + z_lo) (`z_lo` f32, one element: the stratum's
    z base). Each column's depth (`unrolled_voxel_depth`) is folded into
    `floor` (int32 [ny2 sub, nx2 sub], contiguous: the slab's rows) by
    max at row gy sub + vy, column gx sub + vx. Returns `floor`."""
    ny2, nx2 = _fold_args(order, count, z_lo, params, floor, kern, sub)
    G = _group_arg(group, order.shape[0], sub)
    if params.device.type == "cpu":
        return unrolled_voxel_fold_plain(kern, order, count, z_lo, params,
                                         floor, sub=sub, nl=nl,
                                         y_base=y_base)
    if not floor.is_contiguous() or not order.is_contiguous():
        raise ValueError("floor and order must be contiguous")
    cuda.check_cuda(order, count, z_lo, params, floor)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fidget_unrolled_voxel_fold_launch(
        order.data_ptr(), count.data_ptr(), z_lo.data_ptr(), float(y_base),
        ny2, nx2, params.data_ptr(), floor.data_ptr(), order.shape[0], sub,
        G, stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of unrolled_voxel_fold failed "
                           f"with error {err}")
    cuda.LAUNCHES["unrolled_voxel_fold"] += 1
    return floor


def unrolled_voxel_fold_plain(kern: VoxelKernel, order, count, z_lo, params,
                              floor, *, sub: int, nl: int,
                              y_base: float = 0.0):
    """Plain PyTorch version of `unrolled_voxel_fold` (same contract):
    the worklist decoded, `unrolled_voxel_depth_plain` over its slots,
    then `fold_candidates` (render3d.py's scatter through the
    compaction's inverse), written into `floor`."""
    ny2, nx2 = _fold_args(order, count, z_lo, params, floor, kern, sub)
    valid, lz, gy, gx = decode_worklist(order, count, ny2=ny2, nx2=nx2)
    bx, by, bz = worklist_corners(lz, gy, gx, z_lo.reshape(()), sub=sub,
                                  y_base=y_base)
    dcand = unrolled_voxel_depth_plain(kern, bx, by, bz, valid, params,
                                       sub=sub)
    return floor.copy_(fold_candidates(floor, dcand, order, valid, nl=nl))


def interval3_bounds(kern: Interval3Kernel, x0, y0, z0, params, edge):
    """(lo, hi) f32 [n] of the tape over the boxes [x0, x0 + edge] x
    [y0, y0 + edge] x [z0, z0 + edge] through `transform_intervals`, by
    `eval_tape_interval_fast`: what `unrolled_interval3_plain` tests."""
    n = x0.shape[0]
    im = IntervalMode(torch)
    mxi, myi, mzi = transform_intervals(
        im, params[:16].reshape(4, 4), (x0, x0 + edge), (y0, y0 + edge),
        (z0, z0 + edge),
    )
    inputs = []
    for i in range(kern.V):
        c = params[PARAM_VARS + i].expand(n)
        inputs.append((c, c))
    for kind, ivl in (("x", mxi), ("y", myi), ("z", mzi)):
        idx = kern.axis_of.get(kind)
        if idx is not None:
            inputs[idx] = (torch.broadcast_to(ivl[0], (n,)),
                           torch.broadcast_to(ivl[1], (n,)))
    los, his = eval_tape_interval_fast(kern.tape, inputs)
    return los[0], his[0]


def _launch_interval3(kern, x0, y0, z0, params, T0, Ts, nl, n, name):
    """Launches U2-3D over n boxes (nl = 0: explicit corners; else the
    roots and their subtiles): (full, empty) bool [n]."""
    cuda.check_cuda(x0, y0, z0, params)
    dev = params.device
    full = torch.empty(n, dtype=torch.bool, device=dev)
    empty = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fidget_unrolled_interval3_launch(
        x0.data_ptr(), y0.data_ptr(), z0.data_ptr(), params.data_ptr(),
        float(T0), float(Ts), int(nl), None, full.data_ptr(),
        empty.data_ptr(), None, None, None, n, stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {err}")
    cuda.LAUNCHES[name] += 1
    return full, empty


def _corner_args(kern, x0, y0, z0, params):
    n = x0.shape[0]
    if y0.shape != (n,) or z0.shape != (n,):
        raise ValueError("x0, y0, z0 must be f32 [n]")
    if params.shape != (PARAM_VARS + kern.V,):
        raise ValueError(f"params must be [{PARAM_VARS + kern.V}]")
    return n


def unrolled_interval3(kern: Interval3Kernel, x0, y0, z0, params, edge):
    """U2-3D's explicit entry, over the boxes [x0, x0 + edge] x [y0, y0 +
    edge] x [z0, z0 + edge] (f32 [n] corners): (full, empty) bool [n],
    the proofs hi < 0 and lo > 0."""
    n = _corner_args(kern, x0, y0, z0, params)
    if params.device.type == "cpu":
        return unrolled_interval3_plain(kern, x0, y0, z0, params, edge)
    return _launch_interval3(kern, x0, y0, z0, params, edge, 0.0, 0, n,
                             "unrolled_interval3")


def unrolled_interval3_plain(kern: Interval3Kernel, x0, y0, z0, params,
                             edge):
    """Plain PyTorch version of `unrolled_interval3` (same contract)."""
    lo, hi = interval3_bounds(kern, x0, y0, z0, params, edge)
    return hi < 0.0, lo > 0.0


def unrolled_proofs3(kern: Interval3Kernel, x0, y0, z0, params, ts: int,
                     sub: int):
    """U2-3D's frame entry: the proofs of a frame's root tiles and of
    every subtile of them, in one launch. `x0`, `y0`, `z0` (f32 [nt]) are
    the roots' corners, in (tz, ty, tx) order (a whole frame or a slab of
    it); root t is [x0, x0 + ts] x ..., and its subtile j (of m = (ts /
    sub)^3, (lz, ly, lx) row-major) lies at the root's corner plus (lx,
    ly, lz) sub, with edge sub. Returns (full, empty), bool [nt, 1 + m]:
    column 0 the root's proofs hi < 0 and lo > 0, column 1 + j subtile
    j's."""
    n = _corner_args(kern, x0, y0, z0, params)
    if ts % sub:
        raise ValueError("ts must be a multiple of sub")
    nl = ts // sub
    m1 = nl**3 + 1
    if params.device.type == "cpu":
        return unrolled_proofs3_plain(kern, x0, y0, z0, params, ts, sub)
    full, empty = _launch_interval3(kern, x0, y0, z0, params, ts, sub, nl,
                                    n * m1, "unrolled_proofs3")
    return full.reshape(n, m1), empty.reshape(n, m1)


def subtile_corners(x0, y0, z0, ts: int, sub: int):
    """The corners of every subtile of the roots x0, y0, z0 (f32 [nt]),
    f32 [nt, m] each, (lz, ly, lx) row-major: the root's corner plus the
    f32 offsets (lx, ly, lz) sub, as render3d.py's `sub_dx` / `sub_dy` /
    `sub_dz` tables add them."""
    nl = ts // sub
    k = torch.arange(nl**3, device=x0.device)
    lx = ((k % nl) * sub).to(torch.float32)
    ly = ((torch.div(k, nl, rounding_mode="floor") % nl) * sub).to(
        torch.float32)
    lz = (torch.div(k, nl * nl, rounding_mode="floor") * sub).to(
        torch.float32)
    return (x0[:, None] + lx[None, :], y0[:, None] + ly[None, :],
            z0[:, None] + lz[None, :])


def unrolled_proofs3_plain(kern: Interval3Kernel, x0, y0, z0, params,
                           ts: int, sub: int):
    """Plain PyTorch version of `unrolled_proofs3` (same contract):
    `interval3_bounds` over the roots (edge ts) and over their subtiles'
    boxes (`subtile_corners`, edge sub)."""
    n = x0.shape[0]
    rlo, rhi = interval3_bounds(kern, x0, y0, z0, params, ts)
    sx0, sy0, sz0 = subtile_corners(x0, y0, z0, ts, sub)
    m = sx0.shape[1]
    slo, shi = interval3_bounds(kern, sx0.reshape(-1), sy0.reshape(-1),
                                sz0.reshape(-1), params, sub)
    lo = torch.cat([rlo.reshape(n, 1), slo.reshape(n, m)], dim=1)
    hi = torch.cat([rhi.reshape(n, 1), shi.reshape(n, m)], dim=1)
    return hi < 0.0, lo > 0.0


def _live_lanes(shape, count, device):
    """bool [*shape]: lane (..., c) is live when c < count (every lane
    with no count)."""
    if count is None:
        return torch.ones(shape, dtype=torch.bool, device=device)
    cols = torch.arange(shape[-1], device=device)
    return (cols < count.reshape(()).to(device)).expand(shape)


def _count_arg(count, n_cols):
    if count is not None and (count.dtype != torch.int32
                              or count.numel() != 1):
        raise ValueError("count must be an int32 tensor of one element")
    if n_cols <= 0:
        raise ValueError("the lists need at least one column")


def unrolled_points(kern: PointsKernel, x, y, z, params, count=None):
    """U1-P: the tape at model-space points x, y, z (f32, one shape, its
    last axis the columns): f32 distances, or bool `d < 0` under the
    "sign" epilogue, of the same shape. `params` holds the V input
    values; `count` (int32 [1], on the points' device) the live
    columns, whose lanes alone are evaluated: the others get 0 / False.
    """
    if y.shape != x.shape or z.shape != x.shape:
        raise ValueError("x, y, z must be f32 tensors of one shape")
    if params.shape != (kern.V,):
        raise ValueError(f"params must be [{kern.V}]")
    shape = x.shape
    _count_arg(count, shape[-1] if shape else 1)
    if params.device.type == "cpu":
        return unrolled_points_plain(kern, x, y, z, params, count)
    x, y, z = (a.contiguous() for a in (x, y, z))
    cuda.check_cuda(x, y, z, params, *([] if count is None else [count]))
    n = x.numel()
    sign = kern.epilogue == "sign"
    out = torch.empty(shape, dtype=torch.bool if sign else torch.float32,
                      device=params.device)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fidget_unrolled_points_launch(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), params.data_ptr(),
        None if count is None else count.data_ptr(), shape[-1],
        out.data_ptr(), n, stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of unrolled_points failed with "
                           f"error {err}")
    cuda.LAUNCHES["unrolled_points"] += 1
    return out


def _distance(kern: FloatKernel, x, y, z, params):
    """The tape's f32 distance at model points x, y, z (one shape):
    `eval_tape_float_fast` with the V input values from `params`."""
    inputs = [params[i].expand(x.shape) for i in range(kern.V)]
    for kind, a in (("x", x), ("y", y), ("z", z)):
        idx = kern.axis_of.get(kind)
        if idx is not None:
            inputs[idx] = a
    return torch.broadcast_to(eval_tape_float_fast(kern.tapes[0], inputs)[0],
                              x.shape)


def unrolled_points_plain(kern: PointsKernel, x, y, z, params, count=None):
    """Plain PyTorch version of `unrolled_points` (same contract): the
    whole tape over every lane, then the dead lanes masked."""
    d = _distance(kern, x, y, z, params)
    live = _live_lanes(x.shape, count, x.device)
    if kern.epilogue == "sign":
        return (d < 0.0) & live
    return torch.where(live, d, torch.zeros_like(d))


def unrolled_interval_boxes(kern: BoxesKernel, lo, hi, params, count=None):
    """U2-B over explicit model-space boxes [lo[0], hi[0]] x [lo[1],
    hi[1]] x [lo[2], hi[2]] (f32 tensors of one shape, its last axis the
    columns), on the kernel `level_active` runs: (full, empty) bool of
    that shape, the proofs hi < 0 and lo > 0 of the tape's output.
    `params` holds the V input values; `count` (int32 [1]) the live
    columns: a dead box gets neither proof."""
    shape = lo[0].shape
    if any(a.shape != shape for a in (*lo, *hi)):
        raise ValueError("the box corners must be f32 tensors of one shape")
    if params.shape != (kern.V,):
        raise ValueError(f"params must be [{kern.V}]")
    _count_arg(count, shape[-1] if shape else 1)
    if params.device.type == "cpu":
        return unrolled_interval_boxes_plain(kern, lo, hi, params, count)
    box = torch.stack([lo[0], hi[0], lo[1], hi[1], lo[2], hi[2]])
    cuda.check_cuda(box, params, *([] if count is None else [count]))
    dev = params.device
    n = lo[0].numel()
    full = torch.empty(shape, dtype=torch.bool, device=dev)
    empty = torch.empty(shape, dtype=torch.bool, device=dev)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fidget_unrolled_interval_boxes_launch(
        box.data_ptr(), params.data_ptr(),
        None if count is None else count.data_ptr(), shape[-1] if shape else 1,
        full.data_ptr(), empty.data_ptr(), n, stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of unrolled_interval_boxes failed "
                           f"with error {err}")
    cuda.LAUNCHES["unrolled_interval_boxes"] += 1
    return full, empty


def unrolled_interval_boxes_plain(kern: BoxesKernel, lo, hi, params,
                                  count=None):
    """Plain PyTorch version of `unrolled_interval_boxes` (same
    contract): the whole tape over every box, then the dead boxes
    masked."""
    shape = lo[0].shape
    inputs = []
    for i in range(kern.V):
        c = params[i].expand(shape)
        inputs.append((c, c))
    for k, kind in enumerate("xyz"):
        idx = kern.axis_of.get(kind)
        if idx is not None:
            inputs[idx] = (lo[k], hi[k])
    los, his = eval_tape_interval_fast(kern.tape, inputs)
    live = _live_lanes(shape, count, lo[0].device)
    return ((torch.broadcast_to(his[0], shape) < 0.0) & live,
            (torch.broadcast_to(los[0], shape) > 0.0) & live)


def edge_group(samples: int) -> int:
    """Lanes of `unrolled_edges` a slot: the sample count rounded up to
    a power of two, at most a warp (a warp's lanes then take samples
    i, i + 32, ...)."""
    return min(32, 1 << max(0, int(samples) - 1).bit_length())


def _edge_args(key, mask, slot, count, mat, params, kern, samples, rounds):
    cap = key.shape[0]
    if any(a.shape != (cap,) or a.dtype != torch.int32
           for a in (key, mask, slot)):
        raise ValueError("key, mask and slot must be int32 [cap]")
    _count_arg(count, cap)
    if count is None:
        raise ValueError("the crossing list needs its live count")
    if mat.shape != (3, 4) or params.shape != (kern.V,):
        raise ValueError(f"mat must be [3, 4] and params [{kern.V}]")
    if samples < 1 or rounds < 0:
        raise ValueError("samples >= 1 and rounds >= 0 expected")
    return cap


def unrolled_edges(kern: EdgesKernel, key, mask, slot, count, mat, params,
                   h: float, *, samples: int, rounds: int):
    """U1-P's edge search on a compacted list of crossing (cell, edge)
    slots: `key` the cell's packed lattice key (LATTICE_KS), `mask` its
    8-bit corner mask, `slot` 12 * cell + edge (the edge's index in
    mesh/tables.py), int32 [cap] each, `count` (int32 [1]) the live
    slots; `h` the cells' edge, `mat` [3, 4] the world -> model matrix,
    `params` the V input values. Each live slot's edge runs from its
    inside corner to its outside one through `rounds` rounds of
    `samples` samples (mesh/fused.py's N-ary search). Returns f32
    [EDGE_OUTS, cap]: ta, tb, the intersection's world x, y, z at the
    brackets' midpoint, its model x, y, z and the distance there; 0 at
    dead slots."""
    cap = _edge_args(key, mask, slot, count, mat, params, kern, samples,
                     rounds)
    if params.device.type == "cpu":
        return unrolled_edges_plain(kern, key, mask, slot, count, mat,
                                    params, h, samples=samples, rounds=rounds)
    mat = mat.contiguous()
    cuda.check_cuda(key, mask, slot, count, mat, params)
    out = torch.empty((EDGE_OUTS, cap), dtype=torch.float32,
                      device=params.device)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fidget_unrolled_edges_launch(
        key.data_ptr(), mask.data_ptr(), slot.data_ptr(), count.data_ptr(),
        mat.data_ptr(), params.data_ptr(), float(h), int(samples),
        int(rounds), edge_group(samples), out.data_ptr(), cap, stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of unrolled_edges failed with "
                           f"error {err}")
    cuda.LAUNCHES["unrolled_edges"] += 1
    return out


def _lattice(keys):
    """Packed keys -> (x, y, z) lattice coordinates (a -1 padding key
    decodes as 0)."""
    k = torch.clamp_min(keys, 0)
    ks = LATTICE_KS
    return k // (ks * ks), (k // ks) % ks, k % ks


def _model_pts(mat, wx, wy, wz):
    """mesh/fused.py's world -> model transform, left to right."""
    return tuple(
        mat[r, 0] * wx + mat[r, 1] * wy + mat[r, 2] * wz + mat[r, 3]
        for r in range(3)
    )


def unrolled_edges_plain(kern: EdgesKernel, key, mask, slot, count, mat,
                         params, h: float, *, samples: int, rounds: int,
                         margin: bool = False):
    """Plain PyTorch version of `unrolled_edges` (same contract): the
    dense rounds of mesh/fused.py's edge core over every slot of the
    list, then the dead slots zeroed. With `margin`, also the least
    |distance| of the samples each slot evaluated (f32 [cap]): how close
    its search came to a sign that rounding decides."""
    from ..mesh.tables import EDGE_HI, EDGE_LO

    cap = _edge_args(key, mask, slot, count, mat, params, kern, samples,
                     rounds)
    dev = params.device
    x, y, z = _lattice(key)
    e = (slot % 12).long()
    lo = torch.as_tensor(EDGE_LO, device=dev)[e]
    hi = torch.as_tensor(EDGE_HI, device=dev)[e]
    lo_in = (mask >> lo) & 1
    start = torch.where(lo_in == 1, lo, hi)
    end = torch.where(lo_in == 1, hi, lo)

    def corner(c):
        return tuple((v + ((c >> a) & 1)).to(torch.float32) * h - 1.0
                     for a, v in enumerate((x, y, z)))

    def dist(px, py, pz):
        return _distance(kern, *_model_pts(mat, px, py, pz), params)

    sx, sy, sz = corner(start)
    ex, ey, ez = corner(end)
    dx, dy, dz = ex - sx, ey - sy, ez - sz
    frac = (
        (torch.arange(samples, dtype=torch.float32, device=dev) + 1.0)
        / (samples + 1.0)
    )[:, None]
    idx = torch.arange(samples, device=dev)[:, None]
    ta = torch.zeros(cap, dtype=torch.float32, device=dev)
    tb = torch.ones(cap, dtype=torch.float32, device=dev)
    near = torch.full((cap,), math.inf, dtype=torch.float32, device=dev)
    for _ in range(rounds):
        ts = ta[None] + (tb - ta)[None] * frac  # [samples, cap]
        d = dist(sx[None] + dx[None] * ts, sy[None] + dy[None] * ts,
                 sz[None] + dz[None] * ts)
        if margin:
            near = torch.minimum(near, d.abs().amin(dim=0))
        outside = ~(d < 0.0)
        any_out = outside.any(dim=0)
        # the first flip: the least index of an outside sample
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
    mp = _model_pts(mat, *ip)
    out = torch.stack([ta, tb, *ip, *mp, dist(*ip)])
    live = _live_lanes((cap,), count, dev)
    out = torch.where(live[None, :], out, torch.zeros_like(out))
    if margin:
        return out, torch.where(live, near, torch.zeros_like(near))
    return out


def _level_args(keys, n_in, pos, neg, off3, params, kern):
    cin = keys.shape[0]
    if keys.shape != (cin,) or keys.dtype != torch.int32:
        raise ValueError("keys must be int32 [cin]")
    _count_arg(n_in, max(cin, 1))
    if n_in is None:
        raise ValueError("the parents need their live count")
    if pos.shape != (3, 3) or neg.shape != (3, 3) or off3.shape != (3,):
        raise ValueError("pos, neg [3, 3] and off3 [3] expected")
    if params.shape != (kern.V,):
        raise ValueError(f"params must be [{kern.V}]")
    return cin


def level_active(kern: BoxesKernel, keys, n_in, h_child: float, pos, neg,
                 off3, params):
    """U2-B on one octree level (mesh/fused.py's level core): the 8
    children of each parent in `keys` (int32 [cin] packed lattice keys,
    -1 padding; `n_in` int32 [1] the live parents), each child c of
    parent p the world box [2 p + o_c] h_child - 1 + [0, h_child] (o_c
    the corner offset (c & 1, c >> 1 & 1, c >> 2 & 1)), in model space
    through the world -> model matrix split by sign (pos, neg [3, 3],
    off3 [3]). Returns (act bool [cin, 8]: the child of a live parent is
    neither proven full nor empty; kid int32 [cin, 8]: its packed key)."""
    cin = _level_args(keys, n_in, pos, neg, off3, params, kern)
    if params.device.type == "cpu":
        return level_active_plain(kern, keys, n_in, h_child, pos, neg, off3,
                                  params)
    pos, neg, off3 = (a.contiguous() for a in (pos, neg, off3))
    cuda.check_cuda(keys, n_in, pos, neg, off3, params)
    dev = params.device
    act = torch.empty((cin, 8), dtype=torch.bool, device=dev)
    kid = torch.empty((cin, 8), dtype=torch.int32, device=dev)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.fidget_unrolled_level_launch(
        keys.data_ptr(), n_in.data_ptr(), cin, pos.data_ptr(),
        neg.data_ptr(), off3.data_ptr(), params.data_ptr(), float(h_child),
        act.data_ptr(), kid.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"CUDA launch of level_active failed with "
                           f"error {err}")
    cuda.LAUNCHES["level_active"] += 1
    return act, kid


def level_active_plain(kern: BoxesKernel, keys, n_in, h_child: float, pos,
                       neg, off3, params):
    """Plain PyTorch version of `level_active` (same contract): the
    boxes formed in torch ops in the reference's positive / negative
    coefficient order, then `unrolled_interval_boxes_plain`."""
    cin = _level_args(keys, n_in, pos, neg, off3, params, kern)
    kid, mlo, mhi = level_boxes(keys, h_child, pos, neg, off3)
    full, empty = unrolled_interval_boxes_plain(kern, mlo, mhi, params, n_in)
    live = (torch.arange(cin, device=keys.device) < n_in) & (keys >= 0)
    act = ~(full | empty) & live[None, :]
    return act.T.contiguous(), kid.T.contiguous()


def level_boxes(keys, h_child: float, pos, neg, off3):
    """The children of `level_active` in torch ops, child-major: (kid
    int32 [8, cin], the model boxes' lo and hi corners, three f32 [8,
    cin] each)."""
    x, y, z = _lattice(keys)
    off = torch.tensor([[(c >> a) & 1 for a in range(3)] for c in range(8)],
                       dtype=torch.int32, device=keys.device)
    cx = x[None, :] * 2 + off[:, 0, None]  # [8, cin]
    cy = y[None, :] * 2 + off[:, 1, None]
    cz = z[None, :] * 2 + off[:, 2, None]
    wlo = tuple(c.to(torch.float32) * h_child - 1.0 for c in (cx, cy, cz))
    whi = tuple(w + h_child for w in wlo)
    mlo = tuple(
        pos[r, 0] * wlo[0] + pos[r, 1] * wlo[1] + pos[r, 2] * wlo[2]
        + neg[r, 0] * whi[0] + neg[r, 1] * whi[1] + neg[r, 2] * whi[2]
        + off3[r]
        for r in range(3)
    )
    mhi = tuple(
        pos[r, 0] * whi[0] + pos[r, 1] * whi[1] + pos[r, 2] * whi[2]
        + neg[r, 0] * wlo[0] + neg[r, 1] * wlo[1] + neg[r, 2] * wlo[2]
        + off3[r]
        for r in range(3)
    )
    return (cx * LATTICE_KS + cy) * LATTICE_KS + cz, mlo, mhi


# ----------------------------------------------------------------------
# U1-P's sign table: each lattice point of a mesh build evaluated once


def _table_cap(inserts: int) -> int:
    """Slots for `inserts` keys at a load of at most 1/2: a power of two,
    at least 1024."""
    return max(1024, 1 << max(0, 2 * int(inserts) - 1).bit_length())


class SignTable:
    """The sign table of one mesh build (mesh/fused.py): each leaf-lattice
    point's key (x * KS + y) * KS + z with its sign d < 0, so that the
    leaf core and every collapse round evaluate a point once. A point's
    sign depends on its key alone, so the table gives the signs that the
    evaluation of every (cell, corner) or (candidate, lattice point) pair
    gives, bit for bit.

    The kernels' table (`plain` False, the default on the card): `slots`
    int32 [cap], open addressing with linear probing, -1 empty, the sign
    in bit 31, cap a power of two sized from host-known bounds at a load
    of at most 1/2: `bound` (host) bounds the keys held, and an entry
    that could pass the load first grows the table (a rehash on the
    card), so nothing is read back. The plain versions' table (`plain`
    True, the default elsewhere): the keys held, sorted (`keys` int32),
    and their `signs`. Either way `count` int32 [3] holds the points the
    last pass evaluated (the keys it added), the keys held, and inserts a
    full table refused (0)."""

    def __init__(self, inserts: int, device, *, plain: bool | None = None):
        dev = torch.device(device)
        self.plain = dev.type != "cuda" if plain is None else bool(plain)
        self.count = torch.zeros(3, dtype=torch.int32, device=dev)
        self.bound = 0
        if self.plain:
            self.keys = torch.empty(0, dtype=torch.int32, device=dev)
            self.signs = torch.empty(0, dtype=torch.bool, device=dev)
        else:
            self.slots = torch.full((_table_cap(inserts),), -1,
                                    dtype=torch.int32, device=dev)

    @property
    def device(self):
        return self.count.device

    def reserve(self, kern: TableKernel, inserts: int):
        """Room for `inserts` more keys: the kernels' table grows into
        `_table_cap` of its new bound where that would pass a load of
        1/2 (`table_grow`: every entry rehashed on the card)."""
        self.bound += int(inserts)
        if self.plain or 2 * self.bound <= self.slots.numel():
            return
        old = self.slots
        self.slots = torch.full((_table_cap(self.bound),), -1,
                                dtype=torch.int32, device=old.device)
        lib = _load(kern.unit())
        err = lib.fidget_unrolled_table_grow_launch(
            old.data_ptr(), old.numel(), self.slots.data_ptr(),
            self.slots.numel(), self.count.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA launch of table_grow failed with "
                               f"error {err}")
        cuda.LAUNCHES["table_grow"] += 1

    def entries(self):
        """(keys int32, signs bool): the keys held, sorted, and their
        signs."""
        if self.plain:
            return self.keys, self.signs
        e = self.slots[self.slots != -1]
        keys, order = torch.sort(e & 0x7FFFFFFF)
        return keys, (e < 0)[order]

    def clone(self) -> "SignTable":
        t = object.__new__(SignTable)
        t.__dict__.update({k: v.clone() if isinstance(v, torch.Tensor)
                           else v for k, v in self.__dict__.items()})
        return t


def _record(table: SignTable, keys, signs):
    """The plain versions' insert: the keys (with their signs) that the
    table lacks, added; count[0] = how many (the points a kernel pass
    evaluates), count[1] = the keys held."""
    u, inv = torch.unique(keys.reshape(-1), return_inverse=True)
    us = torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    us[inv] = signs.reshape(-1)  # one key, one point, one sign
    new = ~torch.isin(u, table.keys)
    keys_all = torch.cat([table.keys, u[new].to(torch.int32)])
    signs_all = torch.cat([table.signs, us[new]])
    table.keys, order = torch.sort(keys_all)
    table.signs = signs_all[order]
    table.count[0] = new.sum()
    table.count[1] = table.keys.numel()


def _table_args(kern, table, mat, params):
    if not isinstance(kern, TableKernel):
        raise ValueError("the sign table's entries take a TableKernel")
    if mat.shape != (3, 4) or params.shape != (kern.V,):
        raise ValueError(f"mat must be [3, 4] and params [{kern.V}]")


def _plain_table(table):
    if not table.plain:
        raise ValueError("the plain versions fill a plain table")


def _launch_table(kern, name, table, inserts, *args):
    """Launches `name`'s entry of the table unit: the entry's own
    arguments, the table's slots, a list for `inserts` keys and the
    counts, then the output `args[-1]`."""
    if table.plain:
        raise ValueError("the kernels fill a table of slots (plain=False)")
    fn = getattr(_load(kern.unit()), f"fidget_unrolled_{name}_launch")
    lst = torch.empty(max(1, inserts), dtype=torch.int32,
                      device=table.device)
    err = fn(*args[:-1], table.slots.data_ptr(), table.slots.numel(),
             lst.data_ptr(), table.count.data_ptr(), args[-1],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {err}")
    cuda.LAUNCHES[name] += 1


def _pack(x, y, z):
    return (x * LATTICE_KS + y) * LATTICE_KS + z


def leaf_points(keys, h: float, mat):
    """The 8 corners of each leaf cell of `keys` (int32 [cl] packed
    lattice keys), corner c at offset (c & 1, c >> 1 & 1, c >> 2 & 1):
    (their packed keys int32 [8, cl], their model points (x, y, z) [8,
    cl] at world (k + o) h - 1 through `mat`), every (corner, cell) pair
    as mesh/fused.py's leaf core formed them before the sign table."""
    off = torch.tensor([[(c >> a) & 1 for a in range(3)] for c in range(8)],
                       dtype=torch.int32, device=keys.device)
    pts = [c[None, :] + off[:, a, None] for a, c in enumerate(_lattice(keys))]
    world = (p.to(torch.float32) * h - 1.0 for p in pts)
    return _pack(*pts), _model_pts(mat, *world)


def lattice_points(pb3, ps: int, h: float, mat):
    """The 27 lattice points pb3[:, j] + (x, y, z) * ps / 2 of each
    candidate parent (mesh/collapse.py's `_LATTICE`; pb3 int32 [3, kcap]
    on the fine lattice): (their packed keys int32 [27, kcap], their
    model points (x, y, z) [27, kcap] through `mat`), as mesh/fused.py's
    collapse round formed them before the sign table."""
    from ..mesh.collapse import _LATTICE

    lat = torch.as_tensor(_LATTICE.astype(np.int32), device=pb3.device)
    half = int(ps) // 2
    pts = [pb3[a][None, :] + lat[:, a, None] * half for a in range(3)]
    world = (p.to(torch.float32) * h - 1.0 for p in pts)
    return _pack(*pts), _model_pts(mat, *world)


def corner_masks(inside):
    """bool [8, n] -> int32 [n]: bit c the sign of row c."""
    bits = torch.arange(8, dtype=torch.int32, device=inside.device)[:, None]
    return (inside.to(torch.int32) << bits).sum(0, dtype=torch.int32)


def topo_test(inside):
    """mesh/collapse.py's `topo_safe` in torch ops on the signs of each
    candidate's 27 lattice points (bool [27, kcap], lattice index first):
    the merged corner mask has one vertex, every edge midpoint carries an
    endpoint's sign, every face midpoint a corner's and no face is
    ambiguous, the centre carries a corner's. Returns bool [kcap]."""
    from ..mesh.collapse import (_CENTER_LAT, _CORNER_LAT, _EDGE_CHECKS,
                                 _FACE_CHECKS)
    from ..mesh.tables import VERT_COUNT

    dev = inside.device
    corner = inside[torch.as_tensor(_CORNER_LAT, device=dev)]  # [8, kcap]
    vc_tab = torch.as_tensor(VERT_COUNT.astype(np.int32), device=dev)
    topo = vc_tab[corner_masks(corner)] == 1
    for mid, a, b in _EDGE_CHECKS:
        topo &= (inside[mid] == inside[a]) | (inside[mid] == inside[b])
    for row in _FACE_CHECKS:
        mid, quad = int(row[0]), row[1:]
        hit = torch.zeros_like(topo)
        for q in quad:
            hit |= inside[mid] == inside[int(q)]
        topo &= hit
        c0, c1, c2, c3 = (inside[int(q)] for q in quad)
        topo &= ~((c0 == c3) & (c1 == c2) & (c0 != c1))
    center_hit = torch.zeros_like(topo)
    for c in range(8):
        center_hit |= inside[int(_CENTER_LAT)] == corner[c]
    return topo & center_hit


def _leaf_args(keys, n_leaf, kern, table, mat, params):
    cl = keys.shape[0]
    if keys.shape != (cl,) or keys.dtype != torch.int32:
        raise ValueError("keys must be int32 [cl]")
    _count_arg(n_leaf, max(cl, 1))
    if n_leaf is None:
        raise ValueError("the leaf cells need their live count")
    _table_args(kern, table, mat, params)
    return cl


def leaf_masks(kern: TableKernel, keys, n_leaf, h: float, mat, params,
               table: SignTable):
    """U1-P's leaf entry (mesh/fused.py's leaf core): the 8-bit corner
    mask of each leaf cell in `keys` (int32 [cl] packed lattice keys, -1
    padding; `n_leaf` int32 [1] the live cells), bit c the sign d < 0 of
    corner c (offset (c & 1, c >> 1 & 1, c >> 2 & 1)) at world (k + o) h -
    1 through the world -> model matrix `mat` [3, 4]; 0 at a dead cell.
    Returns int32 [cl]. On the card each live cell's corners go into the
    sign table, the points it lacked are evaluated once each (count[0]:
    the distinct live corners of a fresh table), and 8 lanes a cell (a
    corner each, a ballot) form the masks from it."""
    cl = _leaf_args(keys, n_leaf, kern, table, mat, params)
    if params.device.type == "cpu":
        return leaf_masks_plain(kern, keys, n_leaf, h, mat, params, table)
    mat = mat.contiguous()
    cuda.check_cuda(keys, n_leaf, mat, params, table.count)
    table.reserve(kern, 8 * cl)
    out = torch.empty(cl, dtype=torch.int32, device=params.device)
    _launch_table(kern, "leaf_masks", table, 8 * cl, keys.data_ptr(),
                  n_leaf.data_ptr(), cl, mat.data_ptr(), params.data_ptr(),
                  float(h), out.data_ptr())
    return out


def leaf_masks_plain(kern: TableKernel, keys, n_leaf, h: float, mat, params,
                     table: SignTable):
    """Plain PyTorch version of `leaf_masks` (same contract): the corners
    of every cell (`leaf_points`), `unrolled_points_plain`'s sign at
    every (corner, cell) pair, the masks; the table records the distinct
    live corners."""
    cl = _leaf_args(keys, n_leaf, kern, table, mat, params)
    _plain_table(table)
    ckeys, pts = leaf_points(keys, h, mat)
    live = (torch.arange(cl, device=keys.device) < n_leaf) & (keys >= 0)
    inside = (_distance(kern, *pts, params) < 0.0) & live[None, :]
    _record(table, ckeys[:, live], inside[:, live])
    return corner_masks(inside)


def _merge_args(pb3, ps, n_cand, kern, table, mat, params):
    kcap = pb3.shape[1] if pb3.dim() == 2 else -1
    if pb3.shape != (3, kcap) or pb3.dtype != torch.int32:
        raise ValueError("pb3 must be int32 [3, kcap]")
    if not 0 <= int(n_cand) <= kcap or int(ps) < 2 or int(ps) % 2:
        raise ValueError("0 <= n_cand <= kcap and an even ps expected")
    _table_args(kern, table, mat, params)
    return kcap


def merge_topo(kern: TableKernel, pb3, ps: int, n_cand: int, h: float, mat,
               params, table: SignTable):
    """U1-P's merge entry (mesh/fused.py's collapse round): the topology
    test of mesh/collapse.py's `topo_safe` for each candidate parent of
    size `ps` whose lo corner is pb3[:, j] (int32 [3, kcap], fine lattice),
    on the signs of its 27 lattice points pb3[:, j] + (x, y, z) * ps / 2
    (`_LATTICE`); the first `n_cand` candidates are live. Returns bool
    [kcap], False where dead. On the card each live candidate's points go
    into the sign table, only the points it lacked are evaluated
    (count[0]), and a thread a candidate forms its 27-bit inside word from
    the table and tests it."""
    kcap = _merge_args(pb3, ps, n_cand, kern, table, mat, params)
    if params.device.type == "cpu":
        return merge_topo_plain(kern, pb3, ps, n_cand, h, mat, params, table)
    mat = mat.contiguous()
    pb3 = pb3.contiguous()
    cuda.check_cuda(pb3, mat, params, table.count)
    table.reserve(kern, 27 * int(n_cand))
    topo = torch.empty(kcap, dtype=torch.bool, device=params.device)
    _launch_table(kern, "merge_topo", table, 27 * int(n_cand),
                  pb3.data_ptr(), kcap, int(n_cand), int(ps) // 2,
                  mat.data_ptr(), params.data_ptr(), float(h),
                  topo.data_ptr())
    return topo


def merge_topo_plain(kern: TableKernel, pb3, ps: int, n_cand: int, h: float,
                     mat, params, table: SignTable):
    """Plain PyTorch version of `merge_topo` (same contract): the [27,
    kcap] lattice (`lattice_points`), `unrolled_points_plain`'s signs
    there and `topo_test`; the table records the distinct points of the
    live candidates."""
    kcap = _merge_args(pb3, ps, n_cand, kern, table, mat, params)
    _plain_table(table)
    keys, pts = lattice_points(pb3, ps, h, mat)
    inside = _distance(kern, *pts, params) < 0.0
    live = torch.arange(kcap, device=pb3.device) < int(n_cand)
    _record(table, keys[:, live], inside[:, live])
    return topo_test(inside) & live
