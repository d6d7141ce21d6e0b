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

The emitter writes one statement per tape row on local variables, one
per tape register and memory slot, calling `ops.cuh`'s `f_*` / `i_*`
with constant opcodes. Each float program, and each chunk of
INTERVAL_CHUNK_ROWS rows of an interval kernel's body, is a device
function in a translation unit of its own, linked into its kernel with
-rdc, so the units of a frame compile in parallel.
Builds use `cuda.NVCC_FLAGS` (without -shared for the objects) and go
to `fidget_tpu_torch/_build/unrolled-<hash>/`, keyed by a hash of the
emitter, the template, `ops.cuh`, the flags, the tape fields and the
variant, so a second frame or a second process rebuilds nothing. A
failed build or launch raises; nothing falls back to the plain versions
on a CUDA tensor.

`unrolled_float` / `unrolled_interval` dispatch on the device of their
tensors: on the CPU they run `unrolled_float_plain` /
`unrolled_interval_plain` (eval/unrolled_fast.py's evaluators), which
take tensors on any device, so the kernels can be held against them on
the card. `cuda.LAUNCHES` counts both kernels under their own names.
"""

from __future__ import annotations

import ctypes
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
from . import cuda
from .arith import IntervalMode
from .unrolled_fast import eval_tape_float_fast, eval_tape_interval_fast

TEMPLATE = cuda.CSRC / "unrolled.cuh"
#: the files every generated build depends on besides its own source
SOURCES = (pathlib.Path(__file__).resolve(), TEMPLATE, cuda.CSRC / "ops.cuh")
EPILOGUES = {"proofs": 0, "capture": 1, "violation": 2}
#: tape rows per chunk of U2's body, each chunk one translation unit: the
#: interval code of a row is tens of instructions, and a 7,203-row tape
#: in one unit took 39-47 s of nvcc (`probe_kernels.py --unrolled-builds`)
INTERVAL_CHUNK_ROWS = 1024
#: params layout of both kernels: mat [4, 4], z, then the V input values
PARAM_VARS = 17

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
    rows = tape.rows()
    for op, out, a, b, imm, aux in rows:
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
            yield f"r{out} = nmin({A}, {B});"
        elif op == TapeOp.MAX:
            yield f"r{out} = nmax({A}, {B});"
        elif op == TapeOp.AND:
            yield f"r{out} = ({A} == 0.f) ? {A} : {B};"
        elif op == TapeOp.OR:
            yield f"r{out} = ({A} != 0.f) ? {A} : {B};"
        elif op in _BINARY:
            yield f"r{out} = f_binary(OP_{name}, {A}, {B});"
        elif op in _UNARY:
            yield f"r{out} = f_unary(OP_{name}, r{a});"
        else:
            raise ValueError(f"cannot emit op {op}")


def _interval_rows(tape: Tape):
    """One statement per tape row, interval mode
    (eval_tape_interval_fast), choices through U_CHOICE / U_WORD."""
    j = 0
    for op, out, a, b, imm, aux in tape.rows():
        op = int(op)
        L = _lit(imm)
        A = f"Ival{{{L}, {L}}}" if a == IMM else f"r{a}"
        B = f"Ival{{{L}, {L}}}" if b == IMM else f"r{b}"
        name = TapeOp(op).name
        if op in _CHOICE:
            if op == TapeOp.MIN:
                call = f"u_min({A}, {B}, c)"
            elif op == TapeOp.MAX:
                call = f"u_max({A}, {B}, c)"
            else:
                call = f"i_choice(OP_{name}, {A}, {B}, &c)"
            s = f"{{ int c; r{out} = {call}; U_CHOICE({2 * (j % 16)}, c); }}"
            if j % 16 == 15 or j == tape.choice_count - 1:
                s += f" U_WORD({j // 16});"
            j += 1
            yield s
        elif op == TapeOp.DIV:
            if b != IMM:
                yield f"r{out} = u_div({A}, {B});"
            elif float(imm) != 0.0:
                yield f"r{out} = u_div_corners({A}, {B});"
            else:
                yield f"r{out} = Ival{{f_nan(), f_nan()}};"
        elif op == TapeOp.INPUT:
            yield f"r{out} = in[{aux}];"
        elif op == TapeOp.OUTPUT:
            yield f"o_ = r{out};" if aux == 0 else f"/* OUTPUT[{aux}] */;"
        elif op == TapeOp.COPY:
            yield f"r{out} = {A};"
        elif op == TapeOp.LOAD:
            yield f"r{out} = m{aux};"
        elif op == TapeOp.STORE:
            yield f"m{aux} = r{out};"
        elif op in _BINARY:
            yield f"r{out} = i_binary(OP_{name}, {A}, {B});"
        elif op in _UNARY:
            yield f"r{out} = i_unary(OP_{name}, r{a});"
        else:
            raise ValueError(f"cannot emit op {op}")
    if j != tape.choice_count:
        raise ValueError("tape.choice_count does not match its choice ops")


def _axis_defines(V: int, axis_of: dict) -> str:
    ax = [axis_of.get(k, -1) for k in ("x", "y", "z")]
    return (f"#define U_V {V}\n#define U_AX {ax[0]}\n#define U_AY {ax[1]}\n"
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


def emit_float_program(tape: Tape, V: int, name: str) -> str:
    """A float program: `float name(float i0, ..., float i{V-1})`."""
    args = ", ".join(f"float i{k}" for k in range(V))
    body = "".join(f"  {s}\n" for s in _float_rows(tape))
    return (
        '#include "unrolled.cuh"\nusing namespace fidget;\n'
        f'extern "C" __device__ __noinline__ float {name}({args}) {{\n'
        f"{_decls(tape)}  float o = 0.f;\n{body}  return o;\n}}\n"
    )


def emit_float_kernel(names: list, V: int, axis_of: dict) -> str:
    """U1's kernel unit: the dispatch of segment s to program names[s]
    (the last segment and beyond: the last program)."""
    args = ", ".join("float" for _ in range(V))
    call = ", ".join(f"in[{k}]" for k in range(V))
    decls = "".join(f'extern "C" __device__ float {n}({args});\n'
                    for n in dict.fromkeys(names))
    cases = "".join(f"    case {s}: return {n}({call});\n"
                    for s, n in enumerate(names[:-1]))
    return (
        f'{_axis_defines(V, axis_of)}#include "unrolled.cuh"\n{decls}'
        "static __device__ __forceinline__ float u_run(int s, const float* in) "
        "{\n  switch (s) {\n"
        f"{cases}    default: return {names[-1]}({call});\n  }}\n}}\n"
        "U_FLOAT_KERNEL\n"
    )


def _interval_defines(tape: Tape, V: int, axis_of: dict,
                      epilogue: str) -> str:
    return (f"#define U_EPI {EPILOGUES[epilogue]}\n"
            f"{_axis_defines(V, axis_of)}#define U_NR {max(tape.reg_count, 1)}"
            f"\n#define U_NM {tape.mem_count}\n")


def interval_chunks(tape: Tape) -> list:
    """U2's body, one statement per tape row, cut into chunks of
    INTERVAL_CHUNK_ROWS rows."""
    rows = list(_interval_rows(tape))
    k = INTERVAL_CHUNK_ROWS
    return [rows[i:i + k] for i in range(0, len(rows), k)] or [[]]


def emit_interval_chunk(tape: Tape, V: int, axis_of: dict, epilogue: str,
                        rows: list, name: str) -> str:
    """One chunk of U2's body: a device function that takes the thread's
    state (registers, memory slots, inputs, output, packed word,
    violation flag) into locals, runs its rows and stores it back."""
    regs = [f"r{i}" for i in range(max(tape.reg_count, 1))]
    mems = [f"m{i}" for i in range(tape.mem_count)]
    load = "".join(f"  Ival {v} = s_->{v[0]}[{v[1:]}];\n" for v in regs + mems)
    store = "".join(f"  s_->{v[0]}[{v[1:]}] = {v};\n" for v in regs + mems)
    body = "".join(f"  {r}\n" for r in rows)
    return (
        f"{_interval_defines(tape, V, axis_of, epilogue)}"
        f'#include "unrolled.cuh"\nU_CHUNK_BEGIN({name})\n{load}{body}'
        f"{store}U_CHUNK_END\n"
    )


def emit_interval_kernel(tape: Tape, V: int, axis_of: dict, epilogue: str,
                         names: list) -> str:
    """U2's kernel unit: the chunks `names` called in order."""
    decls = "".join(f'extern "C" __device__ void {n}(U_CHUNK_ARGS);\n'
                    for n in names)
    calls = "".join(f"  {n}(s, u, words, n, lane);\n" for n in names)
    return (
        f"{_interval_defines(tape, V, axis_of, epilogue)}"
        f'#include "unrolled.cuh"\n{decls}'
        "static __device__ __forceinline__ void u_chunks(fidget::UState* s, "
        "const int32_t* u, int32_t* words, int n, int lane) {\n"
        f"{calls}}}\nU_INTERVAL_KERNEL\n"
    )


# ======================================================================
# building


class _Unit:
    """One generated build product: a library (`lib.so`) linked from the
    kernel's unit and the objects it calls (float programs or interval
    chunks)."""

    def __init__(self, key, source, objects):
        self.key = key
        self.source = source
        self.objects = list(objects)  # _Object
        self.dir = cuda.BUILD_ROOT / f"unrolled-{key}"
        self.lib = self.dir / "lib.so"


class _Object:
    """A float program or an interval chunk, compiled into a relocatable
    object."""

    def __init__(self, key, source):
        self.key = key
        self.source = source
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
    missing object (the programs or chunks, and each unit's kernel
    source) with one `nvcc -rdc=true -c` each, all started together,
    then the links, together. Returns {step: seconds since its batch
    began, when it was seen done} of the steps that ran; raises with
    nvcc's output if any fails. `<name>.log` beside each product keeps
    nvcc's output (registers, spills)."""
    nvcc = cuda._nvcc()
    flags = [f for f in cuda.NVCC_FLAGS if f != "-shared"]
    compile_ = [nvcc, *flags, "-rdc=true", "-I", str(cuda.CSRC), "-c"]
    todo = [u for u in units if not u.lib.exists()]
    objs = {o.key: o for u in todo for o in u.objects if not o.obj.exists()}
    steps = [
        (o.key, [*compile_, str(_write_source(o.dir, "prog.cu", o.source))],
         o.obj, o.dir / "prog.log")
        for o in objs.values()
    ] + [
        (u.key, [*compile_, str(_write_source(u.dir, "kernel.cu", u.source))],
         u.dir / "kernel.o", u.dir / "kernel.log")
        for u in todo
    ]
    seconds = {}
    _run(steps, seconds)
    links = [
        (u.key + ":link",
         [nvcc, *cuda.NVCC_FLAGS, "-rdc=true", str(u.dir / "kernel.o"),
          *(str(o.obj) for o in {o.key: o for o in u.objects}.values())],
         u.lib, u.dir / "link.log")
        for u in todo
    ]
    _run(links, seconds)
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
    for label, tmp, final, log, proc in procs:
        rc = proc.wait()
        seconds[label] = time.perf_counter() - t0
        if rc != 0:
            failed.append((label, log))
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, final)
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
    # x0 y0 params | T0 | u rin rout words viol | n | stream
    "fidget_unrolled_interval_launch": [_P] * 3 + [_F] + [_P] * 5 + [_I, _P],
}


def _load(unit: _Unit) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(unit.key)
        if lib is None:
            if not unit.lib.exists():
                build([unit])
            lib = ctypes.CDLL(str(unit.lib))
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
    segment's first on."""

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

    def unit(self) -> _Unit:
        if self._unit is None:
            objects, names = [], []
            for t in self.tapes:
                key = cache_key("float-program", self.V, _tape_digest(t))
                name = f"fidget_uprog_{key}"
                objects.append(
                    _Object(key, emit_float_program(t, self.V, name))
                )
                names.append(name)
            source = emit_float_kernel(names, self.V, self.axis_of)
            key = cache_key("float-kernel", source)
            self._unit = _Unit(key, source, objects)
        return self._unit


class IntervalKernel:
    """U2 for one tape and one epilogue ("proofs", "capture",
    "violation")."""

    def __init__(self, tape: Tape, axis_of: dict, V: int, epilogue: str):
        if epilogue not in EPILOGUES:
            raise ValueError(f"unknown epilogue {epilogue!r}")
        self.tape = tape
        self.axis_of = dict(axis_of)
        self.V = V
        self.epilogue = epilogue
        self._unit = None

    @property
    def cw(self) -> int:
        return -(-self.tape.choice_count // 16)

    def unit(self) -> _Unit:
        if self._unit is None:
            args = (self.tape, self.V, self.axis_of, self.epilogue)
            objects, names = [], []
            for rows in interval_chunks(self.tape):
                key = cache_key("interval-chunk", _tape_digest(self.tape),
                                emit_interval_chunk(*args, rows, "@"))
                name = f"fidget_uiv_{key}"
                objects.append(
                    _Object(key, emit_interval_chunk(*args, rows, name))
                )
                names.append(name)
            source = emit_interval_kernel(*args, names)
            key = cache_key("interval-kernel", source)
            self._unit = _Unit(key, source, objects)
        return self._unit


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
    words = viol = None
    if kern.epilogue == "capture":
        words = torch.empty((kern.cw, n), dtype=torch.int32, device=dev)
    if violation:
        cuda.check_cuda(u)
        viol = torch.empty(n, dtype=torch.bool, device=dev)
    lib = _load(kern.unit())
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    err = lib.fidget_unrolled_interval_launch(
        x0.data_ptr(), y0.data_ptr(), params.data_ptr(), float(T0),
        ptr(u if violation else None), rin.data_ptr(), rout.data_ptr(),
        ptr(words), ptr(viol), n, stream,
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
