"""Native host code, bound with `ctypes`.

`tape_compiler.cpp` is the `.vm` tape compiler (`fidget_compile_vm`):
it parses the flat `.vm` format and lowers it to a register tape with
the same linear-scan allocation as `compiler/lower.py`. `mesh_kernels.cpp`
holds the mesher's batched QEF solve (`fidget_qef_solve`) and the
per-vertex QEF accumulation (`fidget_qef_accumulate`), host float64
code. Both have a plain C interface. `g++` builds each at first use
into `fidget_tpu_torch/_build/native-<hash>/`, keyed by a hash of the
source, as `eval/cuda.py` builds the CUDA kernels. A failed build
raises: there is no Python or numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from ..compiler.tape import Tape
from ..core.var import Var, VarMap

_HERE = pathlib.Path(__file__).resolve().parent
_BUILD_ROOT = _HERE.parent / "_build"
_LOCK = threading.Lock()
_LIBS: dict = {}

_PD = ctypes.POINTER(ctypes.c_double)
_PI = ctypes.POINTER(ctypes.c_int32)


class _FidgetTape(ctypes.Structure):
    _fields_ = [
        ("n_ops", ctypes.c_int32),
        ("reg_count", ctypes.c_int32),
        ("mem_count", ctypes.c_int32),
        ("choice_count", ctypes.c_int32),
        ("n_inputs", ctypes.c_int32),
        ("axis_input", ctypes.c_int32 * 3),
        ("op", _PI),
        ("out", _PI),
        ("a", _PI),
        ("b", _PI),
        ("imm", ctypes.POINTER(ctypes.c_float)),
        ("aux", _PI),
        ("error", ctypes.c_char * 256),
    ]


def _bind_mesh(lib):
    lib.fidget_qef_solve.restype = None
    lib.fidget_qef_solve.argtypes = [ctypes.c_int64, _PD, _PD, _PD, _PD]
    lib.fidget_qef_accumulate.restype = None
    lib.fidget_qef_accumulate.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), _PD, _PD,
        ctypes.POINTER(ctypes.c_uint8), _PD,
    ]


def _bind_tape(lib):
    lib.fidget_compile_vm.restype = ctypes.POINTER(_FidgetTape)
    lib.fidget_compile_vm.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fidget_free_tape.restype = None
    lib.fidget_free_tape.argtypes = [ctypes.POINTER(_FidgetTape)]


#: source stem -> (g++ flags, ctypes binder)
_SOURCES = {
    "mesh_kernels": (["-O3", "-shared", "-fPIC", "-std=c++17"], _bind_mesh),
    "tape_compiler": (["-O2", "-shared", "-fPIC", "-std=c++17"], _bind_tape),
}


def _build(stem: str) -> pathlib.Path:
    """The shared library of `<stem>.cpp`, built with g++ if missing."""
    flags, _ = _SOURCES[stem]
    src = _HERE / f"{stem}.cpp"
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = _BUILD_ROOT / f"native-{tag.hexdigest()[:16]}" / f"lib{stem}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {src.name} cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [gxx, *flags, str(src), "-o", str(tmp)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {src.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _lib(stem: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(_build(stem)))
            _SOURCES[stem][1](lib)
            _LIBS[stem] = lib
        return lib


def available() -> bool:
    """Builds (if needed) and loads the tape compiler, and returns True;
    a failed build raises, as every entry point here does."""
    _lib("tape_compiler")
    return True


def compile_vm(text: str, reg_limit: int = 255) -> Tape:
    """Compiles `.vm` text to a register `Tape` natively.

    Raises ValueError on malformed input (the contract of
    `Context.from_text` + `lower`), and RuntimeError when the compiler
    cannot be built."""
    lib = _lib("tape_compiler")
    ptr = lib.fidget_compile_vm(text.encode(), reg_limit)
    try:
        t = ptr.contents
        err = bytes(t.error).split(b"\0")[0]
        if err:
            raise ValueError(err.decode())
        n = t.n_ops
        arrays = {}
        for name, dtype in [
            ("op", np.int32), ("out", np.int32), ("a", np.int32),
            ("b", np.int32), ("imm", np.float32), ("aux", np.int32),
        ]:
            src = np.ctypeslib.as_array(getattr(t, name), shape=(n,))
            arrays[name] = np.array(src, dtype=dtype)  # owned copy
        var_map = VarMap()
        order = sorted(
            (int(t.axis_input[k]), k) for k in range(3) if t.axis_input[k] >= 0
        )
        for _, k in order:
            var_map.insert((Var.X, Var.Y, Var.Z)[k])
        return Tape(
            arrays["op"], arrays["out"], arrays["a"], arrays["b"],
            arrays["imm"], arrays["aux"],
            reg_count=int(t.reg_count), mem_count=int(t.mem_count),
            choice_count=int(t.choice_count), output_count=1,
            var_map=var_map,
        )
    finally:
        lib.fidget_free_tape(ptr)


def qef_solve_batch(AtA, Atb, mass):
    """Batched truncated QEF solve about the mass point: [n, 3, 3],
    [n, 3], [n, 3] float64 -> [n, 3] float64 (the mass point where the
    solution is not finite)."""
    lib = _lib("mesh_kernels")
    AtA = np.ascontiguousarray(AtA, np.float64)
    Atb = np.ascontiguousarray(Atb, np.float64)
    mass = np.ascontiguousarray(mass, np.float64)
    n = len(mass)
    out = np.empty((n, 3), np.float64)
    lib.fidget_qef_solve(
        ctypes.c_int64(n), AtA.ctypes.data_as(_PD), Atb.ctypes.data_as(_PD),
        mass.ctypes.data_as(_PD), out.ctypes.data_as(_PD),
    )
    return out


def qef_accumulate_batch(vid, pt, nm, w, NV):
    """Per-vertex QEF accumulation: vid [E] int64, pt/nm [E, 3] float64,
    w [E] bool -> [NV, 14] float64 with columns (mass-point sum xyz,
    count, AtA 00/01/02/11/12/22, Atb xyz, btb)."""
    lib = _lib("mesh_kernels")
    vid = np.ascontiguousarray(vid, np.int64)
    pt = np.ascontiguousarray(pt, np.float64)
    nm = np.ascontiguousarray(nm, np.float64)
    w = np.ascontiguousarray(w, np.uint8)
    out = np.empty((NV, 14), np.float64)
    lib.fidget_qef_accumulate(
        ctypes.c_int64(len(vid)), ctypes.c_int64(NV),
        vid.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        pt.ctypes.data_as(_PD), nm.ctypes.data_as(_PD),
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(_PD),
    )
    return out
