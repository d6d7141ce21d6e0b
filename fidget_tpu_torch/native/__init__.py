"""Native host kernels of the mesher, bound with `ctypes`.

`mesh_kernels.cpp` holds the batched QEF solve (`fidget_qef_solve`)
and the per-vertex QEF accumulation (`fidget_qef_accumulate`), host
float64 code with a plain C interface. `g++` builds it at first use
into `fidget_tpu_torch/_build/native-<hash>/`, keyed by a hash of the
source, as `eval/cuda.py` builds the CUDA kernels. A failed build
raises: there is no numpy fallback.
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

_SRC = pathlib.Path(__file__).with_name("mesh_kernels.cpp")
_BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIB = None

_PD = ctypes.POINTER(ctypes.c_double)


def _build() -> pathlib.Path:
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    out = _BUILD_ROOT / f"native-{tag.hexdigest()[:16]}" / "libmesh_kernels.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the mesh's QEF kernels cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [gxx, *_FLAGS, str(_SRC), "-o", str(tmp)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {_SRC.name}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build()))
            lib.fidget_qef_solve.restype = None
            lib.fidget_qef_solve.argtypes = [ctypes.c_int64, _PD, _PD, _PD, _PD]
            lib.fidget_qef_accumulate.restype = None
            lib.fidget_qef_accumulate.argtypes = [
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64), _PD, _PD,
                ctypes.POINTER(ctypes.c_uint8), _PD,
            ]
            _LIB = lib
        return _LIB


def qef_solve_batch(AtA, Atb, mass):
    """Batched truncated QEF solve about the mass point: [n, 3, 3],
    [n, 3], [n, 3] float64 -> [n, 3] float64 (the mass point where the
    solution is not finite)."""
    lib = _lib()
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
    lib = _lib()
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
