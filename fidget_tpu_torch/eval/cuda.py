"""Build, load and launch the CUDA kernels of `fidget_tpu_torch/csrc`.

Each `.cu` source compiles with `nvcc` into a shared library with a
plain C interface, bound with `ctypes` (no PyTorch headers, so a build
takes seconds). Libraries go to `fidget_tpu_torch/_build/<hash>/`,
keyed by a hash of every source, and are built at first use: all
sources start compiling together, one `nvcc` each. A failed build or
launch raises; nothing falls back to the plain PyTorch versions.

`LAUNCHES` counts kernel launches by kernel name. A wrapper adds one
where it launches its kernel and nowhere else, so a caller can reset
the counts, run a frame, and see which kernels the frame went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"

#: threads per block and the shared-memory budget of a register file;
#: must match BLOCK / SMEM_LIMIT in csrc/ops.cuh
BLOCK = 128
SMEM_LIMIT = 96 * 1024

#: kernel name -> (source stem, C entry point)
KERNELS = {
    "interp_interval": ("interp_interval", "fidget_interp_interval"),
    "liveness_codes": ("liveness", "fidget_liveness_codes"),
    "interp_float": ("interp_float", "fidget_interp_float"),
}

#: launches per kernel name since the last `reset_launches()`
LAUNCHES = {name: 0 for name in KERNELS}

NVCC_FLAGS = [
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # w1 w2 imm lengths vars out scratch | T L nf V O lanes | stream
    "fidget_interp_float": [_P] * 7 + [_I] * 6 + [_P],
    # w1 w2 imm lengths lo hi olo ohi choices scratch | T L nf V O CW lanes
    "fidget_interp_interval": [_P] * 10 + [_I] * 7 + [_P],
    # w1s w2s lengths choices codes scratch | B Tt L nf CW lanes
    "fidget_liveness_codes": [_P] * 6 + [_I] * 6 + [_P],
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build() -> pathlib.Path:
    """Compiles every kernel source that has no library yet, all in
    parallel; returns the build directory. `<stem>.log` beside each
    library keeps nvcc's output (registers, spills, shared memory)."""
    out = build_dir()
    stems = sorted({stem for stem, _ in KERNELS.values()})
    todo = [s for s in stems if not (out / f"lib{s}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for stem in todo:
        tmp = out / f"lib{stem}.so.{os.getpid()}.tmp"
        log = open(out / f"{stem}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs.append((stem, tmp, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for stem, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(stem)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{stem}.so")
    if failed:
        logs = "\n".join(
            (out / f"{s}.log").read_text()[-4000:] for s in failed
        )
        raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return out


def _lib(stem: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build() / f"lib{stem}.so"))
            for fn, argtypes in _ARGTYPES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _LIBS[stem] = lib
        return lib


def launch(name: str, *args) -> None:
    """Launches kernel `name` on the current stream with `args` (tensors
    are passed by device pointer, None as a null pointer) and counts
    the launch. Raises if the launch is refused."""
    stem, fn = KERNELS[name]
    cargs = []
    for a in args:
        if isinstance(a, torch.Tensor):
            cargs.append(a.data_ptr())
        elif a is None:
            cargs.append(None)
        else:
            cargs.append(int(a))
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(_lib(stem), fn)(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"CUDA launch of {name} failed with error {err}")
    LAUNCHES[name] += 1


def check_cuda(*tensors: torch.Tensor) -> None:
    """Raises unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("kernel inputs must be CUDA tensors")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
