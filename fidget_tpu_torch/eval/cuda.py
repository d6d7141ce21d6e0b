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
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"

#: threads per block of every kernel; must match BLOCK in csrc/ops.cuh
BLOCK = 128
#: shared-memory budget of a register file of K2, K4, K5 and K6 (several
#: blocks an SM); above it their wrappers hand the kernel a global scratch
SMEM_LIMIT = 96 * 1024
#: dynamic shared memory one block may opt in to on an H100, the shared
#: memory of one SM, and what the card reserves of it per block
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_BLOCK_RESERVED = 1024
N_SM = 132
#: tape rows per ring buffer of K1 and K3 (csrc/ops.cuh `TapeRing`)
TAPE_CHUNK = 256


def tape_ring_bytes(chunk: int) -> int:
    """Shared memory of one block's tape ring: two buffers of `chunk` + 1
    decoded rows (16 bytes and a 4-byte immediate each) and the raw
    words of one chunk, rounded up to 16 bytes (csrc/ops.cuh
    `tape_ring_bytes`)."""
    return -(-((chunk + 1) * 2 * 20 + chunk * 12) // 16) * 16


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one launch of K1 or K3 is laid out.

    r: lanes a thread owns (K3: 4, 2 or 1; K1: 1).
    chunk: tape rows per ring buffer.
    smem: bytes of dynamic shared memory of a block.
    regs_shared: the register file lies in shared memory; else the
      wrapper allocates a global scratch.
    choices_shared: K1's choice words accumulate in shared memory; else
      the wrapper hands the kernel zeroed device memory to OR into.
    blocks: blocks of the grid."""

    r: int
    chunk: int
    smem: int
    regs_shared: bool
    choices_shared: bool
    blocks: int


@functools.lru_cache(maxsize=None)
def launch_geometry(kernel: str, *, nf: int, lanes: int, T: int,
                    cw: int = 0) -> Geometry:
    """The launch geometry of `interp_float` (K3) or `interp_interval`
    (K1) for T instances of `lanes` lanes, an `nf`-register file and
    `cw` choice words a lane. Everything stays in shared memory as long
    as one block's 227 KB hold it.

    K3 takes the most lanes a thread (4, 2, 1) that divide the lanes
    into whole blocks and whose register file `[nf][BLOCK * r]` leaves
    room for two blocks an SM, or for one where the grid has no more
    blocks than the card has SMs; failing that the most that fit one
    block; and the global scratch only when not even one lane a thread
    fits. K1 keeps one lane a thread (its passes are short of lanes, not
    of scheduler slots); its register file `[nf][BLOCK]` of (lo, hi) pairs
    goes to shared memory if it fits beside the ring, and its choice
    words `[cw][BLOCK]` if they fit beside that."""
    if lanes <= 0 or lanes % BLOCK:
        raise ValueError(f"lanes must be a positive multiple of {BLOCK}")
    chunk = TAPE_CHUNK
    ring = tape_ring_bytes(chunk)
    if kernel == "interp_interval":
        blocks = T * (lanes // BLOCK)
        smem = ring
        regs_shared = smem + nf * BLOCK * 8 <= SMEM_BLOCK_MAX
        if regs_shared:
            smem += nf * BLOCK * 8
        choices_shared = smem + cw * BLOCK * 4 <= SMEM_BLOCK_MAX
        if choices_shared:
            smem += cw * BLOCK * 4
        return Geometry(1, chunk, smem, regs_shared, choices_shared, blocks)
    if kernel != "interp_float":
        raise ValueError(f"no launch geometry for {kernel}")
    rs = [r for r in (4, 2, 1) if lanes % (BLOCK * r) == 0]
    two_an_sm = SMEM_SM // 2 - SMEM_BLOCK_RESERVED
    for roomy in (True, False):
        for r in rs:
            blocks = T * (lanes // (BLOCK * r))
            smem = ring + nf * BLOCK * r * 4
            budget = SMEM_BLOCK_MAX
            if roomy and blocks > N_SM:
                budget = two_an_sm
            if smem <= budget:
                return Geometry(r, chunk, smem, True, False, blocks)
    r = rs[0]
    return Geometry(r, chunk, ring, False, False, T * (lanes // (BLOCK * r)))


#: kernel name -> (source stem, C entry point)
KERNELS = {
    "interp_interval": ("interp_interval", "fidget_interp_interval"),
    "liveness_codes": ("liveness", "fidget_liveness_codes"),
    "interp_float": ("interp_float", "fidget_interp_float"),
    "interp_grad": ("interp_grad", "fidget_interp_grad"),
    "interp_voxel_depth": ("interp_voxel_depth", "fidget_interp_voxel_depth"),
    "interp_float_coded": ("interp_float_coded", "fidget_interp_float_coded"),
}

#: launches per kernel name since the last `reset_launches()`
LAUNCHES = {name: 0 for name in KERNELS}

NVCC_FLAGS = [
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # w1 w2 imm lengths vars out scratch order | T L nf V O lanes r chunk
    # smem | stream
    "fidget_interp_float": [_P] * 8 + [_I] * 9 + [_P],
    # w1 w2 imm lengths lo hi olo ohi choices scratch order | T L nf V O CW
    # lanes chunk choices_shared smem
    "fidget_interp_interval": [_P] * 11 + [_I] * 10 + [_P],
    # w1s w2s lengths choices codes scratch order | B Tt L nf CW lanes
    "fidget_liveness_codes": [_P] * 7 + [_I] * 6 + [_P],
    # w1 w2 imm lengths vars out scratch | T L nf V O lanes
    "fidget_interp_grad": [_P] * 7 + [_I] * 6 + [_P],
    # w1 w2 imm lengths vars out scratch | T L nf V sub pp_out
    "fidget_interp_voxel_depth": [_P] * 7 + [_I] * 6 + [_P],
    # w1 w2 imm lengths codes vars out scratch | T L LW nf V O lanes
    "fidget_interp_float_coded": [_P] * 8 + [_I] * 7 + [_P],
}

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
_ORDER_TABLES: dict[tuple, torch.Tensor] = {}


def resolve_device(device) -> torch.device:
    """The device of an entry point: CUDA unless the caller names
    another. With no card and no explicit device this raises; it never
    falls back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to render on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def order_table(op_order, device) -> torch.Tensor | None:
    """The kernels' position -> canonical opcode table for an arena
    packed under `op_order` (compiler/pack.py), as an int32 tensor on
    `device`, made once per (order, device); None for the canonical
    order."""
    if op_order is None:
        return None
    key = (tuple(int(o) for o in op_order), str(device))
    table = _ORDER_TABLES.get(key)
    if table is None:
        table = torch.tensor(key[0], dtype=torch.int32, device=device)
        _ORDER_TABLES[key] = table
    return table


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
