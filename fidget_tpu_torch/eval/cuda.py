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
The sources' hash, the builds and the loads are spans of `utils`
(`fidget.kernels.emit`, `.build`, `.load`), and the counters
`kernels.built` (nvcc units compiled) and `kernels.loaded` count them.
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

from ..utils import count, span

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parent.parent / "_build"

#: threads per block of every kernel; must match BLOCK in csrc/ops.cuh
BLOCK = 128
#: dynamic shared memory one block may opt in to on an H100, the shared
#: memory of one SM, and what the card reserves of it per block
SMEM_BLOCK_MAX = 232448
SMEM_SM = 233472
SMEM_BLOCK_RESERVED = 1024
N_SM = 132
#: tape rows per ring buffer of every interpreter kernel (csrc/ops.cuh
#: `TapeRing`, csrc/liveness.cu `LiveRing`); a multiple of 16, the code
#: words of K2 and K6
TAPE_CHUNK = 256
#: tape rows per ring buffer of the two-stream probe P2: at the
#: reference's shapes (nf 32, 4 lanes a thread) its 128-row ring and
#: file let three blocks share an SM where 256 rows let two
#: (probe_kernels.py --interleave on an H100 80GB HBM3 at 700 W: 0.6100
#: against 0.7194 ms)
INTERLEAVE_CHUNK = 128
#: lanes a thread K4 and K5 may take, most first (a dual row of K4
#: moves 1 + tangents planes through shared memory, up to four times
#: K3's bytes; K4 is built for these two alone)
GRAD_LANES = (2, 1)
VOXEL_LANES = (4, 2, 1)
#: passes over its columns a K5 block makes at least: the block stages
#: its tape once for all of them, and more, shorter blocks overlap each
#: other's latencies (probe_kernels.py on the 3D path's heaviest
#: stratum: 2 passes 0.070 ms, 8 passes 0.092)
VOXEL_PASSES = 2


def tape_ring_bytes(chunk: int) -> int:
    """Shared memory of one block's tape ring: two buffers of `chunk` + 1
    decoded rows (16 bytes and a 4-byte immediate each) and the raw
    words of one chunk, rounded up to 16 bytes (csrc/ops.cuh
    `tape_ring_bytes`)."""
    return -(-((chunk + 1) * 2 * 20 + chunk * 12) // 16) * 16


def live_ring_bytes(chunk: int) -> int:
    """Shared memory of one K2 block's ring: two buffers of `chunk`
    decoded rows of 32 bytes and the raw words (w1, w2) of one chunk
    (csrc/liveness.cu `live_ring_bytes`)."""
    return chunk * (2 * 32 + 2 * 4)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """How one launch of an interpreter kernel is laid out.

    r: lanes a thread owns (K3, K5, K6, P2: 4, 2 or 1; K4: GRAD_LANES; K1,
      K2: 1).
    chunk: tape rows per ring buffer.
    smem: bytes of dynamic shared memory of a block.
    regs_shared: the register file (K4: its 1 + tangents files; K2: the
      liveness bits) lies in registers or shared memory; else the
      wrapper allocates a global scratch.
    choices_shared: K1's choice words accumulate in shared memory (else
      the wrapper hands the kernel zeroed device memory to OR into); K2
      reads its choice words from shared memory (else from device
      memory).
    blocks: blocks of the grid.
    mask_words: K2 keeps liveness as a bit mask of this many 32-bit
      registers a lane (1 or 2); 0: as a byte plane `[nf][BLOCK]`.
    cols: K5's subtile columns a block covers over every vz."""

    r: int
    chunk: int
    smem: int
    regs_shared: bool
    choices_shared: bool
    blocks: int
    mask_words: int = 0
    cols: int = 0


@functools.lru_cache(maxsize=None)
def launch_geometry(kernel: str, *, nf: int, lanes: int, T: int,
                    cw: int = 0, sub: int = 0, r: int = 0,
                    tangents: int = 3) -> Geometry:
    """The launch geometry of `interp_float` (K3), `interp_float_coded`
    (K6), `interp_grad` (K4), `interp_voxel_depth` (K5, over sub^3 lanes
    of `sub`^2 columns), `interp_interval` (K1), `liveness_codes` (K2)
    or the two-stream probe `interp_float2` (P2: a block a stream, laid
    out as K3 lays out an instance with an INTERLEAVE_CHUNK-row ring,
    twice the blocks) for T instances of `lanes` lanes, an
    `nf`-register file and `cw` choice words a lane. Everything stays in
    shared memory as long as one block's 227 KB hold it.

    K3, K4, K5, K6 and P2 take the most lanes a thread (K4: of GRAD_LANES;
    K5: of VOXEL_LANES with a column layout, `_voxel_cols`; else 4, 2,
    1) that divide the lanes into whole blocks and whose register file
    (`[nf][BLOCK * r]` floats, K4 one for the value and one for each of
    its `tangents`, 1 to 3; K5 with BLOCK * r ints
    more to fold the slices of a pass) leaves room for two blocks an SM,
    or for one where the grid has no more blocks than the card has SMs;
    failing that the most that fit one block; and the global scratch
    only when not even one lane a thread fits (K6 compacts its executed
    rows into the ring's own buffers, so its shared memory is K3's). K1
    keeps one lane a thread (its passes are short of lanes, not of
    scheduler slots); its register file `[nf][BLOCK]` of (lo, hi) pairs
    goes to shared memory if it fits beside the ring, and its choice
    words `[cw][BLOCK]` if they fit beside that. K2 keeps one lane a
    thread and its liveness in registers, one 32-bit mask word a lane up
    to nf 32 and two up to nf 64; above that a byte plane `[nf][BLOCK]`,
    in shared memory if it fits beside the ring and the choice words,
    which come first. `r` (P2 only) asks for that many lanes a thread,
    so that the probe can compare layouts."""
    if lanes <= 0 or lanes % BLOCK:
        raise ValueError(f"lanes must be a positive multiple of {BLOCK}")
    chunk = TAPE_CHUNK
    if kernel == "liveness_codes":
        blocks = T * (lanes // BLOCK)
        smem = live_ring_bytes(chunk)
        choices_shared = smem + cw * BLOCK * 4 <= SMEM_BLOCK_MAX
        if choices_shared:
            smem += cw * BLOCK * 4
        mask_words = 1 if nf <= 32 else 2 if nf <= 64 else 0
        regs_shared = mask_words > 0 or smem + nf * BLOCK <= SMEM_BLOCK_MAX
        if not mask_words and regs_shared:
            smem += nf * BLOCK
        return Geometry(1, chunk, smem, regs_shared, choices_shared, blocks,
                        mask_words)
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
    planes, cols = 1, (lambda r: 0)
    blocks = lambda r: T * (lanes // (BLOCK * r))
    if kernel in ("interp_float", "interp_float_coded"):
        rs = [r for r in (4, 2, 1) if lanes % (BLOCK * r) == 0]
    elif kernel == "interp_float2":
        chunk = INTERLEAVE_CHUNK
        ring = tape_ring_bytes(chunk)
        rs = [x for x in (4, 2, 1)
              if lanes % (BLOCK * x) == 0 and x == (r or x)]
        if not rs:
            raise ValueError(f"{r} lanes a thread do not divide {lanes}")
        blocks = lambda r: 2 * T * (lanes // (BLOCK * r))
    elif kernel == "interp_grad":
        if not 1 <= tangents <= 3:
            raise ValueError(f"K4 carries 1 to 3 tangents, not {tangents}")
        planes = 1 + tangents
        rs = [r for r in GRAD_LANES if lanes % (BLOCK * r) == 0]
    elif kernel == "interp_voxel_depth":
        if (sub * sub) % BLOCK or lanes != sub**3:
            raise ValueError(f"sub={sub} needs sub^2 % {BLOCK} == 0 and "
                             f"lanes == sub^3")
        cols = functools.partial(_voxel_cols, sub)
        rs = [r for r in VOXEL_LANES if cols(r)]
        blocks = lambda r: T * sub * sub // cols(r)
    else:
        raise ValueError(f"no launch geometry for {kernel}")
    # K5 folds the slices of a pass through BLOCK * r ints
    fold = lambda r: 4 * BLOCK * r if 0 < cols(r) < BLOCK * r else 0
    two_an_sm = SMEM_SM // 2 - SMEM_BLOCK_RESERVED
    for roomy in (True, False):
        for r in rs:
            smem = ring + planes * nf * BLOCK * r * 4 + fold(r)
            budget = SMEM_BLOCK_MAX
            if roomy and blocks(r) > N_SM:
                budget = two_an_sm
            if smem <= budget:
                return Geometry(r, chunk, smem, True, False, blocks(r),
                                cols=cols(r))
    r = rs[0]
    return Geometry(r, chunk, ring + fold(r), False, False, blocks(r),
                    cols=cols(r))


def _voxel_cols(sub: int, r: int) -> int:
    """Columns of a sub^3 subtile one K5 block covers at r lanes a
    thread, over every vz: the fewest that divide the sub^2 columns and
    BLOCK * r, are a whole number of slices of a pass that divides sub,
    and take the block at least VOXEL_PASSES passes; 0 when none do."""
    P, cols = BLOCK * r, sub * sub
    fits = [cb for cb in range(r, min(cols, P) + 1, r)
            if cols % cb == 0 and P % cb == 0 and sub % (P // cb) == 0
            and sub * cb // P >= VOXEL_PASSES]
    return min(fits, default=0)


#: kernel name -> (source stem, C entry point); the kernels generated per
#: tape have no stem of their own and are built and launched by
#: eval/unrolled_cuda.py
KERNELS = {
    "interp_interval": ("interp_interval", "fidget_interp_interval"),
    "liveness_codes": ("liveness", "fidget_liveness_codes"),
    "interp_float": ("interp_float", "fidget_interp_float"),
    "interp_grad": ("interp_grad", "fidget_interp_grad"),
    "interp_voxel_depth": ("interp_voxel_depth", "fidget_interp_voxel_depth"),
    "interp_float_coded": ("interp_float_coded", "fidget_interp_float_coded"),
    "unrolled_float": (None, "fidget_unrolled_float_launch"),
    "unrolled_interval": (None, "fidget_unrolled_interval_launch"),
    "unrolled_voxel_depth": (None, "fidget_unrolled_voxel_depth_launch"),
    "unrolled_interval3": (None, "fidget_unrolled_interval3_launch"),
    "unrolled_voxel_fold": (None, "fidget_unrolled_voxel_fold_launch"),
    "unrolled_proofs3": (None, "fidget_unrolled_interval3_launch"),
    "unrolled_points": (None, "fidget_unrolled_points_launch"),
    "unrolled_interval_boxes": (None, "fidget_unrolled_interval_boxes_launch"),
    "unrolled_edges": (None, "fidget_unrolled_edges_launch"),
    "level_active": (None, "fidget_unrolled_level_launch"),
    "leaf_masks": (None, "fidget_unrolled_leaf_masks_launch"),
    "merge_topo": (None, "fidget_unrolled_merge_topo_launch"),
    "table_grow": (None, "fidget_unrolled_table_grow_launch"),
    # the ports of the Pallas probes P2 and P3 (fidget_tpu_torch/demos/)
    "interp_float2": ("interleave", "fidget_interp_float2"),
    "grid_step": ("grid_step", "fidget_grid_step"),
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
    # chunk mask_words choices_shared smem
    "fidget_liveness_codes": [_P] * 7 + [_I] * 10 + [_P],
    # w1 w2 imm lengths vars out scratch order | T L nf V O lanes r planes
    # chunk smem
    "fidget_interp_grad": [_P] * 8 + [_I] * 10 + [_P],
    # w1 w2 imm lengths vars out scratch order | T L nf V sub pp_out r cols
    # chunk smem
    "fidget_interp_voxel_depth": [_P] * 8 + [_I] * 10 + [_P],
    # w1 w2 imm lengths codes vars out scratch | T L LW nf V O lanes r
    # chunk smem
    "fidget_interp_float_coded": [_P] * 8 + [_I] * 10 + [_P],
    # w1a w2a imma w1b w2b immb classes vars out scratch | T L nf V lanes r
    # chunk smem
    "fidget_interp_float2": [_P] * 10 + [_I] * 8 + [_P],
    # x y | T G
    "fidget_grid_step": [_P] * 2 + [_I] * 2 + [_P],
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


@span("fidget.kernels.emit")
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
    stems = sorted({stem for stem, _ in KERNELS.values() if stem})
    todo = [s for s in stems if not (out / f"lib{s}.so").exists()]
    if not todo:
        return out
    with span("fidget.kernels.build"):
        _compile(out, todo)
    count("kernels.built", len(todo))
    return out


def _compile(out: pathlib.Path, todo: list) -> None:
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


def _lib(stem: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(stem)
        if lib is None:
            path = build() / f"lib{stem}.so"
            with span("fidget.kernels.load"):
                lib = ctypes.CDLL(str(path))
            count("kernels.loaded")
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
