"""Multi-rank rendering and parameter fitting on `torch.distributed`.

The counterpart of `fidget_tpu.parallel.sharding`. The reference
shards work over a `jax.sharding.Mesh` inside one SPMD program; here
every rank is a process of an initialized process group (NCCL on the
card, gloo on the CPU), and each rank computes its own slab of image
rows:

- **rendering**: the tile grid is data-parallel. Each rank runs the
  whole per-tile pipeline over its rows of root tiles with no
  communication until assembly, then an all-gather of the slabs gives
  every rank the whole image on its own device (the reference's
  replicated host image, `_to_host`, is its counterpart).
  `render_unrolled_sharded` exchanges the tiles' activity after the
  cull and deals the active tiles out evenly (post-cull rebalance).
- **fitting**: each rank forms its slab's share of the loss,
  differentiates it, and the gradient and the loss are all-reduced
  (the reference's `psum`) once per step, the standard data-parallel
  pattern.

Interval culling is control flow and carries no gradient (SURVEY.md
§3.5: fills short-circuit gradients in the reference too). Renderers
are cached by the tape's contents (`tape_key`), so no tape is pinned
against a recycled `id()`, and every kernel they build is keyed the same
way.

Run one process per rank; each initializes the group itself, e.g.
`torch.distributed.init_process_group("nccl", init_method=
"tcp://localhost:29500", rank=r, world_size=D)` after
`torch.cuda.set_device(r)`, then `mesh = make_mesh()`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..compiler.tape import tape_key
from ..eval.cuda import resolve_device
from ..eval.interp import interp_float
from ..render.region import ImageSize
from ..render.render2d import Image2D, PixelRenderer
from ..render.render3d import Image3D, VoxelRenderer
from ..render.transform import transform_points
from ..render.unrolled2d import (
    _assemble,
    _device_args,
    _fill_tiles,
    _leaf,
    cull_unrolled,
    ready,
    state,
)
from ..shape import Shape
from ..utils import count, span

__all__ = [
    "RankMesh",
    "all_gather",
    "all_reduce",
    "fit_step",
    "make_mesh",
    "render_sharded",
    "render_tiles_sharded",
    "render_unrolled_sharded",
    "render_voxels_sharded",
]


@dataclass(frozen=True)
class RankMesh:
    """This rank's view of a process group: the group, this rank, the
    number of ranks, the group's backend and the device this rank
    renders on."""

    group: object
    rank: int
    size: int
    backend: str
    device: torch.device


def make_mesh(*, device=None) -> RankMesh:
    """The mesh of the initialized default process group. `device` is
    this rank's device; None means the current CUDA device (set it per
    rank with `torch.cuda.set_device`), and raises when there is no
    card. Pass "cpu" with the gloo backend."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no initialized torch.distributed process group: in each rank "
            "call torch.distributed.init_process_group(backend, "
            "init_method='tcp://localhost:<port>' (or store=...), "
            "rank=<rank>, world_size=<ranks>) before make_mesh(); the "
            "backend is 'nccl' for CUDA devices and 'gloo' for the CPU"
        )
    group = dist.group.WORLD
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    backend = str(dist.get_backend(group))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend serves CUDA devices only; use "
                         "gloo for the CPU")
    return RankMesh(group, dist.get_rank(group), dist.get_world_size(group),
                    backend, dev)


# ======================================================================
# collectives


def all_gather(mesh: RankMesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's `t` concatenated along dim 0 in rank order (the
    reference's tiled `all_gather`), on every rank."""
    if t.dtype == torch.bool:
        return all_gather(mesh, t.view(torch.uint8)).view(torch.bool)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(mesh: RankMesh, t: torch.Tensor, op: str = "sum"):
    """`t` reduced over the ranks by `op` ("sum" or "max"), on every
    rank; `t` itself is left as it was."""
    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, op=_OPS[op], group=mesh.group)
    return t


# ======================================================================
# renderers, cached by the tape's contents

_RENDERERS: dict = {}
_RENDERERS_MAX = 64


def _renderer(cls, tape, size, device, **opts):
    """The `cls` renderer of `tape` (a Tape or a Shape) at `size` and
    `opts` on `device`, made once per (contents, transform, size, opts,
    device)."""
    shaped = isinstance(tape, Shape)
    transform = tape.transform if shaped else None
    bare = tape.tape() if shaped else tape
    dims = tuple(getattr(size, k, None) for k in ("width", "height", "depth"))
    key = (
        cls.__name__, tape_key(bare),
        None if transform is None else transform.tobytes(), dims,
        tuple(sorted(opts.items())), str(device),
    )
    r = _RENDERERS.get(key)
    if r is None:
        if len(_RENDERERS) >= _RENDERERS_MAX:
            _RENDERERS.pop(next(iter(_RENDERERS)))
        r = cls(tape, size, device=device, **opts)
        _RENDERERS[key] = r
        count("renderers.built")
    return r


def _divides(n: int, D: int, what: str, unit: int):
    if n % D:
        raise ValueError(
            f"{what} ({n}) must divide over {D} devices; pick an image "
            f"height that is a multiple of {unit * D}"
        )


def _slab(a: torch.Tensor, shape, d: int, D: int, axis: int):
    """Rank d's 1/D part of `a` reshaped to `shape`, along `axis`,
    flattened (row-major order kept)."""
    a = a.reshape(shape)
    n = shape[axis] // D
    return a.narrow(axis, d * n, n).reshape(-1).contiguous()


# ======================================================================
# dense rows and fitting


def _dense_rows(r, d, R, mat, z, vec):
    """U1 over image rows [d R, (d + 1) R) as one tile W px wide: f32
    [R, W], differentiable in `vec`."""
    st = state(r)
    dev = r.device
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    cy0 = torch.full((1,), float(d * R), dtype=torch.float32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    out = _leaf(st.float_full, (0,), r.W, r.W * R, zero, cy0, one, mat, z,
                vec, st)
    return out.reshape(R, r.W)


def _interp_rows(r, d, R, mat, z, vec):
    """K3 over image rows [d R, (d + 1) R): the canonical arena, one
    instance whose lanes are the slab's pixels, padded with copies of
    the last real pixel as the reference pads them (zero padding can
    land on a kink, e.g. sqrt at the origin, where a partial is not
    finite). f32 [R, W], differentiable in `vec`. Counts the partials a
    gradient keeps, the non-axis inputs at the real lanes
    (`jacobian.tangents_kept`)."""
    W, dev = r.W, r.device
    K = R * W
    s0 = max(8, -(-K // 1024) * 8)  # ceil(K / 128) planes, up to 8n
    cols = torch.arange(W, dtype=torch.float32, device=dev)
    rows = torch.arange(R, dtype=torch.float32, device=dev) + float(d * R)
    py, px = torch.meshgrid(rows, cols, indexing="ij")
    planes = [vec[i].expand(K) for i in range(r.n_inputs)]
    n_axes = 0
    for kind, m in zip("xyz", transform_points(mat, px, py, z)):
        idx = r.axis_of.get(kind)
        if idx is not None:
            planes[idx] = torch.broadcast_to(m, (R, W)).reshape(K)
            n_axes += 1
    count("jacobian.tangents_kept", (r.n_inputs - n_axes) * K)
    pad = s0 * 128 - K
    flat = [torch.cat([p, p[-1:].expand(pad)]).reshape(s0, 128)
            for p in planes]
    vars_ = torch.stack(flat)[None]  # [1, V, s0, 128]
    out = interp_float(*r._arena, vars_, nf=r._nf_regs, n_inputs=r.n_inputs,
                       n_outputs=1, s0=s0)
    return out[0, 0].reshape(-1)[:K].reshape(R, W)


def render_sharded(
    tape,
    size: ImageSize,
    mesh: RankMesh,
    *,
    world_to_model: np.ndarray | None = None,
    z: float = 0.0,
    params: dict | None = None,
) -> torch.Tensor:
    """Dense render with rows sharded over the ranks: U1 (the whole
    tape, generated for it) over each rank's rows, then an all-gather.
    Returns f32 [H, W] on every rank's device; differentiable in no
    input (see `fit_step`)."""
    H, W = size.height, size.width
    D, d = mesh.size, mesh.rank
    _divides(H, D, "image rows", 1)
    r = _renderer(PixelRenderer, tape, size, mesh.device)
    ready(r, [state(r).float_full], "block")
    mat, zt, vec = _device_args(r, r._mat4(world_to_model), z,
                                r._var_vec(params))
    return all_gather(mesh, _dense_rows(r, d, H // D, mat, zt, vec))


@span("fidget.fit_step", request=True)
def fit_step(
    tape,
    size: ImageSize,
    mesh: RankMesh,
    params: dict,
    target,
    *,
    lr: float = 0.5,
    z: float = 0.0,
    pipeline: str = "unrolled",
):
    """One data-parallel gradient-descent step on shape parameters.

    Each rank renders its slab of rows, forms its share of the loss
    `sum((d - target)^2) / (H W)` and differentiates it in the
    parameters; the gradient and the loss are then summed over the ranks
    (all-reduce), so every rank takes the same step.

    pipeline: "unrolled" (default) evaluates with U1, the tape generated
    as straight-line code (`_UnrolledLeaf`, its derivative from K4);
    "interp" with the float interpreter K3 (`interp_float`, through
    `_FloatDiff`: the derivative from K4 passes), which builds nothing
    per shape.

    `target` is the whole [H, W] image (numpy or a tensor). Returns
    (new_params, loss): floats, equal on every rank.

    A step is a request of `utils`' recorder (`fidget.fit_step`), its
    stages spans inside it: `fidget.fit.prep` (the renderer, its
    kernels, the arguments), `.forward`, `.backward`, `.reduce` (and
    `fidget.fit.wait` around each host read, which waits for the card).
    """
    H, W = size.height, size.width
    D, d = mesh.size, mesh.rank
    _divides(H, D, "image rows", 1)
    if pipeline not in ("unrolled", "interp"):
        raise ValueError(
            f"pipeline must be 'unrolled' or 'interp', not {pipeline!r}"
        )
    with span("fidget.fit.prep"):
        r = _renderer(PixelRenderer, tape, size, mesh.device)
        if pipeline == "unrolled":
            ready(r, [state(r).float_full], "block")
        R = H // D
        dev = r.device
        # the gradient is taken in the var vector, whose entries are the
        # tape's inputs in the same order on every rank (each rank's
        # `Var`s are its own objects, so their order is not)
        vec = torch.tensor(r._var_vec(params), device=dev,
                           requires_grad=True)
        mat = torch.as_tensor(r._mat4(None), device=dev)
        zt = torch.tensor(z, dtype=torch.float32, device=dev)
    with span("fidget.fit.forward"):
        rows = _dense_rows if pipeline == "unrolled" else _interp_rows
        dist_ = rows(r, d, R, mat, zt, vec)
        tgt = torch.as_tensor(target, dtype=torch.float32)[d * R:(d + 1) * R]
        local = ((dist_ - tgt.to(dev)) ** 2).sum() / (H * W)
    with span("fidget.fit.backward"):
        (g,) = torch.autograd.grad(local, vec)
    with span("fidget.fit.reduce"):
        step = vec.detach() - lr * all_reduce(mesh, g)
        with span("fidget.fit.wait"):
            new = step.tolist()
        total = all_reduce(mesh, local.detach())
        with span("fidget.fit.wait"):
            loss = float(total)
    idx = r.tape.var_map
    return {
        v: new[idx[v]] if v in idx else float(np.float32(params[v]))
        for v in params
    }, loss


# ======================================================================
# tiled frames


def render_tiles_sharded(
    tape,
    size: ImageSize,
    mesh: RankMesh,
    *,
    tile_sizes: Sequence[int] | None = None,
    world_to_model: np.ndarray | None = None,
    z: float = 0.0,
    vars: dict | None = None,
    pixel_perfect: bool = False,
) -> Image2D:
    """The tiled interpreter pipeline sharded over the ranks.

    Root-tile rows are distributed across the ranks; each rank runs the
    complete per-tile pipeline (interval cull -> tape simplification ->
    leaf) on its slab with no communication
    (`PixelRenderer._frame_tiles`, the per-shape binding: K1, K2, K3),
    exactly like the reference's rayon tile loop
    (fidget-raster/src/lib.rs:99-167). The slabs are then all-gathered:
    every rank returns the whole Image2D on its device."""
    D, d = mesh.size, mesh.rank
    ts = tuple(tile_sizes) if tile_sizes else None
    r = _renderer(PixelRenderer, tape, size, mesh.device, tile_sizes=ts)
    _divides(r.n0y, D, "root tile rows", r.T0)
    mat, zt, vec = _device_args(r, r._mat4(world_to_model), z,
                                r._var_vec(vars))
    grid = (r.n0y, r.n0x)
    img, fill = r._frame_tiles(
        mat, zt, vec, _slab(r._x0, grid, d, D, 0),
        _slab(r._y0, grid, d, D, 0), pixel_perfect=pixel_perfect,
    )
    H, W = size.height, size.width
    return Image2D(all_gather(mesh, img)[:H, :W],
                   all_gather(mesh, fill)[:H, :W])


def render_unrolled_sharded(
    tape,
    size: ImageSize,
    mesh: RankMesh,
    *,
    world_to_model: np.ndarray | None = None,
    z: float = 0.0,
    vars: dict | None = None,
    tile_size: int = 8,
    cap: int | None = None,
    _debug_counts: bool = False,
):
    """Tiled-unrolled 2D render with post-cull load rebalancing.

    The static-slab pipelines shard tile rows with no communication,
    which strands ranks whose slab culls to nothing (a scene whose
    geometry lands in one slab leaves D - 1 ranks idle). This is the
    analog of the reference's rayon work stealing
    (fidget-raster/src/lib.rs:99-167), expressed with collectives:

    1. each rank interval-culls its own tile-row slab (U2);
    2. an all-gather of the per-tile activity flags (n0 bytes);
    3. every rank compacts the same global active list (a stable sort)
       and takes every D-th entry from its own offset, a balanced share
       wherever the geometry landed;
    4. each rank evaluates its share (U1, the expensive stage);
    5. an all-gather of the distance blocks lets every rank assemble its
       own image slab; a last all-gather of the slabs gives every rank
       the whole image.

    The worklist holds `cap` slots (by default half the tiles, in
    buckets of an eighth of them; never more than the tiles, and a
    multiple of the ranks); when more tiles are active, every
    rank sees the same count after step 2 and re-sizes the worklist to
    the next bucket before step 3, so no rank evaluates a truncated
    list. Returns an Image2D (and with `_debug_counts` the active tiles
    each rank evaluated, int64 [D])."""
    D, d = mesh.size, mesh.rank
    T0 = int(tile_size)
    r = _renderer(PixelRenderer, tape, size, mesh.device)
    n0x = -(-size.width // T0)
    n0y = -(-size.height // T0)
    n0 = n0x * n0y
    _divides(n0y, D, "tile rows", T0)
    st = state(r)
    ready(r, [st.float_full, st.interval("proofs")], "block")
    n0_loc = n0 // D
    x0g, y0g = st.tiles(T0)
    x0 = _slab(x0g, (n0y, n0x), d, D, 0)
    y0 = _slab(y0g, (n0y, n0x), d, D, 0)
    mat, zt, vec = _device_args(r, r._mat4(world_to_model), z,
                                r._var_vec(vars))
    dev = r.device

    def bucket(n):
        q = max(128, -(-n0 // 8))
        c = min(-(-max(int(n), 1) // q) * q, n0)
        return -(-c // D) * D  # divisible slices per rank

    C = (bucket(max(n0 // 2, 1)) if cap is None
         else min(-(-int(cap) // D) * D, n0))  # n0 divides over D
    # 1) cull my slab
    root_in, root_out, _ = cull_unrolled(r, T0, x0, y0, mat, zt, vec)
    act_loc = ~(root_in | root_out)
    # 2) exchange the flags; the count is the same on every rank
    act = all_gather(mesh, act_loc)  # [n0]
    n_active = int(act.sum())
    if n_active > C:
        C = bucket(n_active)
    C_loc = C // D
    # 3) the same stable compaction on every rank, then the
    # round-robin deal: active tiles sit at the front of the order,
    # so contiguous slices would hand them all to rank 0
    order = torch.argsort((~act).to(torch.uint8), stable=True)[:C]
    my = order[torch.arange(C_loc, device=dev) * D + d]
    my_valid = act[my]
    # 4) evaluate my share
    dist_loc = _leaf(st.float_full, (0,), T0, T0 * T0, x0g[my], y0g[my],
                     my_valid, mat, zt, vec, st)  # [C_loc, pp]
    # 5) exchange the results and assemble my slab: compacted
    # position p lies on rank p % D at its row p // D, so at row
    # (p % D) C_loc + p // D of the gathered blocks
    dist_all = all_gather(mesh, dist_loc)  # [C, pp]
    pos = torch.arange(C, device=dev)
    slot_vals = (pos % D) * C_loc + pos // D
    slot_of = torch.full((n0,), C, dtype=torch.int64, device=dev).scatter(
        0, order, torch.where(act[order], slot_vals, C)
    )
    img, fill = _assemble(
        dist_all, slot_of[d * n0_loc:(d + 1) * n0_loc],
        _fill_tiles(act_loc, root_in), n0x, n0y // D, T0,
    )
    H, W = size.height, size.width
    out = Image2D(all_gather(mesh, img)[:H, :W],
                  all_gather(mesh, fill)[:H, :W])
    if _debug_counts:
        return out, all_gather(mesh, my_valid.sum().reshape(1))
    return out


def render_voxels_sharded(
    tape,
    size,
    mesh: RankMesh,
    *,
    world_to_model: np.ndarray | None = None,
    vars: dict | None = None,
    mode: str = "normals",
    tile_size: int = 64,
    sub_size: int = 16,
    max_retries: int = 3,
    leaf: str = "interp",
    proofs: str = "interp",
) -> Image3D:
    """The 3D voxel pipeline sharded over the ranks.

    Root-tile rows (the image Y axis) are distributed across the ranks;
    each rank runs its complete slab (`VoxelRenderer._frame_tiles`:
    interval culls, per-level tape re-specialization, occlusion floor,
    voxel and normals passes) with no communication: occlusion is per
    pixel column, so Y-slab sharding keeps it exact. The worklist
    capacity is per rank; the ranks take the largest active count over
    all of them (all-reduce, max) before any decides to retry, so they
    retry together. `leaf` and `proofs` are `VoxelRenderer`'s. Returns
    the whole Image3D on every rank's device."""
    if mode not in ("normals", "heightmap"):
        raise ValueError(f"unknown mode {mode!r}")
    D, d = mesh.size, mesh.rank
    r = _renderer(VoxelRenderer, tape, size, mesh.device,
                  tile_size=tile_size, sub_size=sub_size, leaf=leaf,
                  proofs=proofs)
    g = r.geo
    _divides(g.nty, D, "tile rows", tile_size)
    ready(r, r._generated_kernels(), "block")
    matM = r._mat4(world_to_model)
    vec = r._var_vec(vars)
    st = g.statics(r.device)
    grid = (g.ntz, g.nty, g.ntx)
    tiles = [_slab(st[k], grid, d, D, 1)
             for k in ("tile_x0", "tile_y0", "tile_z0")]
    cap = min(max(256, r.cap // D), max(1, r.nsub // D))
    for _ in range(max_retries + 1):
        depth, normal, n_active = r._frame_tiles(matM, vec, *tiles,
                                                 mode=mode, cap=cap)
        worst = int(all_reduce(mesh, n_active.reshape(1), "max"))
        if worst <= cap:
            break
        cap = min(1 << (worst - 1).bit_length(), r.nsub // D)
    return Image3D(
        all_gather(mesh, depth),
        None if normal is None else all_gather(mesh, normal),
    )
