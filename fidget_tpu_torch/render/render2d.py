"""Level-synchronous 2D MPR rasterizer (single level, bucketed).

The counterpart of `fidget_tpu.render.render2d` on its main path:
`PixelRenderer.render()` with one tile level and the tape as data in
a (capacity, register-file, choice-words) bucket. A frame is:

1. **Root interval pass** — one `interp_interval` launch (K1) where the
   *lanes* are the root tiles; per-tile output intervals plus packed
   2-bit choice codes.
2. **Liveness pass** — one `liveness_codes` launch (K2) over the shared
   tape, lanes = root tiles: per-tile action codes.
3. **Reconstruction** — per-tile child tapes by tensor ops
   (`reconstruct`).
4. **Leaf pass** — one `interp_float` launch (K3), one instance per
   root tile over its pixels; culled tiles get tape length 0.
5. **Assembly** — distances and fills combine through dense reshapes.

On CUDA every kernel is hand-written (fidget_tpu_torch/csrc); on the
CPU the plain PyTorch versions run instead. The choice is made by the
renderer's device alone. `_TracedBind` is shared with the 3D renderer
(render3d.py). Two-level tiles, per-shape specialization
(`_ConstBind`), the unrolled and dense modes and `Shape` inputs to the
2D renderer are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..compiler.pack import pack_tapes
from ..compiler.tape import Tape
from ..eval.arith import FloatMode, IntervalMode
from ..eval.interp import interp_float, interp_interval
from ..eval.simplify_device import (
    liveness_codes,
    per_lane_to_rows,
    reconstruct,
    unpack_codes,
)
from ..eval.unrolled import eval_tape
from .config import check_cancel
from .region import ImageSize, compose2, mat3_to_mat4
from .transform import transform_intervals, transform_points

#: fill codes in the `fill` channel of a rendered image
FILL_NONE = 0
FILL_INSIDE = 1
FILL_OUTSIDE = 2


def _resolve_device(device) -> torch.device:
    """The render device: CUDA unless the caller names another. With no
    card and no explicit device this raises; it never falls back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to render on the CPU"
            )
        device = "cuda"
    return torch.device(device)


@dataclass
class Image2D:
    """Output of the 2D renderer, on the render device.

    distance: f32 [H, W] — signed distance where evaluated (0 in filled
      regions; consult `fill`).
    fill: int8 [H, W] — FILL_NONE where `distance` is valid, else
      FILL_INSIDE/FILL_OUTSIDE from interval proofs.
    """

    distance: torch.Tensor
    fill: torch.Tensor

    def fill_class(self) -> torch.Tensor:
        """Level-stripped fill codes: FILL_NONE / FILL_INSIDE /
        FILL_OUTSIDE regardless of the cull level that proved them."""
        f = self.fill
        return torch.where(f == FILL_NONE, f, (f - 1) % 2 + 1).to(torch.int8)

    def fill_level(self) -> torch.Tensor:
        """Cull level per filled pixel (0 = root tiles); -1 where the
        pixel was evaluated."""
        f = self.fill.to(torch.int16)
        return torch.where(f == FILL_NONE, -1, (f - 1) // 2).to(torch.int8)

    def inside(self) -> torch.Tensor:
        """Boolean occupancy (the reference's "mono" mode)."""
        return torch.where(
            self.fill == FILL_NONE,
            self.distance < 0,
            self.fill_class() == FILL_INSIDE,
        )


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_plane(a, s0):
    """[..., K] -> [..., s0, 128] zero-padded lane planes."""
    K = a.shape[-1]
    padn = s0 * 128 - K
    if padn:
        a = torch.cat([a, a.new_zeros(a.shape[:-1] + (padn,))], dim=-1)
    return a.reshape(a.shape[:-1] + (s0, 128))


class _TracedBind:
    """Tape binding for the bucketed pipeline: the padded arena, the
    x/y/z input indices (-1 = unused) and the bucket dims, canonical
    opcode order, single level."""

    def __init__(self, w1, w2, imm, lens, axis_idx, Lcap, nf, V, c_words):
        self.arena = (w1, w2, imm, lens)
        self.axis_idx = [int(i) for i in axis_idx]
        self.Lcap, self.nf, self.V = Lcap, nf, V
        self.c_words = c_words

    def set_axes(self, planes, triples):
        """planes: tuple of [..., V, s0, 128] tensors; triples: one
        padded plane (or (lo, hi)) per axis k=0,1,2, written into the
        input slot of that axis. Returns new planes."""
        planes = tuple(
            p.clone(memory_format=torch.contiguous_format) for p in planes
        )
        for idx, plane_k in zip(self.axis_idx, triples):
            if idx >= 0:
                for p, pk in zip(planes, plane_k):
                    p[..., idx, :, :] = pk
        return planes

    def root_codes(self, choices0, n0):
        """K2 over the shared tape: packed action codes per root tile,
        [n0, ceil(Lcap/16)]."""
        w1, w2, _, lens = self.arena
        perlane = liveness_codes(
            w1, w2, lens, choices0, nf=self.nf, L=self.Lcap,
            shared_tape=True,
        )  # [B, lw, s0r, 128]
        return per_lane_to_rows(perlane, n0)

    def simplify_root(self, per_tile):
        """Per-tile child arenas (w1, w2, imm, lengths) from K2 codes."""
        w1, w2, imm, _ = self.arena
        codes_u8 = unpack_codes(per_tile, self.Lcap)
        return reconstruct(w1, w2, imm, codes_u8)[:4]

    def leaf_eval(self, w1c, w2c, immc, lensc, vars_, s0l):
        return interp_float(
            w1c, w2c, immc, lensc, vars_,
            nf=self.nf, n_inputs=self.V, n_outputs=1, s0=s0l,
        )[:, 0]


def _frame_core(
    b, T0, n0x, x0, y0, mat, z, var_vec, *,
    pixel_perfect: bool, stop_after: str | None = None, stage_hook=None,
):
    """THE 2D frame pipeline: root interval cull -> per-tile tape
    simplification -> dense leaf pass -> assembly, on the tape binding
    `b`. `stop_after` ("root" | "codes" | "simplify" | "leaf") returns
    that stage's intermediates, as the reference's `_frame_core` does;
    `stage_hook(name)`, if given, is called as each stage is enqueued
    (the chip smoke test records CUDA events there)."""
    hook = stage_hook if stage_hook is not None else (lambda name: None)
    n0 = x0.shape[0]
    n0y = n0 // n0x
    s0r = max(8, _ceil_to(-(-n0 // 128), 8))
    s0l = (T0 * T0) // 128
    V = b.V
    im = IntervalMode(torch)
    dev = x0.device

    # ---- stage 1: root interval pass (lanes = root tiles) -----------
    mxi, myi, mzi = transform_intervals(
        im, mat, (x0, x0 + T0), (y0, y0 + T0), (z, z)
    )
    var_lo = var_vec[None, :, None, None].expand(1, V, s0r, 128)
    triples = [
        (
            _pad_plane(torch.broadcast_to(ivl[0], x0.shape), s0r),
            _pad_plane(torch.broadcast_to(ivl[1], x0.shape), s0r),
        )
        for ivl in (mxi, myi, mzi)
    ]
    var_lo, var_hi = b.set_axes((var_lo, var_lo), triples)
    w1r, w2r, immr, lensr = b.arena
    olo, ohi, choices0 = interp_interval(
        w1r, w2r, immr, lensr, var_lo, var_hi,
        nf=b.nf, n_inputs=V, n_outputs=1, s0=s0r, c_words=b.c_words,
    )
    rlo = olo[0, 0].reshape(-1)[:n0]
    rhi = ohi[0, 0].reshape(-1)[:n0]
    root_in = rhi < 0.0
    root_out = rlo > 0.0
    root_active = ~(root_in | root_out)
    if pixel_perfect:
        root_active = torch.ones_like(root_active)
    hook("root")
    if stop_after == "root":
        return rlo, choices0

    # ---- stage 2: per-root-tile simplification -----------------------
    per_tile = b.root_codes(choices0, n0)
    hook("codes")
    if stop_after == "codes":
        return per_tile, root_active
    w1s, w2s, imms, lens0 = b.simplify_root(per_tile)
    hook("reconstruct")
    lens0a = torch.where(root_active, lens0, torch.zeros_like(lens0))
    if stop_after == "simplify":
        return lens0a, w1s
    fill_child = torch.where(
        root_active,
        torch.full_like(root_in, FILL_NONE, dtype=torch.int8),
        torch.where(
            root_in,
            torch.full_like(root_in, FILL_INSIDE, dtype=torch.int8),
            torch.full_like(root_in, FILL_OUTSIDE, dtype=torch.int8),
        ),
    )

    # ---- stage 3: leaf pass (one instance per root tile) -------------
    ii = torch.arange(T0, dtype=torch.float32, device=dev)
    px = (x0[:, None, None] + ii[None, None, :]).expand(n0, T0, T0)
    py = (y0[:, None, None] + ii[None, :, None]).expand(n0, T0, T0)
    px = px.reshape(n0, s0l, 128)
    py = py.reshape(n0, s0l, 128)
    mx, my, mz = transform_points(mat, px, py, z)
    vars_ = var_vec[None, :, None, None].expand(n0, V, s0l, 128)
    (vars_,) = b.set_axes(
        (vars_,),
        [(torch.broadcast_to(p, (n0, s0l, 128)),) for p in (mx, my, mz)],
    )
    dist = b.leaf_eval(w1s, w2s, imms, lens0a, vars_, s0l)
    hook("leaf")
    if stop_after == "leaf":
        return (dist,)

    # ---- stage 4: assemble -------------------------------------------
    img = dist.reshape(n0y, n0x, T0, T0).transpose(1, 2)
    img = img.reshape(n0y * T0, n0x * T0)
    fill = fill_child.reshape(n0y, n0x)
    fill = fill.repeat_interleave(T0, 0).repeat_interleave(T0, 1)
    hook("assemble")
    return img, fill


class PixelRenderer:
    """2D renderer for one tape at one image size.

    Args:
      tape: the shape's register tape (single output).
      image_size: output size in pixels.
      tile_size: root tile edge (default 128); leaves evaluate at this
        granularity with one simplification level.
      device: render device; None means CUDA, and raises when there is
        no card. Pass "cpu" to run the plain PyTorch versions.
    """

    def __init__(
        self,
        tape: Tape,
        image_size: ImageSize,
        *,
        tile_size: int | None = None,
        device=None,
    ):
        if tape.output_count != 1:
            raise ValueError("2D rendering expects a single output")
        self.device = _resolve_device(device)
        self.tape = tape
        self.size = image_size
        T0 = 128 if tile_size is None else int(tile_size)
        if (T0 * T0) % 128:
            raise ValueError("tile must fill 128-lane planes")
        self.T0 = T0
        self.W = image_size.width
        self.H = image_size.height
        self.n0x = -(-self.W // T0)
        self.n0y = -(-self.H // T0)
        self.n0 = self.n0x * self.n0y
        self.s0r = max(8, _ceil_to(-(-self.n0 // 128), 8))
        self.s0l = (T0 * T0) // 128

        self.nf = tape.reg_count + tape.mem_count
        # padded to >= 1 so constant-only shapes still build var planes
        self.n_inputs = max(1, len(tape.var_map))
        self.c_words = max(1, -(-tape.choice_count // 16))
        self.axis_of = {v.kind: i for v, i in tape.var_map.items()}

        # static screen coordinates of root tiles (row-major)
        tx = np.arange(self.n0x) * T0
        ty = np.arange(self.n0y) * T0
        gx, gy = np.meshgrid(tx, ty)
        self.tile_x0 = gx.reshape(-1).astype(np.float32)
        self.tile_y0 = gy.reshape(-1).astype(np.float32)
        # bucketed dims (canonical op order), as the reference sizes them
        self.Lcap_b = max(64, 1 << (len(tape) - 1).bit_length())
        self.nf_b = _ceil_to(max(self.nf, 64), 64)
        self.cw_b = max(1, 1 << (self.c_words - 1).bit_length())
        self.packed_b = pack_tapes([tape], capacity=self.Lcap_b)
        self.axis_idx = np.array(
            [
                -1 if self.axis_of.get(k) is None else self.axis_of[k]
                for k in ("x", "y", "z")
            ],
            np.int32,
        )
        # device copies of the arena and tile corners, made once
        dev = self.device
        p = self.packed_b
        self._arena = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (p.w1, p.w2, p.imm, p.lengths)
        )
        self._x0 = torch.from_numpy(self.tile_x0).to(dev)
        self._y0 = torch.from_numpy(self.tile_y0).to(dev)

    # ------------------------------------------------------------------

    def _bind(self) -> _TracedBind:
        return _TracedBind(
            *self._arena, self.axis_idx, self.Lcap_b, self.nf_b,
            self.n_inputs, self.cw_b,
        )

    def _frame(self, mat, z, var_vec, *, pixel_perfect=False,
               stop_after=None, stage_hook=None):
        """One frame through `_frame_core` from host inputs: `mat` a
        [4, 4] array, `z` a float, `var_vec` a [V] array."""
        dev = self.device
        return _frame_core(
            self._bind(), self.T0, self.n0x, self._x0, self._y0,
            torch.as_tensor(mat, dtype=torch.float32, device=dev),
            torch.tensor(z, dtype=torch.float32, device=dev),
            torch.as_tensor(var_vec, dtype=torch.float32, device=dev),
            pixel_perfect=pixel_perfect, stop_after=stop_after,
            stage_hook=stage_hook,
        )

    def _mat4(self, world_to_model: np.ndarray | None) -> np.ndarray:
        """Combined (px, py, z, 1) -> model 4x4: screen->world 3x3 and
        the optional world->model view."""
        return mat3_to_mat4(compose2(world_to_model, self.size)).astype(
            np.float32
        )

    def _var_vec(self, vars) -> np.ndarray:
        """Dense per-input value vector from a {Var: value} mapping
        (axes are filled by the transform stages and ignored here)."""
        vec = np.zeros(self.n_inputs, np.float32)
        if vars is not None:
            for v, val in vars.items():
                idx = self.tape.var_map.get(v)
                if idx is not None:
                    vec[idx] = np.float32(val)
        missing = [
            v
            for v in self.tape.var_map
            if v.kind == "v" and (vars is None or v not in vars)
        ]
        if missing:
            raise ValueError(f"unbound shape variables: {missing}")
        return vec

    def render(
        self,
        world_to_model: np.ndarray | None = None,
        *,
        z: float = 0.0,
        vars: dict | None = None,
        pixel_perfect: bool = False,
        cancel=None,
    ) -> Image2D:
        """Renders a frame: a fired CancelToken raises RenderCancelled
        before any work is enqueued. The image stays on the device."""
        check_cancel(cancel)
        img, fill = self._frame(
            self._mat4(world_to_model), z, self._var_vec(vars),
            pixel_perfect=pixel_perfect,
        )
        return Image2D(img[: self.H, : self.W], fill[: self.H, : self.W])

    def render_brute(
        self,
        world_to_model: np.ndarray | None = None,
        *,
        z: float = 0.0,
        vars: dict | None = None,
    ) -> np.ndarray:
        """Dense per-pixel evaluation on the host with numpy — the
        ground-truth oracle for the tiled pipeline (the reference's
        `RenderMode::Brute`). Returns f32 [H, W] distances."""
        mat = self._mat4(world_to_model)
        vec = self._var_vec(vars)
        cols = np.arange(self.W, dtype=np.float32)
        rows = np.arange(self.H, dtype=np.float32)
        px, py = np.meshgrid(cols, rows)
        mx, my, mz = transform_points(mat, px, py, np.float32(z))
        inputs = [
            np.broadcast_to(v, px.shape).astype(np.float32) for v in vec
        ]
        for kind, plane in (("x", mx), ("y", my), ("z", mz)):
            idx = self.axis_of.get(kind)
            if idx is not None:
                inputs[idx] = np.broadcast_to(plane, px.shape).astype(
                    np.float32
                )
        with np.errstate(all="ignore"):
            (d,), _ = eval_tape(self.tape, FloatMode(np), inputs)
        return d


def render(
    tape: Tape,
    image_size: ImageSize,
    *,
    world_to_model: np.ndarray | None = None,
    z: float = 0.0,
    vars: dict | None = None,
    tile_size: int | None = None,
    pixel_perfect: bool = False,
    device=None,
) -> Image2D:
    """One-shot 2D render (mirrors fidget_raster::pixel::render)."""
    r = PixelRenderer(tape, image_size, tile_size=tile_size, device=device)
    return r.render(
        world_to_model, z=z, vars=vars, pixel_perfect=pixel_perfect
    )
