"""Level-synchronous 2D MPR rasterizer.

The counterpart of `fidget_tpu.render.render2d` on the interpreter:
`PixelRenderer.render()` with one or two tile levels. A frame is:

1. **Root interval pass** — one `interp_interval` launch (K1) where the
   *lanes* are the root tiles; per-tile output intervals plus packed
   2-bit choice codes.
2. **Liveness pass** — one `liveness_codes` launch (K2) over the shared
   tape, lanes = root tiles: per-tile action codes.
3. **Reconstruction** — per-tile child tapes by tensor ops
   (`reconstruct`).
4. **Subtile pass** (two-level mode) — K1 with one instance per root
   tile on its own child tape, lanes = its subtiles; K2 per instance;
   every subtile's tape is rebuilt from its parent's child tape.
5. **Leaf pass** — one `interp_float` launch (K3), one instance per
   leaf tile over its pixels; culled tiles get tape length 0.
6. **Assembly** — distances and fills combine through dense reshapes.

`_frame_core` is the one pipeline; the tape bindings differ:

- `_TracedBind` — the default: the tape as data in a (capacity,
  register-file, choice-words) bucket, canonical opcode order, single
  level. Shared with the 3D renderer (render3d.py). With
  `leaf_coded=True` steps 3 and 5 are replaced by one
  `interp_float_coded` launch (K6), which walks the shared tape under
  each tile's action codes and builds no child tapes.
- `_ConstBind` — `specialize=True` or two tile levels: the arena is
  packed at the tape's own length under the shape's
  `frequency_op_order`, and every kernel and `reconstruct` on it takes
  that same order.

On CUDA every kernel is hand-written (fidget_tpu_torch/csrc); on the
CPU the plain PyTorch versions run instead. The choice is made by the
renderer's device alone. A frame is differentiable in its var vector
through the leaf pass alone (`interp_float` is an autograd Function);
stages 1-4 run as one constant of differentiation (`_cull` behind
`untracked`). The unrolled and dense modes are not ported
yet.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..compiler.pack import frequency_op_order, pack_tapes
from ..compiler.tape import Tape
from ..eval import cuda
from ..eval.arith import FloatMode, IntervalMode
from ..eval.interp import (
    interp_float,
    interp_float_coded,
    interp_interval,
    tape_n_ops,
    untracked,
)
from ..eval.simplify_device import (
    DeviceSimplifier,
    liveness_codes,
    per_instance_codes,
    per_lane_to_rows,
    reconstruct,
    unpack_codes,
)
from ..eval.unrolled import eval_tape
from ..shape import Shape, ShapeVars
from .config import check_cancel
from .region import ImageSize, compose2, mat3_to_mat4
from .transform import transform_intervals, transform_points

#: fill codes in the `fill` channel of a rendered image. Fills proven
#: at deeper cull levels add 2 per level: a level-L inside fill is
#: `FILL_INSIDE + 2 * L`.
FILL_NONE = 0
FILL_INSIDE = 1
FILL_OUTSIDE = 2


@dataclass
class Image2D:
    """Output of the 2D renderer, on the render device.

    distance: f32 [H, W] — signed distance where evaluated (0 in filled
      regions; consult `fill`).
    fill: int8 [H, W] — FILL_NONE where `distance` is valid, else
      FILL_INSIDE/FILL_OUTSIDE (+ 2 per cull level) from interval
      proofs; see `fill_class` / `fill_level`.
    """

    distance: torch.Tensor
    fill: torch.Tensor

    def fill_class(self) -> torch.Tensor:
        """Level-stripped fill codes: FILL_NONE / FILL_INSIDE /
        FILL_OUTSIDE regardless of the cull level that proved them."""
        f = self.fill
        return torch.where(f == FILL_NONE, f, (f - 1) % 2 + 1).to(torch.int8)

    def fill_level(self) -> torch.Tensor:
        """Cull level per filled pixel, read off the level tag of its
        fill code (0 = root tiles, 1 = subtiles of the two-level mode);
        -1 where the pixel was evaluated."""
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


def _interval_vars(b, im, mat, z, var_vec, xi, yi, s0, lead):
    """Interval var planes (lo, hi), each [lead..., V, s0, 128], from
    screen interval pairs of shape [lead..., K] at depth z, for the
    tape binding `b`."""
    mxi, myi, mzi = transform_intervals(im, mat, xi, yi, (z, z))
    var_lo = var_vec.reshape((1,) * len(lead) + (b.V, 1, 1)).expand(
        lead + (b.V, s0, 128)
    )
    triples = [
        (
            _pad_plane(torch.broadcast_to(ivl[0], xi[0].shape), s0),
            _pad_plane(torch.broadcast_to(ivl[1], xi[0].shape), s0),
        )
        for ivl in (mxi, myi, mzi)
    ]
    return b.set_axes((var_lo, var_lo), triples)


class _Bind:
    """What `_frame_core` needs of a tape binding: the root arena, the
    x/y/z input indices (-1 = unused), the register-file, input and
    choice-word dims, and the opcode order of its arenas. `nf` is the
    register-file size of the binding's bucket; `nf_regs` is the one the
    value kernels (K1, K3, K6; in 3D K4 and K5) are launched with, which
    need hold only the registers the tape can name."""

    two_level = False
    op_order = None

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


class _TracedBind(_Bind):
    """Tape binding for the bucketed pipeline: the padded arena, the
    x/y/z input indices and the bucket dims, canonical opcode order,
    single level. `leaf_coded` swaps child tapes and the K3 leaf for
    the coded leaf (K6) over the shared tape."""

    def __init__(self, w1, w2, imm, lens, axis_idx, Lcap, nf, V, c_words,
                 leaf_coded=False, nf_regs=None):
        self.arena = (w1, w2, imm, lens)
        self.axis_idx = [int(i) for i in axis_idx]
        self.Lcap, self.nf, self.V = Lcap, nf, V
        self.nf_regs = nf if nf_regs is None else nf_regs
        self.c_words = c_words
        self.leaf_coded = leaf_coded
        self._per_tile = None
        self._root_active = None

    def root_codes(self, choices0, n0):
        """K2 over the shared tape: packed action codes per root tile,
        [n0, ceil(Lcap/16)]."""
        w1, w2, _, lens = self.arena
        perlane = liveness_codes(
            w1, w2, lens, choices0, nf=self.nf, L=self.Lcap,
            shared_tape=True,
        )  # [B, lw, s0r, 128]
        return per_lane_to_rows(perlane, n0)

    def simplify_root(self, per_tile, root_active=None):
        """Per-tile child arenas (w1, w2, imm, lengths) from K2 codes.
        The coded leaf keeps the code words (and the tiles' activity)
        instead and builds no child tapes."""
        if self.leaf_coded:
            self._per_tile = per_tile.contiguous()
            self._root_active = root_active
            return None, None, None, None
        w1, w2, imm, _ = self.arena
        codes_u8 = unpack_codes(per_tile, self.Lcap)
        return reconstruct(w1, w2, imm, codes_u8)[:4]

    def leaf_eval(self, w1c, w2c, immc, lensc, vars_, s0l):
        if self.leaf_coded:
            w1, w2, imm, lens = self.arena
            n0 = vars_.shape[0]
            lens_t = torch.where(
                self._root_active, lens.expand(n0), torch.zeros_like(lens)
            ).contiguous()
            return interp_float_coded(
                w1, w2, imm, lens_t, self._per_tile, vars_,
                nf=self.nf_regs, n_inputs=self.V, n_outputs=1, s0=s0l,
            )[:, 0]
        return interp_float(
            w1c, w2c, immc, lensc, vars_,
            nf=self.nf_regs, n_inputs=self.V, n_outputs=1, s0=s0l,
        )[:, 0]


class _ConstBind(_Bind):
    """Tape binding for the per-shape pipeline: the arena is packed at
    the tape's own length under the shape's opcode renumbering
    (pack.frequency_op_order), and the optional second tile level
    re-specializes leaf tapes per subtile."""

    def __init__(self, r):
        self.rend = r
        self.arena = r._arena_s
        self.axis_idx = [
            -1 if r.axis_of.get(k) is None else int(r.axis_of[k])
            for k in ("x", "y", "z")
        ]
        self.nf, self.V = r.nf, r.n_inputs
        self.nf_regs = r._nf_regs
        self.c_words = r.c_words
        self.op_order = r.op_order
        self.two_level = r.two_level

    def root_codes(self, choices0, n0):
        return self.rend.simplifier.codes_per_tile(choices0, n_tiles=n0)

    def simplify_root(self, per_tile, root_active=None):
        ds = self.rend.simplifier
        return ds._reconstruct(unpack_codes(per_tile, ds.L))[:4]

    def leaf_eval(self, w1c, w2c, immc, lensc, vars_, s0l):
        return interp_float(
            w1c, w2c, immc, lensc, vars_,
            nf=self.nf_regs, n_inputs=self.V, n_outputs=1, s0=s0l,
            op_order=self.op_order,
        )[:, 0]

    def second_level(self, w1s, w2s, imms, lens0a, x0, y0,
                     root_active, root_in, pixel_perfect,
                     im, mat, z, var_vec):
        """The second tile level: subtile interval pass with the
        per-tile simplified arenas (K1, one instance per root tile,
        lanes = its subtiles), then every subtile's tape rebuilt from
        its parent's (K2 per instance + `reconstruct`). Returns the leaf
        arenas, the subtile corners, their activity and their fills."""
        r = self.rend
        T1, m = r.T1, r.m
        n0 = x0.shape[0]
        nc = n0 * m
        sx0 = x0[:, None] + r._sub_dx[None, :]  # [n0, m]
        sy0 = y0[:, None] + r._sub_dy[None, :]
        var_lo1, var_hi1 = _interval_vars(
            self, im, mat, z, var_vec, (sx0, sx0 + T1), (sy0, sy0 + T1),
            r.s0s, (n0,),
        )
        olo1, ohi1, choices1 = interp_interval(
            w1s, w2s, imms, lens0a, var_lo1, var_hi1,
            nf=self.nf_regs, n_inputs=self.V, n_outputs=1, s0=r.s0s,
            c_words=self.c_words, op_order=self.op_order,
        )
        slo = olo1[:, 0].reshape(n0, -1)[:, :m]
        shi = ohi1[:, 0].reshape(n0, -1)[:, :m]
        act = root_active[:, None]
        sub_in = act & (shi < 0.0)
        sub_out = act & (slo > 0.0)
        sub_active = act & ~sub_in & ~sub_out
        if pixel_perfect:
            sub_active = torch.ones_like(sub_active)

        perlane = per_instance_codes(
            w1s, w2s, lens0a, choices1, nf=self.nf, op_order=self.op_order
        )  # [n0, s0s*128, lw]
        per_child = perlane[:, :m].reshape(nc, -1)
        codes_u8 = unpack_codes(per_child, w1s.shape[1])
        w1c, w2c, immc, lensc, _ = reconstruct(
            w1s.repeat_interleave(m, 0), w2s.repeat_interleave(m, 0),
            imms.repeat_interleave(m, 0), codes_u8, op_order=self.op_order,
        )
        # subtile-level proofs carry level tag 1; fills inherited from
        # a culled root tile keep level 0
        i8 = torch.int8
        fill_child = torch.where(
            sub_active,
            torch.full_like(sub_active, FILL_NONE, dtype=i8),
            torch.where(
                act,
                torch.where(sub_in, FILL_INSIDE + 2, FILL_OUTSIDE + 2),
                torch.where(root_in[:, None], FILL_INSIDE, FILL_OUTSIDE),
            ).to(i8),
        ).reshape(-1)
        return (
            w1c, w2c, immc, lensc,
            sx0.reshape(-1), sy0.reshape(-1),
            sub_active.reshape(-1), fill_child,
        )


def _cull(b, T0, T1, n0x, x0, y0, mat, z, var_iv, *, pixel_perfect,
          stop_after, hook):
    """Stages 1-4 of `_frame_core`: the root interval pass, per-tile
    codes and child tapes, and the optional second level. Returns the
    leaf arenas, tile corners, activity and fills (or, with
    `stop_after`, that stage's intermediates)."""
    n0 = x0.shape[0]
    s0r = max(8, _ceil_to(-(-n0 // 128), 8))
    V = b.V
    im = IntervalMode(torch)

    # ---- stage 1: root interval pass (lanes = root tiles) -----------
    var_lo, var_hi = _interval_vars(
        b, im, mat, z, var_iv, (x0, x0 + T0), (y0, y0 + T0), s0r, (1,)
    )
    w1r, w2r, immr, lensr = b.arena
    olo, ohi, choices0 = interp_interval(
        w1r, w2r, immr, lensr, var_lo, var_hi,
        nf=b.nf_regs, n_inputs=V, n_outputs=1, s0=s0r, c_words=b.c_words,
        op_order=b.op_order,
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
    w1s, w2s, imms, lens0 = b.simplify_root(per_tile, root_active)
    hook("reconstruct")
    lens0a = None if lens0 is None else torch.where(
        root_active, lens0, torch.zeros_like(lens0)
    )
    if stop_after == "simplify":
        return lens0a, w1s

    if not b.two_level:
        w1c, w2c, immc, lensc = w1s, w2s, imms, lens0a
        cx0, cy0 = x0, y0
        leaf_active = root_active
        fill_child = torch.where(
            root_active,
            torch.full_like(root_in, FILL_NONE, dtype=torch.int8),
            torch.where(root_in, FILL_INSIDE, FILL_OUTSIDE).to(torch.int8),
        )
    else:
        # ---- stages 3-4: subtile cull + re-specialization ------------
        (w1c, w2c, immc, lensc, cx0, cy0, leaf_active, fill_child) = (
            b.second_level(
                w1s, w2s, imms, lens0a, x0, y0, root_active, root_in,
                pixel_perfect, im, mat, z, var_iv,
            )
        )
        hook("subtiles")
    return w1c, w2c, immc, lensc, cx0, cy0, leaf_active, fill_child



def _frame_core(
    b, T0, T1, n0x, x0, y0, mat, z, var_vec, *,
    pixel_perfect: bool, stop_after: str | None = None, stage_hook=None,
):
    """THE 2D frame pipeline: root interval cull -> per-tile tape
    simplification -> (optional second level) -> dense leaf pass ->
    assembly, on the tape binding `b` (_TracedBind | _ConstBind).
    `stop_after` ("root" | "codes" | "simplify" | "leaf") returns that
    stage's intermediates, as the reference's `_frame_core` does (the
    coded binding builds no child tapes: "simplify" gives Nones there);
    `stage_hook(name)`, if given, is called as each stage is enqueued
    (the chip smoke test records CUDA events there).

    Only the leaf pass carries a gradient in `var_vec`: the cull stages
    (interval proofs, codes, child tapes, fills) run as one constant of
    differentiation (`untracked`) on its values, which also hands their
    kernels plain tensors under `torch.func` transforms."""
    hook = stage_hook if stage_hook is not None else (lambda name: None)
    n0 = x0.shape[0]
    n0y = n0 // n0x
    s0l = (T1 * T1) // 128
    V = b.V
    dev = x0.device
    out = untracked(
        functools.partial(_cull, b, T0, T1, n0x, pixel_perfect=pixel_perfect,
                          stop_after=stop_after, hook=hook),
        x0, y0, mat, z, var_vec.detach(),
    )
    if stop_after in ("root", "codes", "simplify"):
        return out
    w1c, w2c, immc, lensc, cx0, cy0, leaf_active, fill_child = out

    # ---- stage 5: leaf pass (one instance per leaf tile) -------------
    if lensc is not None:
        lensc = torch.where(leaf_active, lensc, torch.zeros_like(lensc))
    TC = cx0.shape[0]
    ii = torch.arange(T1, dtype=torch.float32, device=dev)
    px = (cx0[:, None, None] + ii[None, None, :]).expand(TC, T1, T1)
    py = (cy0[:, None, None] + ii[None, :, None]).expand(TC, T1, T1)
    px = px.reshape(TC, s0l, 128)
    py = py.reshape(TC, s0l, 128)
    mx, my, mz = transform_points(mat, px, py, z)
    vars_ = var_vec[None, :, None, None].expand(TC, V, s0l, 128)
    (vars_,) = b.set_axes(
        (vars_,),
        [(torch.broadcast_to(p, (TC, s0l, 128)),) for p in (mx, my, mz)],
    )
    dist = b.leaf_eval(w1c, w2c, immc, lensc, vars_, s0l)
    hook("leaf")
    if stop_after == "leaf":
        return (dist,)

    # ---- stage 6: assemble -------------------------------------------
    r = T0 // T1
    img = dist.reshape(n0y, n0x, r, r, T1, T1).permute(0, 2, 4, 1, 3, 5)
    img = img.reshape(n0y * T0, n0x * T0)
    fill = fill_child.reshape(n0y, n0x, r, r).permute(0, 2, 1, 3)
    fill = fill.reshape(n0y * r, n0x * r)
    fill = fill.repeat_interleave(T1, 0).repeat_interleave(T1, 1)
    hook("assemble")
    return img, fill


class PixelRenderer:
    """2D renderer for one tape at one image size.

    Args:
      tape: the shape's register tape or a Shape (single output); a
        Shape's transform is applied after the view.
      image_size: output size in pixels.
      tile_size: single-level mode: root tile edge (default 128);
        leaves evaluate at this granularity with one simplification
        level.
      tile_sizes: explicit level list, e.g. (128, 32) for two-level
        mode, where leaf tapes are re-specialized per subtile and
        subtile proofs fill with level tag 1.
      specialize: render() packs the arena at the tape's own length
        under the shape's opcode renumbering (`op_order`) instead of
        the canonical bucket. Two-level mode always does.
      device: render device; None means CUDA, and raises when there is
        no card. Pass "cpu" to run the plain PyTorch versions.
    """

    def __init__(
        self,
        tape: Tape | Shape,
        image_size: ImageSize,
        *,
        tile_size: int | None = None,
        tile_sizes: tuple | None = None,
        specialize: bool = False,
        device=None,
    ):
        self.shape_transform = None
        if isinstance(tape, Shape):
            self.shape_transform = tape.transform
            tape = tape.tape()
        if tape.output_count != 1:
            raise ValueError("2D rendering expects a single output")
        self.device = cuda.resolve_device(device)
        self.tape = tape
        self.size = image_size
        if tile_size is not None and tile_sizes is not None:
            raise ValueError("pass either tile_size or tile_sizes")
        if tile_size is not None:
            tile_sizes = (tile_size,)
        if tile_sizes is None:
            tile_sizes = (128,)
        if len(tile_sizes) not in (1, 2):
            raise ValueError("tile_sizes takes one or two levels")
        self.tile_sizes = tuple(int(t) for t in tile_sizes)
        self.two_level = len(self.tile_sizes) == 2
        self.specialize = specialize
        T0 = self.tile_sizes[0]
        T1 = self.tile_sizes[-1]
        if T0 % T1:
            raise ValueError("the root tile must be a multiple of the leaf tile")
        if (T1 * T1) % 128:
            raise ValueError("leaf tile must fill 128-lane planes")
        self.T0, self.T1 = T0, T1
        self.r = T0 // T1
        self.m = self.r * self.r
        self.W = image_size.width
        self.H = image_size.height
        self.n0x = -(-self.W // T0)
        self.n0y = -(-self.H // T0)
        self.n0 = self.n0x * self.n0y
        self.nc = self.n0 * self.m
        # lane layouts
        self.s0r = max(8, _ceil_to(-(-self.n0 // 128), 8))
        self.s0s = max(1, -(-self.m // 128))
        self.s0l = (T1 * T1) // 128

        self.nf = tape.reg_count + tape.mem_count
        # The register file K1 and K3 get: the registers the tape can
        # name. The bucket's nf (nf_b) sizes only what the reference
        # compiles per bucket; on the card nf is a launch argument, and
        # a small file lets a thread of K3 own four lanes.
        self._nf_regs = self.nf
        # the per-shape arena and simplifier are built lazily: the
        # bucketed single-level render() path never needs them
        self._packed = None
        self._simplifier = None
        self._op_order = None
        self._arena_s_dev = None
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
        # subtile offsets within a root tile, (sy, sx) row-major
        k = np.arange(self.m)
        self.sub_dx = ((k % self.r) * T1).astype(np.float32)
        self.sub_dy = ((k // self.r) * T1).astype(np.float32)
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
        self._sub_dx = torch.from_numpy(self.sub_dx).to(dev)
        self._sub_dy = torch.from_numpy(self.sub_dy).to(dev)

    # ------------------------------------------------------------------

    @property
    def op_order(self):
        """Per-shape opcode renumbering of the per-shape path: position
        -> canonical op, this shape's most frequent ops first."""
        if self._op_order is None:
            self._op_order = frequency_op_order(self.tape)
        return self._op_order

    @property
    def nops_s(self):
        """Vocabulary size under the per-shape opcode renumbering (the
        CUDA kernels keep their full switch and take no such size)."""
        return tape_n_ops(self.tape, self.op_order)

    @property
    def packed(self):
        """The tape packed at its own length under `op_order`."""
        if self._packed is None:
            self._packed = pack_tapes([self.tape], op_order=self.op_order)
        return self._packed

    @property
    def _arena_s(self):
        """Device copy of `packed` (w1, w2, imm, lengths)."""
        if self._arena_s_dev is None:
            p = self.packed
            self._arena_s_dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                for a in (p.w1, p.w2, p.imm, p.lengths)
            )
        return self._arena_s_dev

    @property
    def simplifier(self):
        if self._simplifier is None:
            self._simplifier = DeviceSimplifier(
                self.tape, self.op_order, device=self.device
            )
        return self._simplifier

    def _bind(self, leaf_coded=False):
        """The tape binding of this renderer's frames: the canonical
        bucket, or the per-shape arena for `specialize` and two-level
        tiles."""
        if self.two_level or self.specialize:
            if leaf_coded:
                raise ValueError(
                    "the coded leaf runs on the bucketed single-level path"
                )
            return _ConstBind(self)
        return _TracedBind(
            *self._arena, self.axis_idx, self.Lcap_b, self.nf_b,
            self.n_inputs, self.cw_b, leaf_coded, nf_regs=self._nf_regs,
        )

    def _frame(self, mat, z, var_vec, *, pixel_perfect=False,
               stop_after=None, stage_hook=None, leaf_coded=False):
        """One frame through `_frame_core` from host inputs: `mat` a
        [4, 4] array, `z` a float, `var_vec` a [V] array or tensor.
        `leaf_coded` runs the leaf as `interp_float_coded` over the
        shared tape.

        Differentiable in `var_vec` (a tensor on the render device):
        reverse mode (`backward()`, `torch.func.grad`) and forward mode
        (`torch.func.jvp` / `jacfwd`, `torch.autograd.forward_ad`). Only
        evaluated pixels carry a derivative; proven fills carry none
        (0). The coded leaf has no derivative and raises."""
        dev = self.device
        return _frame_core(
            self._bind(leaf_coded), self.T0, self.T1, self.n0x,
            self._x0, self._y0,
            torch.as_tensor(mat, dtype=torch.float32, device=dev),
            torch.tensor(z, dtype=torch.float32, device=dev),
            torch.as_tensor(var_vec, dtype=torch.float32, device=dev),
            pixel_perfect=pixel_perfect, stop_after=stop_after,
            stage_hook=stage_hook,
        )

    def _mat4(self, world_to_model: np.ndarray | None) -> np.ndarray:
        """Combined (px, py, z, 1) -> model 4x4: screen->world 3x3, the
        optional world->model view, then the shape's own transform."""
        m = mat3_to_mat4(compose2(world_to_model, self.size))
        if self.shape_transform is not None:
            m = self.shape_transform @ m
        return m.astype(np.float32)

    def _var_vec(self, vars) -> np.ndarray:
        """Dense per-input value vector from ShapeVars or a {Var: value}
        mapping (axes are filled by the transform stages and ignored
        here)."""
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
        vars: ShapeVars | dict | None = None,
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
        vars: ShapeVars | dict | None = None,
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
    tape: Tape | Shape,
    image_size: ImageSize,
    *,
    world_to_model: np.ndarray | None = None,
    z: float = 0.0,
    vars: ShapeVars | dict | None = None,
    tile_size: int | None = None,
    tile_sizes: tuple | None = None,
    pixel_perfect: bool = False,
    device=None,
) -> Image2D:
    """One-shot 2D render (mirrors fidget_raster::pixel::render)."""
    r = PixelRenderer(
        tape, image_size, tile_size=tile_size, tile_sizes=tile_sizes,
        device=device,
    )
    return r.render(
        world_to_model, z=z, vars=vars, pixel_perfect=pixel_perfect
    )
