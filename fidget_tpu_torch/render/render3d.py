"""Level-synchronous 3D voxel renderer (heightmap + normals).

The counterpart of `fidget_tpu.render.render3d`. A frame is:

1. **Root interval pass** — one `interp_interval` launch (K1) whose
   lanes are the `ts`^3 root tiles; tiles prove full, empty or stay
   active. K2 (`liveness_codes`) over the shared tape and `reconstruct`
   give one simplified tape per root tile.
2. **Z-strata, front to back** — a Python loop over root-tile layers,
   nearest first, carrying the per-pixel depth floor (the counterpart
   of the reference's `lax.scan`, enqueued on the device stream
   without reading anything back). Per stratum:
   a. subtile interval pass with the slab's simplified tapes (K1, one
      instance per slab tile, S0 = 1 at the default geometry);
   b. occlusion: subtiles whose top lies at or below the floor built
      by nearer strata are dropped;
   c. stable compaction of the survivors, nearest first, into a
      worklist of `cap` slots (`torch.argsort(stable=True)`);
   d. per-subtile re-specialization: K2 over the slab's per-tile tapes
      (`per_instance_codes`) and `reconstruct`;
   e. voxel pass: K5 (`interp_voxel_depth`, lanes = a subtile's
      voxels, fused per-column depth) when sub^2 % 128 == 0, else K3
      and a torch reduction; hits fold into the floor.
3. **Normals** — K4 (`interp_grad`) over every pixel at its surface
   voxel, seeded with the world-frame Jacobian (`transform_duals`).
   Saturated pixels (depth == D) get [0, 0, 1].

Two tape bindings run this pipeline, as in 2D (render2d.py):

- `_ConstBind3` — `VoxelRenderer(specialize=True)`, the default: the
  arena packed at the tape's own length under the shape's
  `frequency_op_order`, every K1 / K2 / `reconstruct` / K3 / K5 / K4
  call under that order, K1 and K2 at the tape's own register file
  and choice words. `render()` sizes the worklist per stratum after
  its first settled frame (`strata_schedule`, from host interval
  counts), clamped to the settled uniform cap and kept only if it
  saves slots.
- `_TracedBind` — `specialize=False`: the canonical bucket, the arena
  as data (Lcap, nf and choice words rounded up to the bucket).

On the per-shape binding, `leaf="unrolled"` replaces steps 2d-2e and the
fold by U1-3D (`unrolled_voxel_fold`): the whole tape, generated for this
shape as straight-line CUDA, over the worklist's voxels, with no
per-subtile tapes; it reads the stratum's compacted worklist and count
on the device and folds each column's depth into the floor itself.
`proofs="unrolled"` (which needs the unrolled leaf) replaces the
interval passes of steps 1 and 2a by one launch of U2-3D a frame
(`unrolled_proofs3`: the root tiles and every subtile of them; each
stratum takes its part as a view) and skips every simplification.
Normals stay K4 over the whole tape under the shape's order in every
mode (the reference takes three `jax.jvp` passes over its straight-line
XLA there: forward duals either way).
`render(warmup="interp")` serves frames from a bucketed twin while the
generated kernels build in the background (the build keys hash the
tape's contents, so no tape is pinned against a recycled `id()`).

The one host read per frame is the active-subtile count after the last
stratum (with a schedule: the largest overflow); when it exceeds the
worklist, `render()` retries once with a sufficient power-of-two
capacity (or drops the schedule). On CUDA every kernel is hand-written
(fidget_tpu_torch/csrc, and the generated ones from csrc/unrolled.cuh);
on the CPU the plain PyTorch versions run. The reference's `strata=`
drivers and `voxel_tiles_per_step=` (XLA dispatch and Pallas grid-step
choices) are not ported. `_frame_tiles` runs the frame over a y-slab
of root tiles, the slab entry point of `parallel.sharding`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..compiler.pack import frequency_op_order, pack_tapes
from ..compiler.tape import Tape
from ..eval.arith import FloatMode, GradMode, IntervalMode
from ..eval.cuda import resolve_device
from ..eval.interp import (
    interp_float,
    interp_grad,
    interp_interval,
    interp_voxel_depth,
    tape_n_ops,
)
from ..eval.simplify_device import (
    DeviceSimplifier,
    per_instance_codes,
    reconstruct,
    unpack_codes,
)
from ..eval.unrolled import eval_tape
from ..eval.unrolled_cuda import (
    Interval3Kernel,
    VoxelKernel,
    fold_candidates,
    params_tensor,
    proofs3_warps,
    unrolled_proofs3,
    unrolled_voxel_fold,
    worklist_corners,
)
from ..shape import Shape, ShapeVars
from ..utils import span
from .config import check_cancel
from .region import VoxelSize
from .render2d import _ceil_to, _ConstBind, _pad_plane, _TracedBind
from .transform import transform_duals, transform_intervals, transform_points
from .unrolled2d import ready


#: voxels per z-slab of `render_brute` (about 4M: at 512^2 a slab is
#: 16 slices, and every register of the numpy walk is 16 MB)
BRUTE_SLAB_VOXELS = 1 << 22


@dataclass
class Image3D:
    """Output of the 3D renderer, on the render device.

    depth: int32 [H, W]; 0 = empty, else surface voxel z + 1
      (== VoxelSize.depth means saturated).
    normal: f32 [H, W, 3] unit world-frame normals (zero where empty,
      [0, 0, 1] where saturated); None in heightmap mode.
    """

    depth: torch.Tensor
    normal: torch.Tensor | None


class _ConstBind3(_ConstBind):
    """Tape binding of the per-shape 3D pipeline: the arena packed at the
    tape's own length under the shape's `frequency_op_order`; root codes
    (K2 through `DeviceSimplifier.codes_per_tile`) and root
    simplification (`reconstruct`) as the 2D `_ConstBind` makes them,
    under that order; K1 and K2 at the tape's own register file and
    choice words. Under the unrolled modes it carries the kernels
    generated for the tape (U1-3D for the leaf, U2-3D for the
    proofs)."""

    def __init__(self, r):
        self.rend = r
        self.arena = r._arena_s
        self.axis_idx = [int(i) for i in r.axis_idx]
        self.nf, self.V = r.nf, r.n_inputs
        self.nf_regs = r._nf_regs
        self.c_words = r.c_words
        self.op_order = r.op_order
        self.leaf, self.proofs = r.leaf, r.proofs
        self.voxel_kernel = r._voxel_kernel if r.leaf == "unrolled" else None
        self.interval_kernel = (
            r._interval3_kernel if r.proofs == "unrolled" else None
        )


def _compact_stratum(act_flat, *, nl, ny2, nx2, cap_s, decode=True):
    """Nearest-first stable compaction of a stratum's active flags into
    a worklist of cap_s slots: the selection order (every active subtile
    first), and unless `decode` is False its validity mask and the
    decoded (lz, gy, gx) slab-local subtile coordinates, all int64
    (gather indices). U1-3D's frame entry decodes the order itself."""
    lz_f = torch.arange(act_flat.shape[0], device=act_flat.device) // (ny2 * nx2)
    key = torch.where(act_flat, nl - lz_f, 1 << 30)
    order = torch.argsort(key, stable=True)[:cap_s]
    if not decode:
        return dict(order=order)
    rem = order % (ny2 * nx2)
    return dict(
        order=order,
        valid=act_flat[order],
        lz=order // (ny2 * nx2),
        gy=rem // nx2,
        gx=rem % nx2,
    )


@functools.lru_cache(maxsize=32)
def _geo3(W: int, H: int, D: int, ts: int, sub: int) -> "_Pipeline3":
    return _Pipeline3(W, H, D, ts, sub)


class _Pipeline3:
    """Geometry and pipeline for one (volume size, tile config): every
    static that does not depend on the shape's tape, shared by all
    renderers of that geometry."""

    def __init__(self, W: int, H: int, D: int, ts: int, sub: int):
        if ts % sub:
            raise ValueError("tile_size must be a multiple of sub_size")
        if W % ts or H % ts or D % ts:
            raise ValueError("volume extents must be multiples of tile_size")
        self.W, self.H, self.D = W, H, D
        self.ts, self.sub = ts, sub
        self.ntx, self.nty, self.ntz = W // ts, H // ts, D // ts
        self.nt = self.ntx * self.nty * self.ntz
        self.nl = ts // sub                        # subtiles per tile edge
        self.m = self.nl**3                        # subtiles per root tile
        self.nx2, self.ny2, self.nz2 = W // sub, H // sub, D // sub
        self.nsub = self.nx2 * self.ny2 * self.nz2
        self.s0s = max(1, -(-self.m // 128))                   # subtile pass
        self.s0v = max(1, -(-sub**3 // 128))                   # voxel pass

        # root-tile corners, (tz, ty, tx) row-major
        tzz, tyy, txx = np.meshgrid(
            np.arange(self.ntz), np.arange(self.nty), np.arange(self.ntx),
            indexing="ij",
        )
        self.tables = {
            "tile_x0": txx.reshape(-1) * ts,
            "tile_y0": tyy.reshape(-1) * ts,
            "tile_z0": tzz.reshape(-1) * ts,
        }
        # subtile offsets within a root tile, (lz, ly, lx) row-major
        lz, ly, lx = np.meshgrid(*[np.arange(self.nl)] * 3, indexing="ij")
        self.tables.update(
            sub_dx=lx.reshape(-1) * sub, sub_dy=ly.reshape(-1) * sub,
            sub_dz=lz.reshape(-1) * sub,
        )
        # voxel offsets within a subtile, (vz, vy, vx) row-major
        vz, vy, vx = np.meshgrid(*[np.arange(sub)] * 3, indexing="ij")
        self.tables.update(
            vox_dx=vx.reshape(-1), vox_dy=vy.reshape(-1), vox_dz=vz.reshape(-1)
        )
        self.s2w = VoxelSize(W, H, D).screen_to_world()
        self.tables["s2w"] = self.s2w
        self._on: dict[torch.device, dict] = {}

    def statics(self, device: torch.device) -> dict:
        """f32 device copies of the coordinate tables, made once per
        device."""
        st = self._on.get(device)
        if st is None:
            st = self._on[device] = {
                k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                for k, v in self.tables.items()
            }
        return st

    @staticmethod
    def s0n_of(nf: int) -> int:
        """Normals-pass lane block, as the reference sizes it (its VMEM
        budget for four dual register files), so the two agree lane for
        lane."""
        budget = 8 * 2**20
        s0n = budget // (max(1, nf) * 4 * 128 * 4)
        return int(max(8, min(64, 1 << max(3, s0n.bit_length() - 1))))

    # ------------------------------------------------------------------

    def interval_vars(self, b, im, mat, var_vec, xi, yi, zi, s0, lead):
        """[lead..., V, s0, 128] interval var planes from screen interval
        triples of shape [lead..., K]."""
        mxi, myi, mzi = transform_intervals(im, mat, xi, yi, zi)
        V = b.V
        var_lo = var_vec.reshape((1,) * len(lead) + (V, 1, 1)).expand(
            lead + (V, s0, 128)
        )
        triples = [
            (
                _pad_plane(torch.broadcast_to(ivl[0], xi[0].shape), s0),
                _pad_plane(torch.broadcast_to(ivl[1], xi[0].shape), s0),
            )
            for ivl in (mxi, myi, mzi)
        ]
        return b.set_axes((var_lo, var_lo), triples)

    def point_vars(self, b, mat, var_vec, px, py, pz, s0, lead):
        mx, my, mz = transform_points(mat, px, py, pz)
        V = b.V
        vars_ = var_vec.reshape((1,) * len(lead) + (V, 1, 1)).expand(
            lead + (V, s0, 128)
        )
        triples = [
            (_pad_plane(torch.broadcast_to(p, px.shape), s0),)
            for p in (mx, my, mz)
        ]
        (vars_,) = b.set_axes((vars_,), triples)
        return vars_

    # ------------------------------------------------------------------

    def frame(
        self, b, st, mat, matM, var_vec, *, mode: str, cap: int,
        stop_after: str | None = None, cancel=None, stage_hook=None,
        strata_caps: tuple | None = None, tiles=None,
    ):
        """One frame: returns (depth, normal, n_active) on the device,
        n_active being the largest active-subtile count of any stratum,
        or with `strata_caps` (a cap per stratum, nearest first) the
        largest overflow (count - cap, 0 = every stratum fit). `mat` is
        screen -> model, `matM` world -> model (both [4, 4]).
        `stop_after` ("root" | "simplify") returns that stage's
        intermediates, as the reference's `frame_tiles` does (under
        unrolled proofs "root" gives the proofs (full, empty, None));
        `stage_hook(name)` is called as each stage is enqueued.

        `tiles` (x0, y0, z0) are the global corners of a y-slab of root
        tiles in (tz, ty, tx) row-major order, covering all of Z and X
        and `nt / (ntz * ntx)` tile rows (None: the whole image). The
        result's rows are the slab's; its first global row, `y_base`,
        enters the voxel coordinates of the leaf and the normals, as in
        the reference's `frame_tiles`. It is read on the host, once a
        slab frame; a whole frame adds nothing."""
        hook = stage_hook if stage_hook is not None else (lambda name: None)
        ts, nl = self.ts, self.nl
        im = IntervalMode(torch)
        if tiles is None:
            tiles = st["tile_x0"], st["tile_y0"], st["tile_z0"]
        x0, y0, z0 = tiles
        nt = x0.shape[0]
        nty = nt // (self.ntz * self.ntx)
        if nty * self.ntz * self.ntx != nt:
            raise ValueError("tiles must cover whole rows of every stratum")
        H, ny2 = nty * ts, nty * nl       # the slab's rows, subtile rows
        y_base = 0.0 if tiles is None else float(y0.min())  # first row
        s0r = max(8, _ceil_to(-(-nt // 128), 8))
        unrolled_proofs = getattr(b, "proofs", "interp") == "unrolled"
        params = None
        if unrolled_proofs or getattr(b, "leaf", "interp") == "unrolled":
            params = params_tensor(mat, mat.new_zeros(()), var_vec)

        # ---- stage 1: root interval pass (lanes = root tiles) ---------
        # (under unrolled proofs: U2-3D proves the roots and every
        # subtile of them in one launch, [nt, 1 + m], column 0 the roots;
        # the subtiles' proofs need neither the floor nor the roots', and
        # each stratum takes its part as a view)
        if unrolled_proofs:
            proofs = unrolled_proofs3(b.interval_kernel, x0, y0, z0, params,
                                      ts, self.sub)
            root_full, root_empty = proofs[0][:, 0], proofs[1][:, 0]
            root_out = (root_full, root_empty, None)
        else:
            var_lo, var_hi = self.interval_vars(
                b, im, mat, var_vec, (x0, x0 + ts), (y0, y0 + ts),
                (z0, z0 + ts), s0r, (1,),
            )
            w1r, w2r, immr, lensr = b.arena
            olo, ohi, choices0 = interp_interval(
                w1r, w2r, immr, lensr, var_lo, var_hi, nf=b.nf,
                n_inputs=b.V, n_outputs=1, s0=s0r, c_words=b.c_words,
                op_order=b.op_order,
            )
            rlo = olo[0, 0].reshape(-1)[:nt]
            rhi = ohi[0, 0].reshape(-1)[:nt]
            root_full, root_empty = rhi < 0.0, rlo > 0.0
            root_out = (rlo, rhi, choices0)
        root_active = ~(root_full | root_empty)
        hook("root")
        if stop_after == "root":
            return root_out

        # ---- stage 2: per-root-tile simplification --------------------
        # (none under unrolled proofs: no choices are captured, and the
        # leaf evaluates the whole tape)
        if not unrolled_proofs:
            w1s, w2s, imms, lens = b.simplify_root(b.root_codes(choices0, nt))
            hook("simplify")
            if stop_after == "simplify":
                return w1s, w2s, lens

        # ---- stage 3: Z-strata, front to back --------------------------
        ntxy = nty * self.ntx
        nsub_s = nl * ny2 * self.nx2
        if strata_caps is None:
            caps = [min(cap, nsub_s)] * self.ntz
        else:
            if len(strata_caps) != self.ntz:
                raise ValueError(f"strata_caps needs {self.ntz} entries")
            caps = [min(int(c), nsub_s) for c in strata_caps]

        def slab_of(a):
            """[nt, ...] (tz, ty, tx)-major -> [ntz, ntxy, ...] (tz-major:
            stratum k, nearest first, is tz = ntz - 1 - k), a view."""
            return a.reshape((self.ntz, ntxy) + a.shape[1:])

        xs = dict(
            x0=slab_of(x0), y0=slab_of(y0), z0=slab_of(z0),
            act=slab_of(root_active), full=slab_of(root_full),
        )
        if unrolled_proofs:
            xs.update(sub_full=slab_of(proofs[0][:, 1:]),
                      sub_empty=slab_of(proofs[1][:, 1:]))
        else:
            xs.update(
                w1s=slab_of(w1s), w2s=slab_of(w2s), imms=slab_of(imms),
                lens=slab_of(torch.where(root_active, lens, 0)),
            )
        unrolled_leaf = getattr(b, "leaf", "interp") == "unrolled"
        # a fresh tensor: no other aliases it (nor do the torch.maximum
        # results that replace it in stratum_proofs), so U1-3D's frame
        # entry may fold into it in place
        floor = torch.zeros((H, self.W), dtype=torch.int32, device=x0.device)
        counts = []
        for k, cap_s in enumerate(caps):
            check_cancel(cancel)
            s = {key: v[self.ntz - 1 - k] for key, v in xs.items()}
            floor, aux = self.stratum_proofs(b, st, floor, s, mat=mat,
                                             var_vec=var_vec, nty=nty)
            hook("proofs")
            idx = _compact_stratum(
                aux["act_flat"], nl=nl, ny2=ny2, nx2=self.nx2,
                cap_s=cap_s, decode=not unrolled_leaf,
            )
            hook("compact")
            if unrolled_leaf:
                # U1-3D reads the worklist and its count on the device and
                # folds each column's depth into the floor (in place)
                unrolled_voxel_fold(
                    b.voxel_kernel, idx["order"], aux["n_active"],
                    aux["z_lo"], params, floor, sub=self.sub, nl=nl,
                    y_base=y_base,
                )
                hook("voxel")
            else:
                dcand = self.stratum_leaf(
                    b, st, s, aux, idx, mat=mat, var_vec=var_vec,
                    cap_s=cap_s, y_base=y_base, hook=hook,
                )
                floor = fold_candidates(floor, dcand, idx["order"],
                                        idx["valid"], nl=nl)
            hook("fold")
            counts.append(aux["n_active"] if strata_caps is None
                          else (aux["n_active"] - cap_s).clamp(min=0))
        n_active = torch.stack(counts).max()
        if mode == "heightmap":
            return floor, None, n_active
        check_cancel(cancel)
        normal = self.normals_body(b, st, floor, matM, var_vec, y_base=y_base)
        hook("normals")
        return floor, normal, n_active

    def stratum_proofs(self, b, st, floor, s, *, mat, var_vec, nty):
        """Stratum stage A: root-full fold, subtile interval pass (K1 with
        the slab's simplified tapes; under unrolled proofs the stratum's
        part of U2-3D's frame proofs, `s["sub_full"]` / `s["sub_empty"]`),
        proof-driven fulls and occlusion against the floor, over a
        stratum of `nty` tile rows. Returns (floor', aux) with the active
        flags, their count, the packed choices (None under unrolled
        proofs) and the stratum's z base."""
        ts, sub, nl, m = self.ts, self.sub, self.nl, self.m
        ntx, nx2 = self.ntx, self.nx2
        ny2 = nty * nl
        i32 = torch.int32
        im = IntervalMode(torch)
        x0s, y0s, z0s = s["x0"], s["y0"], s["z0"]
        acts = s["act"][:, None]                      # [ntxy, 1]

        # root-full proofs of this slab fill their whole footprint
        full_px = torch.where(s["full"], z0s + ts, 0.0).reshape(nty, ntx)
        full_px = full_px.to(i32).repeat_interleave(ts, 0).repeat_interleave(ts, 1)
        floor = torch.maximum(floor, full_px)

        # subtile interval pass with the slab's simplified tapes
        if "sub_full" in s:
            full, empty = s["sub_full"], s["sub_empty"]   # [ntxy, m]
            choices1 = None
        else:
            sx0 = x0s[:, None] + st["sub_dx"][None, :]   # [ntxy, m]
            sy0 = y0s[:, None] + st["sub_dy"][None, :]
            sz0 = z0s[:, None] + st["sub_dz"][None, :]
            var_lo1, var_hi1 = self.interval_vars(
                b, im, mat, var_vec, (sx0, sx0 + sub), (sy0, sy0 + sub),
                (sz0, sz0 + sub), self.s0s, (nty * ntx,),
            )
            olo1, ohi1, choices1 = interp_interval(
                s["w1s"], s["w2s"], s["imms"], s["lens"], var_lo1, var_hi1,
                nf=b.nf, n_inputs=b.V, n_outputs=1, s0=self.s0s,
                c_words=b.c_words, op_order=b.op_order,
            )
            full = ohi1[:, 0].reshape(nty * ntx, -1)[:, :m] < 0.0
            empty = olo1[:, 0].reshape(nty * ntx, -1)[:, :m] > 0.0
        sub_full = acts & full
        sub_active = acts & ~full & ~empty

        def to_dense(flags):
            """[ntxy, m] -> [nl(z), ny2, nx2] slab-local grid."""
            g = flags.reshape(nty, ntx, nl, nl, nl)
            return g.permute(2, 0, 3, 1, 4).reshape(nl, ny2, nx2)

        z_lo = z0s[0]  # slab z base (shared by all slab tiles)
        lz_col = torch.arange(nl, dtype=i32, device=floor.device)[:, None, None]
        sub_top = z_lo.to(i32) + lz_col * sub + sub

        # proof-driven fulls at subtile granularity (a new floor tensor,
        # as above: nothing else aliases it)
        proof_sub = torch.where(to_dense(sub_full), sub_top, 0).amax(0)
        floor = torch.maximum(
            floor, proof_sub.repeat_interleave(sub, 0).repeat_interleave(sub, 1)
        )

        # occlusion: a subtile is dead if its top is at or below the
        # floor everywhere in its footprint
        floor_min = floor.reshape(ny2, sub, nx2, sub).amin((1, 3))
        act_flat = (to_dense(sub_active) & (sub_top > floor_min[None])).reshape(-1)
        aux = dict(
            act_flat=act_flat, n_active=act_flat.sum(), z_lo=z_lo,
            choices1=choices1,
        )
        return floor, aux

    def stratum_leaf(self, b, st, s, aux, idx, *, mat, var_vec, cap_s, hook,
                     y_base):
        """Stratum stage B (the interpreter leaf): gather the worklist's
        parent tapes, re-specialize them per subtile from the packed
        choices, and run the voxel pass. The worklist's rows are the
        slab's; `y_base` (a float) is the slab's first global row.
        Returns depth candidates [cap_s, sub, sub]."""
        sub, nl = self.sub, self.nl
        i32 = torch.int32
        lz, gy, gx, valid = idx["lz"], idx["gy"], idx["gx"], idx["valid"]

        # voxel coordinates of the worklist, (vz, vy, vx) row-major
        bx, by, bz = (c[:, None] for c in worklist_corners(
            lz, gy, gx, aux["z_lo"], sub=sub, y_base=y_base))
        px = bx + st["vox_dx"][None, :]
        py = by + st["vox_dy"][None, :]
        pz = bz + st["vox_dz"][None, :]

        t_idx = (gy // nl) * self.ntx + (gx // nl)
        perlane = per_instance_codes(
            s["w1s"], s["w2s"], s["lens"], aux["choices1"], nf=b.nf,
            op_order=b.op_order,
        )  # [ntxy, s0s * 128, lw]
        k_local = ((lz % nl) * nl + (gy % nl)) * nl + (gx % nl)
        codes = unpack_codes(perlane[t_idx, k_local], s["w1s"].shape[1])
        w1_leaf, w2_leaf, imm_leaf, len_leaf, _ = reconstruct(
            s["w1s"][t_idx], s["w2s"][t_idx], s["imms"][t_idx], codes,
            op_order=b.op_order,
        )
        len_leaf = torch.where(valid, len_leaf, 0)
        hook("respecialize")

        vars_v = self.point_vars(b, mat, var_vec, px, py, pz, self.s0v, (cap_s,))
        bz_i = bz.to(i32)
        if sub * sub % 128 == 0:
            pp = (sub * sub) // 128
            local = interp_voxel_depth(
                w1_leaf, w2_leaf, imm_leaf, len_leaf, vars_v, nf=b.nf_regs,
                n_inputs=b.V, s0=self.s0v, sub=sub, op_order=b.op_order,
            )[:, :pp].reshape(cap_s, sub, sub)
            dcand = torch.where(
                (local > 0) & valid[:, None, None], bz_i[..., None] + local, 0
            )
        else:
            dv = interp_float(
                w1_leaf, w2_leaf, imm_leaf, len_leaf, vars_v, nf=b.nf,
                n_inputs=b.V, n_outputs=1, s0=self.s0v, op_order=b.op_order,
            )[:, 0].reshape(cap_s, -1)[:, : sub**3]
            inside = ((dv < 0.0) & valid[:, None]).reshape(cap_s, sub, sub, sub)
            vz_col = torch.arange(sub, dtype=i32, device=dv.device)[None, :, None, None]
            dcand = torch.where(
                inside, bz_i[..., None, None] + vz_col + 1, 0
            ).amax(1)
        hook("voxel")
        return dcand

    def normals_body(self, b, st, depth, matM, var_vec, *, y_base):
        """Per-pixel forward-gradient normals at the surface voxels
        (voxel.rs:447-482): K4 over `Tn` instances of the whole tape,
        under the binding's opcode order in every leaf mode. The lanes
        are split as the reference splits them for the binding's nf (the
        bucket's, or the tape's own); K4 itself gets the tape's
        registers. `depth` holds a slab's rows, the first of them the
        global row `y_base` (a float)."""
        (H, W), D = depth.shape, self.D
        dev = depth.device
        f32 = torch.float32
        s0n = self.s0n_of(b.nf)
        npix = H * W
        lanes = _ceil_to(npix, s0n * 128)
        Tn = lanes // (s0n * 128)
        dflat = depth.reshape(-1)

        def padl(a):
            return torch.nn.functional.pad(a, (0, lanes - npix)).reshape(
                Tn, s0n, 128
            )

        px = padl(torch.arange(W, dtype=f32, device=dev).repeat(H))
        rows = torch.arange(H, dtype=f32, device=dev).repeat_interleave(W)
        py = padl(rows + y_base if y_base else rows)
        pz = padl((dflat - 1).to(f32))
        s2w = st["s2w"]
        wx = s2w[0, 0] * px + s2w[0, 3]
        wy = s2w[1, 1] * py + s2w[1, 3]
        wz = s2w[2, 2] * pz + s2w[2, 3]
        V = b.V
        comp0 = var_vec.reshape(1, V, 1, 1).expand(Tn, V, s0n, 128)
        zeros = torch.zeros((Tn, V, s0n, 128), dtype=f32, device=dev)
        planes = b.set_axes(
            (comp0, zeros, zeros, zeros), transform_duals(matM, wx, wy, wz)
        )
        vars_n = torch.stack(planes, dim=2)  # [Tn, V, 4, s0n, 128]
        w1r, w2r, immr, lensr = b.arena
        g = interp_grad(
            w1r.expand(Tn, -1).contiguous(), w2r.expand(Tn, -1).contiguous(),
            immr.expand(Tn, -1).contiguous(), lensr.expand(Tn).contiguous(),
            vars_n, nf=b.nf_regs, n_inputs=V, n_outputs=1, s0=s0n,
            op_order=b.op_order,
        )[:, 0]  # [Tn, 4, s0n, 128]
        grads = g.reshape(Tn, 4, s0n * 128).transpose(1, 2).reshape(-1, 4)
        grads = grads[:npix, 1:4]
        norm = torch.linalg.vector_norm(grads, dim=1, keepdim=True)
        normal = torch.where(norm > 0, grads / norm, 0.0)
        normal = torch.where(dflat[:, None] > 0, normal, 0.0)
        up = torch.tensor([0.0, 0.0, 1.0], dtype=f32, device=dev)
        normal = torch.where(dflat[:, None] >= D, up, normal)
        return normal.reshape(H, W, 3)


class VoxelRenderer:
    """3D renderer for one shape at one volume size.

    Args:
      tape: register tape or Shape (single output); a Shape's transform
        composes in front of every view.
      size: volume size in voxels; all extents must be multiples of
        `tile_size`.
      tile_size: root tile edge in voxels (default 64).
      sub_size: leaf subtile edge (default 16); sub_size**3 voxels are
        the lanes of one voxel-pass instance.
      cap: worklist slots per stratum (None = one per subtile column,
        at least 256, rounded up to a power of two); an overflow
        retries once at a sufficient capacity.
      specialize: True (the default) runs the per-shape pipeline
        (`_ConstBind3`: the arena at the tape's own length under the
        shape's `frequency_op_order`, per-stratum capacity schedules
        after the first settled frame). False runs the bucketed one
        (`_TracedBind`: the canonical bucket, the arena as data).
      leaf: "interp" (default) re-specializes each subtile's tape and
        runs the interpreter over its voxels (K5, or K3 when sub^2 %
        128 != 0). "unrolled" runs U1-3D, the whole tape generated for
        this shape as straight-line CUDA, over the worklist's voxels,
        with no per-subtile tapes. Requires specialize=True.
      proofs: "interp" (default) runs the root and subtile interval
        passes through K1 with choice capture and simplification.
        "unrolled" runs U2-3D (the tape's generated interval code) over
        the boxes and skips simplification entirely. Requires
        leaf="unrolled".
      device: render device; None means CUDA, and raises when there is
        no card. Pass "cpu" to run the plain PyTorch versions.

    The reference's `strata=` (XLA dispatch drivers: the strata here are
    always a Python loop that polls the CancelToken between strata) and
    `voxel_tiles_per_step=` (a Pallas grid-step knob; K5's CUDA launch
    has its own blocks) are not taken.
    """

    @span("fidget.renderer.init")
    def __init__(
        self,
        tape: Tape | Shape,
        size: VoxelSize,
        *,
        tile_size: int = 64,
        sub_size: int = 16,
        cap: int | None = None,
        specialize: bool = True,
        leaf: str = "interp",
        proofs: str = "interp",
        device=None,
    ):
        if leaf not in ("interp", "unrolled"):
            raise ValueError(f"leaf must be 'interp' or 'unrolled', not {leaf!r}")
        if proofs not in ("interp", "unrolled"):
            raise ValueError(
                f"proofs must be 'interp' or 'unrolled', not {proofs!r}"
            )
        if leaf == "unrolled" and not specialize:
            raise ValueError(
                "leaf='unrolled' generates kernels for this tape and "
                "requires specialize=True (the bucketed pipeline treats "
                "tapes as data)"
            )
        if proofs == "unrolled" and leaf != "unrolled":
            raise ValueError(
                "proofs='unrolled' captures no choice traces, so the "
                "interpreter leaf (which re-specializes tapes from them) "
                "cannot follow it; use leaf='unrolled' too"
            )
        self.device = resolve_device(device)
        self.specialize = bool(specialize)
        self.leaf, self.proofs = leaf, proofs
        self.shape_transform = None
        if isinstance(tape, Shape):
            self.shape_transform = tape.transform
            tape = tape.tape()
        if tape.output_count != 1:
            raise ValueError("3D rendering expects a single output")
        self.tape = tape
        self.size = size
        self.ts, self.sub = tile_size, sub_size
        self.geo = _geo3(size.width, size.height, size.depth, tile_size, sub_size)
        g = self.geo
        self.W, self.H, self.D = g.W, g.H, g.D
        self.ntz, self.nl, self.nx2, self.ny2 = g.ntz, g.nl, g.nx2, g.ny2
        self.nsub = g.nsub
        self.s2w = g.s2w
        if cap is None:
            cap = max(256, g.nx2 * g.ny2)
        self.cap = min(1 << (int(cap) - 1).bit_length(), self.nsub)
        #: per-stratum capacity schedule, nearest first (built after the
        #: first settled per-shape frame when it saves slots; None =
        #: the uniform cap)
        self._sched = None
        self._sched_checked = False

        self.nf = tape.reg_count + tape.mem_count
        # K4 and K5 get the registers the tape names (child tapes keep
        # the parent's register indices), as 2D's value kernels do; K1
        # and K2 the binding's nf (the bucket's nf_b, or the tape's own)
        self._nf_regs = self.nf
        # padded to >= 1 so constant-only shapes still build var planes
        self.n_inputs = max(1, len(tape.var_map))
        self.c_words = max(1, -(-tape.choice_count // 16))
        self.axis_of = {v.kind: i for v, i in tape.var_map.items()}
        # bucketed dims (canonical op order), as the reference sizes them
        self.Lcap_b = max(64, 1 << (len(tape) - 1).bit_length())
        self.nf_b = _ceil_to(max(self.nf, 64), 64)
        self.cw_b = max(1, 1 << (self.c_words - 1).bit_length())
        self.packed_b = pack_tapes([tape], capacity=self.Lcap_b)
        self.axis_idx = np.array(
            [-1 if self.axis_of.get(k) is None else self.axis_of[k]
             for k in ("x", "y", "z")],
            np.int32,
        )
        p = self.packed_b
        self._arena = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (p.w1, p.w2, p.imm, p.lengths)
        )
        # the per-shape arena, simplifier and generated kernels are
        # built lazily: the bucketed path never needs them
        self._op_order = None
        self._packed = None
        self._arena_s_dev = None
        self._simplifier = None

    # ------------------------------------------------------------------
    # the per-shape binding's artifacts

    @property
    def op_order(self):
        """Per-shape opcode renumbering: position -> canonical op, this
        shape's most frequent ops first."""
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

    @functools.cached_property
    def _voxel_kernel(self) -> VoxelKernel:
        """U1-3D for this tape (the unrolled leaf)."""
        return VoxelKernel(self.tape, self.axis_of, self.n_inputs)

    @functools.cached_property
    def _interval3_kernel(self) -> Interval3Kernel:
        """U2-3D for this tape (the unrolled proofs), its layout fixed by
        the frame's box count (roots and their subtiles)."""
        g = self.geo
        return Interval3Kernel(self.tape, self.axis_of, self.n_inputs,
                               warps=proofs3_warps(g.nt * (1 + g.m)))

    def _generated_kernels(self) -> list:
        """The kernels generated for this tape that the frames run."""
        kernels = []
        if self.leaf == "unrolled":
            kernels.append(self._voxel_kernel)
        if self.proofs == "unrolled":
            kernels.append(self._interval3_kernel)
        return kernels

    # ------------------------------------------------------------------

    def _bind(self):
        if self.specialize:
            return _ConstBind3(self)
        return _TracedBind(
            *self._arena, self.axis_idx, self.Lcap_b, self.nf_b,
            self.n_inputs, self.cw_b, nf_regs=self._nf_regs,
        )

    def _mat4(self, world_to_model) -> np.ndarray:
        """World -> model 4x4 (f32), the shape's transform included."""
        m = np.eye(4) if world_to_model is None else np.asarray(
            world_to_model, np.float64
        )
        if m.shape != (4, 4):
            raise ValueError("3D world-to-model must be a 4x4 homogeneous")
        if self.shape_transform is not None:
            m = self.shape_transform @ m
        return m.astype(np.float32)

    def _screen_mat(self, matM: np.ndarray) -> np.ndarray:
        """Screen -> model 4x4, formed on the host in f32 exactly as
        `render_brute` forms it, so both transform voxels identically."""
        return matM @ self.s2w.astype(np.float32)

    def _var_vec(self, vars) -> np.ndarray:
        vec = np.zeros(self.n_inputs, np.float32)
        if vars is not None:
            for v, val in vars.items():
                idx = self.tape.var_map.get(v)
                if idx is not None:
                    vec[idx] = np.float32(val)
        missing = [
            v for v in self.tape.var_map
            if v.kind == "v" and (vars is None or v not in vars)
        ]
        if missing:
            raise ValueError(f"unbound shape variables: {missing}")
        return vec

    def _frame(self, matM, vec, *, mode="normals", cap=None, stop_after=None,
               cancel=None, stage_hook=None, strata_caps=None, tiles=None):
        """One frame from host inputs: `matM` the [4, 4] world -> model
        f32 matrix (`_mat4`), `vec` the [V] variable values. With
        `strata_caps` (a cap per stratum, nearest first) the third
        result is the largest overflow, else the largest count. `tiles`
        restricts the frame to a y-slab of root tiles (`_frame_tiles`)."""
        dev = self.device
        return self.geo.frame(
            self._bind(), self.geo.statics(dev),
            torch.from_numpy(self._screen_mat(matM)).to(dev),
            torch.from_numpy(matM).to(dev), torch.from_numpy(vec).to(dev),
            mode=mode, cap=self.cap if cap is None else cap,
            stop_after=stop_after, cancel=cancel, stage_hook=stage_hook,
            strata_caps=strata_caps, tiles=tiles,
        )

    def _frame_tiles(self, matM, vec, x0, y0, z0, *, mode, cap,
                     strata_caps=None, stop_after=None):
        """The frame over a y-slab of root tiles under this renderer's
        binding: `x0` / `y0` / `z0` are the global tile corners (f32
        tensors on the render device) in (tz, ty, tx) row-major order,
        covering all of Z and X and some whole tile rows; `matM` and
        `vec` are host inputs as `_frame` takes them. The slab entry point
        that `parallel.sharding` runs over each rank's tile rows. Returns
        the slab's (depth, normal, n_active); its rows are the slab's,
        and equal the same rows of the whole frame."""
        return self._frame(matM, vec, mode=mode, cap=cap,
                           strata_caps=strata_caps, stop_after=stop_after,
                           tiles=(x0, y0, z0))

    # ------------------------------------------------------------------
    # per-stratum capacity schedules

    def _host_strata_counts(self, matM_np, vec_np) -> np.ndarray:
        """Per-stratum interval-active subtile counts, nearest first (the
        strata's order), from a host numpy interval evaluation of every
        subtile box: a sound upper bound on the device's worklists, which
        the root-tile proofs and the occlusion floor only shrink."""
        im = IntervalMode(np)
        sub = self.sub
        nx2, ny2, nz2 = self.nx2, self.ny2, self.geo.nz2
        zz, yy, xx = np.meshgrid(
            np.arange(nz2), np.arange(ny2), np.arange(nx2), indexing="ij",
        )
        xlo = (xx.reshape(-1) * sub).astype(np.float32)
        ylo = (yy.reshape(-1) * sub).astype(np.float32)
        zlo = (zz.reshape(-1) * sub).astype(np.float32)
        mat = self._screen_mat(np.asarray(matM_np, np.float32))
        mxi, myi, mzi = transform_intervals(
            im, mat, (xlo, xlo + sub), (ylo, ylo + sub), (zlo, zlo + sub)
        )
        inputs = []
        for i in range(self.n_inputs):
            c = np.broadcast_to(np.float32(vec_np[i]), xlo.shape).astype(
                np.float32
            )
            inputs.append((c, c))
        for kind, ivl in (("x", mxi), ("y", myi), ("z", mzi)):
            idx = self.axis_of.get(kind)
            if idx is not None:
                inputs[idx] = (
                    np.broadcast_to(ivl[0], xlo.shape).astype(np.float32),
                    np.broadcast_to(ivl[1], xlo.shape).astype(np.float32),
                )
        with np.errstate(all="ignore"):
            (out,), _ = eval_tape(self.tape, im, inputs)
        lo, hi = out
        act = (~((hi < 0.0) | (lo > 0.0))).reshape(nz2, ny2, nx2)
        nl = self.nl
        counts = np.array([
            int(act[s * nl:(s + 1) * nl].sum()) for s in range(self.ntz)
        ])
        return counts[::-1]  # nearest (largest z) first

    def strata_schedule(
        self, matM_np, vec_np, *, headroom: float = 1.15,
        quantum: int = 64, max_segments: int = 4,
    ) -> tuple:
        """A per-stratum capacity schedule from the host counts: each
        count with `headroom` and 32 slots more, rounded up to `quantum`
        (at least 64, at most a stratum's subtiles); then runs of equal
        caps merge greedily (raising the smaller cap) until at most
        `max_segments` remain. The strata here are a Python loop, so a
        run costs nothing; the merge is kept so that the schedules equal
        the reference's."""
        nsub_s = self.nl * self.ny2 * self.nx2
        counts = self._host_strata_counts(matM_np, vec_np)
        caps = []
        for c in counts:
            want = int(c * headroom) + 32
            caps.append(min(max(64, -(-want // quantum) * quantum), nsub_s))
        runs = [[c, 1] for c in caps]
        i = 0
        while i + 1 < len(runs):  # coalesce equal neighbours
            if runs[i][0] == runs[i + 1][0]:
                runs[i][1] += runs[i + 1][1]
                del runs[i + 1]
            else:
                i += 1
        while len(runs) > max_segments:
            best, cost = None, None
            for i in range(len(runs) - 1):
                (c0, n0), (c1, n1) = runs[i], runs[i + 1]
                hi = max(c0, c1)
                delta = (hi - c0) * n0 + (hi - c1) * n1
                if cost is None or delta < cost:
                    best, cost = i, delta
            (c0, n0), (c1, n1) = runs[best], runs[best + 1]
            runs[best] = [max(c0, c1), n0 + n1]
            del runs[best + 1]
        out = []
        for c, n in runs:
            out.extend([c] * n)
        return tuple(out)

    # ------------------------------------------------------------------

    def _warm_twin(self) -> "VoxelRenderer":
        """The bucketed twin (same tile, sub size and cap, the shape's
        transform included) that serves `render(warmup="interp")` while
        this tape's kernels build."""
        t = getattr(self, "_twin", None)
        if t is None:
            t = self._twin = VoxelRenderer(
                self.tape, self.size, tile_size=self.ts, sub_size=self.sub,
                cap=self.cap, specialize=False, device=self.device,
            )
            t.shape_transform = self.shape_transform
        return t

    def render(
        self,
        world_to_model: np.ndarray | None = None,
        *,
        vars: ShapeVars | dict | None = None,
        mode: str = "normals",
        max_retries: int = 3,
        cancel=None,
        warmup: str = "block",
    ) -> Image3D:
        """Renders a frame; the image stays on the device. On worklist
        overflow, retries at a sufficient power-of-two capacity (the
        count is exact, so one retry suffices). A fired CancelToken
        raises RenderCancelled before the frame and between strata.

        The per-shape pipeline builds a per-stratum capacity schedule
        after its first settled frame (clamped to the settled cap, kept
        only if it saves slots) and runs later frames under it; a frame
        that overflows it drops it, runs at the uniform cap, and builds
        a new one.

        warmup: "block" builds the kernels generated for this tape
        (`leaf` / `proofs` "unrolled") on first use. "interp" never
        blocks on that build: while it runs in a background thread,
        frames come from the bucketed twin (`_warm_twin`), and a failed
        build raises on the next call. With the interpreter leaf nothing
        is built per shape, so "interp" serves the per-shape frame at
        once. Schedules are built and used under "block" only, as in
        the reference."""
        if mode not in ("normals", "heightmap"):
            raise ValueError(f"unknown mode {mode!r}")
        if warmup not in ("block", "interp"):
            raise ValueError(f"warmup must be 'block' or 'interp', not {warmup!r}")
        matM = self._mat4(world_to_model)
        vec = self._var_vec(vars)
        kernels = self._generated_kernels()
        if kernels and not ready(self, kernels, warmup):
            return self._warm_twin().render(
                world_to_model, vars=vars, mode=mode,
                max_retries=max_retries, cancel=cancel,
            )
        scheduled = self.specialize and warmup == "block"
        if scheduled and self._sched is not None:
            check_cancel(cancel)
            depth, normal, n_over = self._frame(
                matM, vec, mode=mode, cancel=cancel, strata_caps=self._sched
            )
            if int(n_over) == 0:  # the frame's one read from the device
                return Image3D(depth, normal)
            # stale: the uniform frame below re-sizes, and a schedule is
            # built anew
            self._sched = None
            self._sched_checked = False
        for _ in range(max_retries + 1):
            check_cancel(cancel)
            depth, normal, n_active = self._frame(
                matM, vec, mode=mode, cancel=cancel
            )
            n_active = int(n_active)  # the frame's one read from the device
            if n_active <= self.cap or self.cap >= self.nsub:
                break
            self.cap = min(1 << (n_active - 1).bit_length(), self.nsub)
        if scheduled and self._sched is None and not self._sched_checked:
            self._sched_checked = True
            # each cap clamps to the settled uniform one: the host counts
            # ignore the occlusion floor, and the settle proved that
            # every stratum fits `self.cap`; both are sound bounds
            sched = tuple(
                min(c, self.cap) for c in self.strata_schedule(matM, vec)
            )
            if sum(sched) < self.ntz * min(
                self.cap, self.nl * self.ny2 * self.nx2
            ):
                self._sched = sched
        return Image3D(depth, normal)

    # ------------------------------------------------------------------

    def _brute_inputs(self, vec, planes, like):
        inputs = [np.broadcast_to(v, like.shape).astype(np.float32) for v in vec]
        for kind, plane in zip("xyz", planes):
            idx = self.axis_of.get(kind)
            if idx is not None:
                inputs[idx] = np.broadcast_to(plane, like.shape).astype(np.float32)
        return inputs

    def render_brute(
        self,
        world_to_model: np.ndarray | None = None,
        *,
        vars: ShapeVars | dict | None = None,
    ) -> Image3D:
        """Dense voxel-by-voxel oracle on the host with numpy: depth
        equal to the reference's `render_brute`, evaluated in z-slabs of
        `BRUTE_SLAB_VOXELS` so a 512^3 volume never holds every register
        of the whole volume. Returns an Image3D with a CPU depth
        tensor."""
        mat = self._screen_mat(self._mat4(world_to_model))
        vec = self._var_vec(vars)
        W, H, D = self.W, self.H, self.D
        py, px = np.meshgrid(
            np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
            indexing="ij",
        )
        depth = np.zeros((H, W), np.int32)
        step = max(1, BRUTE_SLAB_VOXELS // (W * H))
        for z0 in range(0, D, step):
            zs = np.arange(z0, min(D, z0 + step), dtype=np.int32)
            pz = np.broadcast_to(zs.astype(np.float32)[:, None, None], (zs.size, H, W))
            pts = transform_points(mat, px[None], py[None], pz)
            with np.errstate(all="ignore"):
                (d,), _ = eval_tape(
                    self.tape, FloatMode(np), self._brute_inputs(vec, pts, pz)
                )
            slab = np.where(d < 0, zs[:, None, None] + 1, 0).max(axis=0)
            depth = np.maximum(depth, slab.astype(np.int32))
        return Image3D(torch.from_numpy(depth), None)

    def brute_normals(
        self,
        depth,
        world_to_model: np.ndarray | None = None,
        *,
        vars: ShapeVars | dict | None = None,
    ) -> np.ndarray:
        """Host normals oracle: numpy GradMode through `eval_tape` at
        (px, py, depth - 1) of every pixel, seeded by `transform_duals`,
        with the conventions of the normals pass (zero where empty,
        [0, 0, 1] where saturated). `depth` is an [H, W] array."""
        depth = np.asarray(depth)
        matM = self._mat4(world_to_model)
        vec = self._var_vec(vars)
        H, W = depth.shape
        py, px = np.meshgrid(
            np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
            indexing="ij",
        )
        pz = (depth - 1).astype(np.float32)
        s2w = self.s2w.astype(np.float32)
        duals = transform_duals(
            matM, s2w[0, 0] * px + s2w[0, 3], s2w[1, 1] * py + s2w[1, 3],
            s2w[2, 2] * pz + s2w[2, 3],
        )
        zero = np.zeros_like(px)
        inputs = [(np.full_like(px, v), zero, zero, zero) for v in vec]
        for kind, dual in zip("xyz", duals):
            idx = self.axis_of.get(kind)
            if idx is not None:
                inputs[idx] = tuple(np.broadcast_to(c, px.shape) for c in dual)
        with np.errstate(all="ignore"):
            (g,), _ = eval_tape(self.tape, GradMode(np), inputs)
            grads = np.stack(g[1:4], axis=-1)
            norm = np.linalg.norm(grads, axis=-1, keepdims=True)
            normal = np.where(norm > 0, grads / norm, 0.0)
        normal = np.where(depth[..., None] > 0, normal, 0.0)
        normal[depth >= self.D] = (0.0, 0.0, 1.0)
        return normal.astype(np.float32)


def render(
    tape: Tape | Shape,
    size: VoxelSize,
    *,
    world_to_model: np.ndarray | None = None,
    vars: ShapeVars | dict | None = None,
    mode: str = "normals",
    tile_size: int = 64,
    sub_size: int = 16,
    specialize: bool = True,
    leaf: str = "interp",
    proofs: str = "interp",
    device=None,
) -> Image3D:
    """One-shot 3D render (mirrors fidget_raster::voxel::render); the
    options are `VoxelRenderer`'s."""
    r = VoxelRenderer(
        tape, size, tile_size=tile_size, sub_size=sub_size,
        specialize=specialize, leaf=leaf, proofs=proofs, device=device,
    )
    return r.render(world_to_model, vars=vars, mode=mode)
