"""Level-synchronous 3D voxel renderer (heightmap + normals), bucketed.

The counterpart of `fidget_tpu.render.render3d` on its bucketed path
(`VoxelRenderer(..., specialize=False)`): canonical opcode order, the
arena as data under the 2D renderer's `_TracedBind`. A frame is:

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

The one host read per frame is the active-subtile count after the last
stratum: when it exceeds the worklist, `render()` retries once with a
sufficient power-of-two capacity. On CUDA every kernel is hand-written
(fidget_tpu_torch/csrc); on the CPU the plain PyTorch versions run.
The reference's per-shape pipeline (`_ConstBind3`, `specialize=True`,
per-stratum capacity schedules), the unrolled leaf and proofs, the
asynchronous warm-up and sharding are not ported.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..compiler.pack import pack_tapes
from ..compiler.tape import Tape
from ..eval.arith import FloatMode, GradMode, IntervalMode
from ..eval.cuda import resolve_device
from ..eval.interp import (
    interp_float,
    interp_grad,
    interp_interval,
    interp_voxel_depth,
)
from ..eval.simplify_device import per_instance_codes, reconstruct, unpack_codes
from ..eval.unrolled import eval_tape
from ..shape import Shape, ShapeVars
from .config import check_cancel
from .region import VoxelSize
from .render2d import _ceil_to, _pad_plane, _TracedBind
from .transform import transform_duals, transform_intervals, transform_points


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


def _compact_stratum(act_flat, *, nl, ny2, nx2, cap_s):
    """Nearest-first stable compaction of a stratum's active flags into
    a worklist of cap_s slots: the selection order, its validity mask
    and the decoded (lz, gy, gx) slab-local subtile coordinates, all
    int64 (gather indices)."""
    lz_f = torch.arange(act_flat.shape[0], device=act_flat.device) // (ny2 * nx2)
    key = torch.where(act_flat, nl - lz_f, 1 << 30)
    order = torch.argsort(key, stable=True)[:cap_s]
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
        self.s0r = max(8, _ceil_to(-(-self.nt // 128), 8))    # root pass
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
    ):
        """One frame: returns (depth, normal, n_active) on the device,
        n_active being the largest active-subtile count of any stratum.
        `mat` is screen -> model, `matM` world -> model (both [4, 4]).
        `stop_after` ("root" | "simplify") returns that stage's
        intermediates, as the reference's `frame_tiles` does;
        `stage_hook(name)` is called as each stage is enqueued."""
        hook = stage_hook if stage_hook is not None else (lambda name: None)
        ts, nl, nt = self.ts, self.nl, self.nt
        im = IntervalMode(torch)
        x0, y0, z0 = st["tile_x0"], st["tile_y0"], st["tile_z0"]

        # ---- stage 1: root interval pass (lanes = root tiles) ---------
        var_lo, var_hi = self.interval_vars(
            b, im, mat, var_vec, (x0, x0 + ts), (y0, y0 + ts), (z0, z0 + ts),
            self.s0r, (1,),
        )
        w1r, w2r, immr, lensr = b.arena
        olo, ohi, choices0 = interp_interval(
            w1r, w2r, immr, lensr, var_lo, var_hi, nf=b.nf, n_inputs=b.V,
            n_outputs=1, s0=self.s0r, c_words=b.c_words,
        )
        rlo = olo[0, 0].reshape(-1)[:nt]
        rhi = ohi[0, 0].reshape(-1)[:nt]
        root_full = rhi < 0.0
        root_active = ~(root_full | (rlo > 0.0))
        hook("root")
        if stop_after == "root":
            return rlo, rhi, choices0

        # ---- stage 2: per-root-tile simplification --------------------
        w1s, w2s, imms, lens = b.simplify_root(b.root_codes(choices0, nt))
        hook("simplify")
        if stop_after == "simplify":
            return w1s, w2s, lens

        # ---- stage 3: Z-strata, front to back --------------------------
        ntxy = self.nty * self.ntx
        cap_s = min(cap, nl * self.ny2 * self.nx2)

        def slab_of(a):
            """[nt, ...] (tz, ty, tx)-major -> [ntz, ntxy, ...] with
            stratum 0 = nearest (largest z)."""
            return a.reshape((self.ntz, ntxy) + a.shape[1:]).flip(0)

        xs = dict(
            x0=slab_of(x0), y0=slab_of(y0), z0=slab_of(z0),
            act=slab_of(root_active), full=slab_of(root_full),
            w1s=slab_of(w1s), w2s=slab_of(w2s), imms=slab_of(imms),
            lens=slab_of(torch.where(root_active, lens, 0)),
        )
        floor = torch.zeros((self.H, self.W), dtype=torch.int32, device=x0.device)
        counts = []
        for k in range(self.ntz):
            check_cancel(cancel)
            s = {key: v[k] for key, v in xs.items()}
            floor, aux = self.stratum_proofs(b, st, floor, s, mat=mat,
                                             var_vec=var_vec)
            hook("proofs")
            idx = _compact_stratum(
                aux["act_flat"], nl=nl, ny2=self.ny2, nx2=self.nx2,
                cap_s=cap_s,
            )
            hook("compact")
            dcand = self.stratum_leaf(
                b, st, s, aux, idx, mat=mat, var_vec=var_vec, cap_s=cap_s,
                hook=hook,
            )
            floor = self.stratum_fold(floor, dcand, idx, cap_s=cap_s)
            hook("fold")
            counts.append(aux["n_active"])
        n_active = torch.stack(counts).max()
        if mode == "heightmap":
            return floor, None, n_active
        check_cancel(cancel)
        normal = self.normals_body(b, st, floor, matM, var_vec)
        hook("normals")
        return floor, normal, n_active

    def stratum_proofs(self, b, st, floor, s, *, mat, var_vec):
        """Stratum stage A: root-full fold, subtile interval pass,
        proof-driven fulls and occlusion against the floor. Returns
        (floor', aux) with the active flags, their count, the packed
        choices and the slab's z base."""
        ts, sub, nl, m = self.ts, self.sub, self.nl, self.m
        nty, ntx, ny2, nx2 = self.nty, self.ntx, self.ny2, self.nx2
        i32 = torch.int32
        im = IntervalMode(torch)
        x0s, y0s, z0s = s["x0"], s["y0"], s["z0"]
        acts = s["act"][:, None]                      # [ntxy, 1]

        # root-full proofs of this slab fill their whole footprint
        full_px = torch.where(s["full"], z0s + ts, 0.0).reshape(nty, ntx)
        full_px = full_px.to(i32).repeat_interleave(ts, 0).repeat_interleave(ts, 1)
        floor = torch.maximum(floor, full_px)

        # subtile interval pass with the slab's simplified tapes
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
            c_words=b.c_words,
        )
        slo = olo1[:, 0].reshape(nty * ntx, -1)[:, :m]
        shi = ohi1[:, 0].reshape(nty * ntx, -1)[:, :m]
        sub_full = acts & (shi < 0.0)
        sub_active = acts & ~(shi < 0.0) & ~(slo > 0.0)

        def to_dense(flags):
            """[ntxy, m] -> [nl(z), ny2, nx2] slab-local grid."""
            g = flags.reshape(nty, ntx, nl, nl, nl)
            return g.permute(2, 0, 3, 1, 4).reshape(nl, ny2, nx2)

        z_lo = z0s[0]  # slab z base (shared by all slab tiles)
        lz_col = torch.arange(nl, dtype=i32, device=floor.device)[:, None, None]
        sub_top = z_lo.to(i32) + lz_col * sub + sub

        # proof-driven fulls at subtile granularity
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

    def stratum_leaf(self, b, st, s, aux, idx, *, mat, var_vec, cap_s, hook):
        """Stratum stage B: gather the worklist's parent tapes,
        re-specialize them per subtile from the packed choices, and run
        the voxel pass. Returns depth candidates [cap_s, sub, sub]."""
        sub, nl = self.sub, self.nl
        i32 = torch.int32
        lz, gy, gx, valid = idx["lz"], idx["gy"], idx["gx"], idx["valid"]

        # voxel coordinates of the worklist, (vz, vy, vx) row-major
        bx = (gx * sub).to(torch.float32)[:, None]
        by = (gy * sub).to(torch.float32)[:, None]
        bz = (lz * sub).to(torch.float32)[:, None] + aux["z_lo"]
        px = bx + st["vox_dx"][None, :]
        py = by + st["vox_dy"][None, :]
        pz = bz + st["vox_dz"][None, :]

        t_idx = (gy // nl) * self.ntx + (gx // nl)
        perlane = per_instance_codes(
            s["w1s"], s["w2s"], s["lens"], aux["choices1"], nf=b.nf
        )  # [ntxy, s0s * 128, lw]
        k_local = ((lz % nl) * nl + (gy % nl)) * nl + (gx % nl)
        codes = unpack_codes(perlane[t_idx, k_local], s["w1s"].shape[1])
        w1_leaf, w2_leaf, imm_leaf, len_leaf, _ = reconstruct(
            s["w1s"][t_idx], s["w2s"][t_idx], s["imms"][t_idx], codes
        )
        len_leaf = torch.where(valid, len_leaf, 0)
        hook("respecialize")

        vars_v = self.point_vars(b, mat, var_vec, px, py, pz, self.s0v, (cap_s,))
        bz_i = bz.to(i32)
        if sub * sub % 128 == 0:
            pp = (sub * sub) // 128
            local = interp_voxel_depth(
                w1_leaf, w2_leaf, imm_leaf, len_leaf, vars_v, nf=b.nf_regs,
                n_inputs=b.V, s0=self.s0v, sub=sub,
            )[:, :pp].reshape(cap_s, sub, sub)
            dcand = torch.where(
                (local > 0) & valid[:, None, None], bz_i[..., None] + local, 0
            )
        else:
            dv = interp_float(
                w1_leaf, w2_leaf, imm_leaf, len_leaf, vars_v, nf=b.nf,
                n_inputs=b.V, n_outputs=1, s0=self.s0v,
            )[:, 0].reshape(cap_s, -1)[:, : sub**3]
            inside = ((dv < 0.0) & valid[:, None]).reshape(cap_s, sub, sub, sub)
            vz_col = torch.arange(sub, dtype=i32, device=dv.device)[None, :, None, None]
            dcand = torch.where(
                inside, bz_i[..., None, None] + vz_col + 1, 0
            ).amax(1)
        hook("voxel")
        return dcand

    def stratum_fold(self, floor, dcand, idx, *, cap_s):
        """Stratum stage C: scatter the worklist's depth candidates back
        through the compaction inverse and fold the slab's hits into the
        floor."""
        sub, nl, ny2, nx2 = self.sub, self.nl, self.ny2, self.nx2
        order, valid = idx["order"], idx["valid"]
        slots = torch.arange(cap_s, device=order.device)
        slot_of = torch.full(
            (nl * ny2 * nx2,), cap_s, dtype=torch.int64, device=order.device
        ).scatter(0, order, torch.where(valid, slots, cap_s))
        dcand_pad = torch.cat([dcand, dcand.new_zeros((1, sub, sub))])
        slab_vox = (
            dcand_pad[slot_of]
            .reshape(nl, ny2, nx2, sub, sub)
            .permute(0, 1, 3, 2, 4)
            .reshape(nl, self.H, self.W)
            .amax(0)
        )
        return torch.maximum(floor, slab_vox)

    def normals_body(self, b, st, depth, matM, var_vec):
        """Per-pixel forward-gradient normals at the surface voxels
        (voxel.rs:447-482): K4 over `Tn` instances of the whole tape. The
        lanes are split as the reference splits them for the bucket's
        nf; K4 itself gets the tape's registers."""
        H, W, D = self.H, self.W, self.D
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
        py = padl(torch.arange(H, dtype=f32, device=dev).repeat_interleave(W))
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
      device: render device; None means CUDA, and raises when there is
        no card. Pass "cpu" to run the plain PyTorch versions.
    """

    def __init__(
        self,
        tape: Tape | Shape,
        size: VoxelSize,
        *,
        tile_size: int = 64,
        sub_size: int = 16,
        cap: int | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
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
        self.nsub = g.nsub
        self.s2w = g.s2w
        if cap is None:
            cap = max(256, g.nx2 * g.ny2)
        self.cap = min(1 << (int(cap) - 1).bit_length(), self.nsub)

        self.nf = tape.reg_count + tape.mem_count
        # K4 and K5 get the registers the tape names (child tapes keep
        # the parent's register indices), as 2D's value kernels do; K1
        # and K2 keep the bucket's nf_b
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

    # ------------------------------------------------------------------

    def _bind(self) -> _TracedBind:
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
               cancel=None, stage_hook=None):
        """One frame from host inputs: `matM` the [4, 4] world -> model
        f32 matrix (`_mat4`), `vec` the [V] variable values."""
        dev = self.device
        return self.geo.frame(
            self._bind(), self.geo.statics(dev),
            torch.from_numpy(self._screen_mat(matM)).to(dev),
            torch.from_numpy(matM).to(dev), torch.from_numpy(vec).to(dev),
            mode=mode, cap=self.cap if cap is None else cap,
            stop_after=stop_after, cancel=cancel, stage_hook=stage_hook,
        )

    def render(
        self,
        world_to_model: np.ndarray | None = None,
        *,
        vars: ShapeVars | dict | None = None,
        mode: str = "normals",
        max_retries: int = 3,
        cancel=None,
    ) -> Image3D:
        """Renders a frame; the image stays on the device. On worklist
        overflow, retries at a sufficient power-of-two capacity (the
        count is exact, so one retry suffices). A fired CancelToken
        raises RenderCancelled before the frame and between strata."""
        if mode not in ("normals", "heightmap"):
            raise ValueError(f"unknown mode {mode!r}")
        matM = self._mat4(world_to_model)
        vec = self._var_vec(vars)
        for _ in range(max_retries + 1):
            check_cancel(cancel)
            depth, normal, n_active = self._frame(
                matM, vec, mode=mode, cancel=cancel
            )
            n_active = int(n_active)  # the frame's one read from the device
            if n_active <= self.cap or self.cap >= self.nsub:
                break
            self.cap = min(1 << (n_active - 1).bit_length(), self.nsub)
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
    device=None,
) -> Image3D:
    """One-shot 3D render (mirrors fidget_raster::voxel::render)."""
    r = VoxelRenderer(
        tape, size, tile_size=tile_size, sub_size=sub_size, device=device
    )
    return r.render(world_to_model, vars=vars, mode=mode)
