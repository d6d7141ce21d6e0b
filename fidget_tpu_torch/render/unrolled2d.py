"""The per-shape compiled 2D path: `render_unrolled` and `render_dense`.

The counterpart of the unrolled stages of `fidget_tpu.render.render2d`
(`_unrolled_cull_stage`, `_cull_sizing_stage`, `_unrolled_leaf_eval`,
`_frame_unrolled_fn`, the capture and violation culls,
`_frame_union_fn`, `_warm_async`, `render_unrolled`, `render_dense`).
Where the reference traces the whole tape into straight-line XLA, the
port runs kernels generated per tape (eval/unrolled_cuda.py): U2
`unrolled_interval` culls tiles, U1 `unrolled_float` evaluates the
pixels of the active ones. Compaction, scatter and assembly are torch
ops, as they are XLA ops in the reference.

A full-leaf frame (`frame_unrolled`):

1. cull: U2 over T0-px tiles (`cull="unrolled"`), or K1 on the
   canonical bucket arena (`cull="interp"`, `cull_sizing`);
2. the active tiles compacted, in row-major order, into C slots;
3. U1 over the slots' pixels, the whole tape;
4. scatter back and assembly (fills from the proofs).

A union frame (`frame_union`) runs in the plan's block-major tile order:
U2 with the fused violation epilogue against each tile's block-union
words, per-program compaction into the plan's capacities plus a
full-tape fallback worklist for the tiles whose trace escapes their
union, one U1 launch over every program's segment and the fallback,
then the assembly unpermutes.

Frames are differentiable in the var vector through the leaf alone
(`_UnrolledLeaf`: U1 forward, the Jacobian from `_FloatJacobian`, K4,
over the same pixels); the cull and compaction run as one constant of
differentiation (`untracked`), and proven fills carry no derivative.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..compiler.unions import build_union_plan
from ..eval.arith import IntervalMode
from ..eval.interp import _FloatJacobian, interp_interval, untracked
from ..eval.unrolled_cuda import (
    FloatKernel,
    IntervalKernel,
    build_kernels,
    built,
    params_tensor,
    unrolled_float,
    unrolled_interval,
)
from ..utils import count
from .config import check_cancel
from .transform import transform_intervals, transform_points

#: fill codes, as render2d.py defines them
FILL_NONE, FILL_INSIDE, FILL_OUTSIDE = 0, 1, 2


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class _State:
    """What a renderer's unrolled frames keep between calls: the kernels
    of its tape, the tile corners per tile size, the replicated arenas
    of the sizing pass, the union plans and their device tables."""

    def __init__(self, r):
        self.r = r
        self.V = r.n_inputs
        self.float_full = FloatKernel([r.tape], r.axis_of, self.V)
        self._interval = {}
        self._tiles = {}
        self._sizing = {}
        self.plans = {}
        self.refreshing = {}
        self.refresh_error = None

    def interval(self, epilogue: str) -> IntervalKernel:
        k = self._interval.get(epilogue)
        if k is None:
            k = IntervalKernel(self.r.tape, self.r.axis_of, self.V, epilogue)
            self._interval[epilogue] = k
        return k

    def tiles(self, T0: int):
        """Row-major tile corners (x0, y0) at T0 px, on the device."""
        t = self._tiles.get(T0)
        if t is None:
            n0x = -(-self.r.W // T0)
            n0y = -(-self.r.H // T0)
            gx, gy = np.meshgrid(np.arange(n0x) * T0, np.arange(n0y) * T0)
            t = tuple(
                torch.from_numpy(g.reshape(-1).astype(np.float32)).to(
                    self.r.device
                )
                for g in (gx, gy)
            )
            self._tiles[T0] = t
        return t

    def sizing_arena(self, G: int):
        """The bucket arena copied over G instances (K1 takes one arena
        row per instance)."""
        a = self._sizing.get(G)
        if a is None:
            a = tuple(t.expand(G, *t.shape[1:]).contiguous()
                      for t in self.r._arena)
            self._sizing[G] = a
        return a


def state(r) -> _State:
    st = getattr(r, "_unrolled_state", None)
    if st is None:
        st = _State(r)
        r._unrolled_state = st
    return st


# ======================================================================
# cull stages


def cull_sizing(r, T0, x0, y0, mat, z, var_vec):
    """Root interval proofs (root_in, root_out) of the tiles through K1
    on the canonical bucket arena (the reference's `_cull_sizing_stage`,
    also `cull="interp"`): lanes are tiles, chunked into 32-row planes
    over a grid of instances when there are more than 4,096 tiles."""
    st = state(r)
    n0 = x0.shape[0]
    s0r = max(8, _ceil_to(-(-n0 // 128), 8))
    S0C = 32
    G = -(-s0r // S0C)
    s0c = s0r if G == 1 else S0C
    s0r = G * s0c
    V = st.V
    im = IntervalMode(torch)
    mxi, myi, mzi = transform_intervals(
        im, mat, (x0, x0 + T0), (y0, y0 + T0), (z, z)
    )
    var_lo = var_vec.reshape(1, V, 1, 1).expand(G, V, s0c, 128).contiguous()
    var_hi = var_lo.clone()

    def pad_plane(a):
        a = torch.broadcast_to(a, x0.shape)
        a = torch.cat([a, a.new_zeros(s0r * 128 - n0)])
        return a.reshape(G, s0c, 128)

    for kind, ivl in (("x", mxi), ("y", myi), ("z", mzi)):
        idx = r.axis_of.get(kind)
        if idx is not None:
            var_lo[:, idx] = pad_plane(ivl[0])
            var_hi[:, idx] = pad_plane(ivl[1])
    w1, w2, imm, lens = st.sizing_arena(G)
    olo, ohi, _ = interp_interval(
        w1, w2, imm, lens, var_lo, var_hi, nf=r._nf_regs, n_inputs=V,
        n_outputs=1, s0=s0c, c_words=r.cw_b,
    )
    rlo = olo[:, 0].reshape(-1)[:n0]
    rhi = ohi[:, 0].reshape(-1)[:n0]
    return rhi < 0.0, rlo > 0.0


def cull_unrolled(r, T0, x0, y0, mat, z, var_vec, epilogue="proofs", u=None):
    """U2 over the tiles: (root_in, root_out, extra), `extra` the
    epilogue's output (see `unrolled_interval`)."""
    st = state(r)
    return unrolled_interval(
        st.interval(epilogue), x0, y0, params_tensor(mat, z, var_vec), T0,
        u,
    )


def cull_capture(r, T0, mat, z, var_vec):
    """The unrolled cull with choice capture over the renderer's T0-px
    tiles (the reference's `_unrolled_cull_capture_stage`): root_in,
    root_out and the packed words, int32 [cw, n0]."""
    x0, y0 = state(r).tiles(T0)
    return cull_unrolled(r, T0, x0, y0, *_device_args(r, mat, z, var_vec),
                         epilogue="capture")


def _device_args(r, mat, z, var_vec):
    dev = r.device
    return (
        torch.as_tensor(mat, dtype=torch.float32, device=dev),
        torch.as_tensor(z, dtype=torch.float32, device=dev),
        torch.as_tensor(var_vec, dtype=torch.float32, device=dev),
    )


# ======================================================================
# the leaf, differentiable in the var vector


def _leaf(kern, seg, tw, pp, cx0, cy0, valid, mat, z, var_vec, st):
    return _UnrolledLeaf.apply(
        var_vec, mat, z, cx0, cy0, valid, (kern, tuple(seg), tw, pp, st)
    )


class _UnrolledLeaf(torch.autograd.Function):
    """U1 over a worklist, with its derivative in the var vector: the
    Jacobian of the full tape at the same pixels from `_FloatJacobian`
    (K4 passes in the non-axis inputs alone, non-finite partials 0),
    zero on invalid slots and in the axis entries, which the transform
    overwrites. A union
    program equals the full tape on every pixel it serves (its tiles'
    traces are subsets of its union), so one Jacobian serves every
    segment."""

    generate_vmap_rule = True

    @staticmethod
    def forward(var_vec, mat, z, cx0, cy0, valid, cfg):
        kern, seg, tw, pp, _ = cfg
        return unrolled_float(
            kern, cx0, cy0, valid, params_tensor(mat, z, var_vec), seg,
            tw=tw, pp=pp,
        )

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.cfg = inputs[6]
        ctx.save_for_backward(*inputs[:6])
        ctx.save_for_forward(*inputs[:6])

    @staticmethod
    def backward(ctx, grad_out):
        J = _leaf_jacobian(*ctx.saved_tensors, ctx.cfg)  # [n, pp, V]
        grad_vars = (grad_out[..., None] * J).sum(dim=(0, 1))
        return grad_vars, None, None, None, None, None, None

    @staticmethod
    def jvp(ctx, dvar, dmat, dz, dcx0, dcy0, dvalid, dcfg):
        if dvar is None:  # a tangent on the matrix or z only
            var_vec, n = ctx.saved_tensors[0], ctx.saved_tensors[3].shape[0]
            return var_vec.new_zeros((n, ctx.cfg[3]))
        J = _leaf_jacobian(*ctx.saved_tensors, ctx.cfg)
        return (J * dvar).sum(dim=-1)


def _leaf_jacobian(var_vec, mat, z, cx0, cy0, valid, cfg):
    """J [n, pp, V] of the leaf's distances in the var vector, 0 on
    invalid slots and in the axis columns, which K4 does not compute.
    Counts the partials that it keeps, the non-axis columns at the valid
    slots' pixels (`jacobian.tangents_kept`)."""
    _, _, tw, pp, st = cfg
    w1, w2, imm, lens = st.r._arena
    V = var_vec.shape[0]
    n = cx0.shape[0]
    ii = torch.arange(pp, dtype=torch.float32, device=var_vec.device)
    px = cx0[:, None] + ii[None, :] % tw
    py = cy0[:, None] + torch.div(ii, tw, rounding_mode="floor")[None, :]
    planes = [var_vec[i].expand(n, pp) for i in range(V)]
    # the transform overwrites the axis entries of the var vector, so
    # the frame does not depend on them: their columns are 0
    axes = set()
    for kind, m in zip(("x", "y", "z"), transform_points(mat, px, py, z)):
        idx = st.r.axis_of.get(kind)
        if idx is not None:
            planes[idx] = torch.broadcast_to(m, (n, pp))
            axes.add(idx)
    wanted = tuple(i for i in range(V) if i not in axes)
    count("jacobian.tangents_kept", valid, per=len(wanted) * pp)
    lanes = n * pp
    s0 = max(1, -(-lanes // 128))
    planes = torch.stack([p.reshape(-1) for p in planes])
    planes = torch.cat(
        [planes, planes.new_zeros((V, s0 * 128 - lanes))], dim=1
    ).reshape(1, V, s0, 128)
    J = _FloatJacobian.apply(w1, w2, imm, lens, planes,
                             (st.r._nf_regs, V, 1, s0, None, wanted))
    J = J.reshape(V, s0 * 128)[:, :lanes].T.reshape(n, pp, V)
    return J * valid[:, None, None]


def _assemble(dist_c, slot_of, fill_tile, n0x, n0y, T0):
    pp = T0 * T0
    dist_pad = torch.cat([dist_c, dist_c.new_zeros((1, pp))], dim=0)
    dist = dist_pad[slot_of].reshape(n0y, n0x, T0, T0)
    img = dist.permute(0, 2, 1, 3).reshape(n0y * T0, n0x * T0)
    fill = fill_tile.reshape(n0y, n0x)
    fill = fill.repeat_interleave(T0, 0).repeat_interleave(T0, 1)
    return img, fill


def _fill_tiles(act, root_in):
    i8 = torch.int8
    return torch.where(
        act, torch.full_like(act, FILL_NONE, dtype=i8),
        torch.where(root_in, FILL_INSIDE, FILL_OUTSIDE).to(i8),
    )


def _compact(dest, ok, n_slots, x0, y0):
    """One index scatter (position + 1 into each kept tile's slot; a
    dump slot past the end takes the rest), then the coordinates come
    by gather: (cx0, cy0, valid) of the slots."""
    n0 = x0.shape[0]
    dest_u = torch.where(ok, dest, torch.full_like(dest, n_slots))
    o1 = torch.zeros(n_slots + 1, dtype=torch.int64, device=x0.device)
    o1.scatter_(0, dest_u, torch.arange(1, n0 + 1, device=x0.device))
    o1 = o1[:n_slots]
    order = (o1 - 1).clamp(min=0)
    return x0[order], y0[order], o1 > 0


# ======================================================================
# frames


def frame_unrolled(r, T0, C, pixel_perfect, cull, mat, z, var_vec):
    """The full-leaf frame at T0-px tiles and C leaf slots (tensors on
    the render device): (img, fill, n_active), the padded frame; more
    than C active tiles means the worklist overflowed (the caller
    retries with a larger C)."""
    st = state(r)
    n0x = -(-r.W // T0)
    n0y = -(-r.H // T0)
    x0, y0 = st.tiles(T0)
    pp = T0 * T0
    if cull not in ("unrolled", "interp"):
        raise ValueError(f"cull must be 'unrolled' or 'interp', not {cull!r}")

    def cull_compact(x0, y0, mat, z, var_vec):
        if cull == "unrolled":
            root_in, root_out, _ = cull_unrolled(r, T0, x0, y0, mat, z,
                                                 var_vec)
        else:
            root_in, root_out = cull_sizing(r, T0, x0, y0, mat, z, var_vec)
        act = ~(root_in | root_out)
        if pixel_perfect:
            act = torch.ones_like(act)
        n_active = act.sum()
        pos = torch.cumsum(act.to(torch.int64), 0) - 1
        ok = act & (pos < C)
        cx0, cy0, valid = _compact(pos, ok, C, x0, y0)
        slot_of = torch.where(ok, pos, torch.full_like(pos, C))
        return cx0, cy0, valid, slot_of, _fill_tiles(act, root_in), n_active

    cx0, cy0, valid, slot_of, fill_tile, n_active = untracked(
        cull_compact, x0, y0, mat, z, var_vec.detach()
    )
    dist_c = _leaf(st.float_full, (0,), T0, pp, cx0, cy0, valid, mat, z,
                   var_vec, st)
    img, fill = _assemble(dist_c, slot_of, fill_tile, n0x, n0y, T0)
    return img, fill, n_active


def frame_dense(r, mat, z, var_vec):
    """The dense frame: U1 over every pixel of the image as one tile
    (W px wide), f32 [H, W]."""
    st = state(r)
    dev = r.device
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    d = _leaf(st.float_full, (0,), r.W, r.W * r.H, zero, zero, one, mat, z,
              var_vec, st)
    return d.reshape(r.H, r.W)


class _UnionTables:
    """A plan's static routing tables on the device, block-major (the
    reference's `_frame_union_fn` prologue)."""

    def __init__(self, plan, tape, axis_of, V, fb_cap, device):
        n0 = plan.n0x * plan.n0y
        P = len(plan.programs)
        caps = plan.caps.astype(np.int64)
        base = np.concatenate([[0], np.cumsum(caps)]).astype(np.int64)
        self.P = P
        self.fb_base = int(base[P])
        self.total = self.fb_base + fb_cap
        self.fb_cap = fb_cap
        self.seg = tuple(int(b) for b in base[: P + 1])
        bp = plan.block_prog
        order_key = np.where(bp < 0, P, bp)
        perm = np.argsort(order_key, kind="stable")
        inv_perm = np.argsort(perm)
        prog_perm = order_key[perm]
        seg_end = np.searchsorted(prog_perm, np.arange(max(P, 1)) + 1)
        safe_prog = np.minimum(prog_perm, max(P - 1, 0))
        base_of_tile = base[safe_prog]
        cap_of_tile = caps[safe_prog] if P else np.zeros(n0, np.int64)
        u_tile = (
            plan.u_packed[np.maximum(bp, 0)][perm]
            if P
            else np.zeros((n0, 1), np.uint32)
        )

        def dev(a, dtype=torch.int64):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

        self.perm = dev(perm)
        self.inv_perm = dev(inv_perm)
        self.seg_end = dev(seg_end)
        self.safe_prog = dev(safe_prog)
        self.base_of_tile = dev(base_of_tile)
        self.cap_of_tile = dev(cap_of_tile)
        self.has_prog = dev((bp >= 0)[perm], torch.bool)
        self.u_tile = dev(np.ascontiguousarray(u_tile.T).view(np.int32),
                          torch.int32)
        self.kernel = FloatKernel(list(plan.programs) + [tape], axis_of, V)


def union_tables(r, plan, fb_cap) -> _UnionTables:
    tabs = plan.__dict__.setdefault("_port_tables", {})
    key = (fb_cap, str(r.device))
    t = tabs.get(key)
    if t is None:
        t = _UnionTables(plan, r.tape, r.axis_of, r.n_inputs, fb_cap,
                         r.device)
        tabs[key] = t
    return t


def frame_union(r, plan, fb_cap, pixel_perfect, mat, z, var_vec):
    """The union-leaf frame: (img, fill, counts), counts an int64 tensor
    (n_active, n_fallback, n_over); n_over > 0 means a worklist
    overflowed and the caller must rebuild the plan and retry."""
    st = state(r)
    T0 = plan.T0
    n0x, n0y = plan.n0x, plan.n0y
    n0 = n0x * n0y
    pp = T0 * T0
    tb = union_tables(r, plan, fb_cap)
    x0, y0 = st.tiles(T0)

    def cull_compact(x0, y0, mat, z, var_vec):
        # block-major order throughout: permute the tile corners once
        xp = x0[tb.perm]
        yp = y0[tb.perm]
        root_in, root_out, viol = cull_unrolled(
            r, T0, xp, yp, mat, z, var_vec, "violation", tb.u_tile
        )
        act = ~(root_in | root_out)
        if pixel_perfect:
            act = torch.ones_like(act)
        n_active = act.sum()
        m_own = act & tb.has_prog & ~viol
        c = torch.cumsum(m_own.to(torch.int64), 0)
        if tb.P:
            ends = c[tb.seg_end - 1]
            start = torch.cat([ends.new_zeros(1), ends])[tb.safe_prog]
        else:
            start = torch.zeros_like(c)
        rank = c - 1 - start
        ok_own = m_own & (rank < tb.cap_of_tile)
        dest_own = tb.base_of_tile + rank
        m_fb = act & ~m_own
        cf = torch.cumsum(m_fb.to(torch.int64), 0) - 1
        ok_fb = m_fb & (cf < fb_cap)
        dest_fb = tb.fb_base + cf
        ok = ok_own | ok_fb
        dest = torch.where(ok_own, dest_own, dest_fb)
        n_fb = m_fb.sum()
        n_over = (m_own & ~ok_own).sum() + (m_fb & ~ok_fb).sum()
        sx, sy, vs = _compact(dest, ok, tb.total, xp, yp)
        slot_p = torch.where(ok, dest, torch.full_like(dest, tb.total))
        slot_of = slot_p[tb.inv_perm]
        fill_tile = _fill_tiles(act, root_in)[tb.inv_perm]
        counts = torch.stack([n_active, n_fb, n_over])
        return sx, sy, vs, slot_of, fill_tile, counts

    sx, sy, vs, slot_of, fill_tile, counts = untracked(
        cull_compact, x0, y0, mat, z, var_vec.detach()
    )
    dist_all = _leaf(tb.kernel, tb.seg, T0, pp, sx, sy, vs, mat, z,
                     var_vec, st)
    img, fill = _assemble(dist_all, slot_of, fill_tile, n0x, n0y, T0)
    return img, fill, counts


# ======================================================================
# background builds (warmup="interp")

#: kernel-set key -> "building" | an exception | "ready"
_UWARM: dict = {}
_UWARM_LOCK = threading.Lock()


def _warm_key(kernels):
    return tuple(k.unit().key for k in kernels)


def ready(r, kernels, warmup: str) -> bool:
    """Whether the frame's kernels can run now. "block" builds any that
    are missing, all together, and returns True; "interp" starts (at
    most one) background build and returns False until it has
    finished. A failed build raises here, on the next call."""
    if r.device.type == "cpu" or built(kernels):
        return True
    if warmup == "block":
        build_kernels(kernels)
        return True
    key = _warm_key(kernels)
    with _UWARM_LOCK:
        st = _UWARM.get(key)
        if st is None:
            _UWARM[key] = "building"

            def build_bg():
                try:
                    build_kernels(kernels)
                    result = "ready"
                except Exception as e:  # raised on the caller's next call
                    result = e
                with _UWARM_LOCK:
                    _UWARM[key] = result

            threading.Thread(target=build_bg, daemon=True).start()
            return False
    if isinstance(st, Exception):
        with _UWARM_LOCK:
            _UWARM.pop(key, None)
        raise st
    return st == "ready" and built(kernels)


# ======================================================================
# entry points


def render_unrolled(r, world_to_model=None, *, z=0.0, vars=None,
                    pixel_perfect=False, tile_size=8, cap=None,
                    max_retries=3, cull="unrolled", warmup="block",
                    leaf="full", block_px=256, cancel=None):
    """`PixelRenderer.render_unrolled` (see its docstring)."""
    from .render2d import Image2D

    if warmup not in ("block", "interp"):
        raise ValueError(f"warmup must be 'block' or 'interp', not {warmup!r}")
    if leaf not in ("full", "union"):
        raise ValueError(f"leaf must be 'full' or 'union', not {leaf!r}")
    st = state(r)
    if st.refresh_error is not None:
        # a background plan refresh failed: raise it here, once
        e, st.refresh_error = st.refresh_error, None
        raise e
    T0 = int(tile_size)
    n0x = -(-r.W // T0)
    n0y = -(-r.H // T0)
    n0 = n0x * n0y
    mat_np = r._mat4(world_to_model)
    vec_np = r._var_vec(vars)
    mat, zt, vec = _device_args(r, mat_np, z, vec_np)

    def interp_frame():
        return r.render(world_to_model, z=z, vars=vars,
                        pixel_perfect=pixel_perfect, cancel=cancel)

    def image(img, fill):
        return Image2D(img[: r.H, : r.W], fill[: r.H, : r.W])

    if leaf == "union":
        pk = (T0, block_px)
        plan = st.plans.get(pk)
        if plan is None:
            check_cancel(cancel)
            plan = build_union_plan(r.tape, T0, n0x, n0y, mat_np, z, vec_np,
                                    r.axis_of, block_px=block_px)
            st.plans[pk] = plan
        fb_cap = max(128, _ceil_to(n0 // 64, 128))
        r.union_stats = None
        for attempt in range(max_retries + 1):
            check_cancel(cancel)
            kernels = [st.interval("violation"),
                       union_tables(r, plan, fb_cap).kernel]
            if not ready(r, kernels, warmup):
                return interp_frame()
            img, fill, counts = frame_union(r, plan, fb_cap, pixel_perfect,
                                            mat, zt, vec)
            n_active, n_fb, n_over = (int(c) for c in counts.tolist())
            if n_over == 0:
                r.union_stats = {"n_active": n_active, "n_fallback": n_fb,
                                 **plan.stats()}
                # staleness refresh: above 5% fallback, rebuild the plan
                # for the current camera in the background and swap it
                # in once its kernels are built; frames keep flowing
                # through the stale plan meanwhile
                if (n_fb > max(16, n_active * 0.05)
                        and not st.refreshing.get(pk)):
                    st.refreshing[pk] = True
                    threading.Thread(
                        target=_refresh_plan, daemon=True,
                        args=(r, pk, T0, n0x, n0y, mat_np, z, vec_np,
                              block_px, fb_cap),
                    ).start()
                return image(img, fill)
            # overflow: rebuild at the current camera with growing
            # headroom
            plan = build_union_plan(
                r.tape, T0, n0x, n0y, mat_np, z, vec_np, r.axis_of,
                block_px=block_px, headroom=1.15 + 0.25 * (attempt + 1),
            )
            st.plans[pk] = plan
        # retries exhausted: serve the frame through the full-tape leaf
        return render_unrolled(
            r, world_to_model, z=z, vars=vars, pixel_perfect=pixel_perfect,
            tile_size=tile_size, cap=cap, max_retries=max_retries,
            cull=cull, warmup=warmup, leaf="full", cancel=cancel,
        )

    def bucket(n):
        # 8% headroom rounded to 128 slots
        return min(_ceil_to(int(int(n) * 1.08) + 1, 128), n0)

    ucap = r.__dict__.setdefault("_ucap", {})
    if pixel_perfect:
        cap = n0
    elif cap is None:
        cap = ucap.get(T0)
        if cap is None:
            # a cull-only pass through K1 sizes the worklist
            check_cancel(cancel)
            x0, y0 = st.tiles(T0)
            root_in, root_out = untracked(
                functools.partial(cull_sizing, r, T0), x0, y0, mat, zt, vec
            )
            cap = bucket(int((~(root_in | root_out)).sum()))
            ucap[T0] = cap
    else:
        cap = min(int(cap), n0)
    kernels = [st.float_full]
    if cull == "unrolled":
        kernels.append(st.interval("proofs"))
    for _ in range(max_retries + 1):
        check_cancel(cancel)
        if not ready(r, kernels, warmup):
            return interp_frame()
        img, fill, n_active = frame_unrolled(r, T0, cap, pixel_perfect, cull,
                                             mat, zt, vec)
        n_active = int(n_active)
        if n_active <= cap or cap >= n0:
            break
        cap = bucket(n_active)
    ucap[T0] = cap
    return image(img, fill)


def _refresh_plan(r, pk, T0, n0x, n0y, mat_np, z, vec_np, block_px, fb_cap):
    """Background plan rebuild at the current camera: the plan, its
    tables and its kernels, then the swap. A failure is kept and raised
    by the next `render_unrolled` call."""
    st = state(r)
    try:
        p2 = build_union_plan(r.tape, T0, n0x, n0y, mat_np, z, vec_np,
                              r.axis_of, block_px=block_px)
        if r.device.type != "cpu":
            build_kernels([union_tables(r, p2, fb_cap).kernel])
        st.plans[pk] = p2
    except Exception as e:  # the render thread raises it
        st.refresh_error = e
    finally:
        st.refreshing[pk] = False


def render_dense(r, world_to_model=None, *, z=0.0, vars=None):
    """`PixelRenderer.render_dense` (see its docstring)."""
    from .render2d import Image2D

    st = state(r)
    ready(r, [st.float_full], "block")
    mat, zt, vec = _device_args(r, r._mat4(world_to_model), z,
                                r._var_vec(vars))
    d = frame_dense(r, mat, zt, vec)
    return Image2D(d, torch.zeros((r.H, r.W), dtype=torch.int8,
                                  device=r.device))
