"""Batched on-device tape simplification.

Given one parent tape and per-lane interval choice codes, produce
per-lane specialized child tapes entirely on the device, in two steps:

1. `liveness_codes` (K2) walks the tape once in reverse per lane,
   carrying a liveness bit per register, and emits a 2-bit action code
   per (lane, op): 0 = drop, 1 = keep as-is, 2 = rewrite to
   COPY(out<-a), 3 = rewrite to COPY(out<-b). Self-copies are elided
   while the destination register stays live. On CUDA this is the
   kernel csrc/liveness.cu; on the CPU its plain PyTorch version.
2. `reconstruct` turns codes into compacted child arenas with tensor
   ops (no kernel): rewrite the rows, re-index the surviving choice
   ops, then stably partition the kept rows to the front.

`DeviceSimplifier` binds both steps to one parent tape (the per-shape
path of the 2D renderer); the module-level functions take the tapes as
data (the bucketed paths, and the second tile level, where every
instance has its own tape).

The counterparts of `fidget_tpu.eval.simplify_device._liveness_codes`,
`DeviceSimplifier`, `DynamicSimplifier.codes` and
`DynamicSimplifier.reconstruct`.
Because a child tape is always a subsequence of its parent, the child
arena capacity equals the parent's and overflow cannot occur.

An arena packed under an opcode renumbering (`pack_tapes(op_order=
...)`) needs the same `op_order` in every call here, as in the
interpreter kernels: K2 reads operand-use flags off the op, and
`reconstruct` writes COPY under the arena's numbering.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.pack import IMM12, _op_rank, pack_rows, pack_tapes
from ..compiler.tape import (
    BINARY_MASK,
    BINARY_TAPE_OPS,
    CHOICE_MASK,
    CHOICE_TAPE_OPS,
    UNARY_TAPE_OPS,
    Tape,
    TapeOp,
)
from . import cuda
from .interp import _decode, _host_tape


def liveness_codes(
    w1s, w2s, lengths, packed_choices, *, nf: int, L: int, shared_tape: bool,
    op_order: tuple | None = None,
):
    """Reverse-liveness action codes.

    w1s/w2s: [Tt, L] int32 tapes; lengths: [Tt] int32; packed_choices:
    [B, CW, S0, 128] int32 as produced by `interp_interval`.
    `shared_tape=True` evaluates tape row 0 for every instance b
    (Tt == 1); otherwise instance b uses tape row b (Tt == B).
    `op_order`: the opcode renumbering the tapes were packed with.
    Returns codes [B, ceil(L/16), S0, 128] int32, 16 per word.
    """
    B, cw, s0, _ = packed_choices.shape
    Tt = w1s.shape[0]
    if w1s.shape != (Tt, L) or w2s.shape != (Tt, L) or lengths.shape != (Tt,):
        raise ValueError("tapes must be [Tt, L] with lengths [Tt]")
    if Tt != (1 if shared_tape else B):
        raise ValueError(f"{Tt} tape rows for {B} instances")
    for t in (w1s, w2s, lengths, packed_choices):
        if t.dtype != torch.int32:
            raise ValueError("liveness_codes takes int32 tensors")
    if packed_choices.device.type == "cpu":
        return liveness_codes_plain(
            w1s, w2s, lengths, packed_choices, nf=nf, L=L,
            shared_tape=shared_tape, op_order=op_order,
        )
    cuda.check_cuda(w1s, w2s, lengths, packed_choices)
    if cw == 0:
        raise ValueError("liveness_codes needs at least one choice word")
    lanes = s0 * 128
    lw = -(-L // 16)
    codes = torch.empty(
        (B, lw, s0, 128), dtype=torch.int32, device=packed_choices.device
    )
    g = cuda.launch_geometry("liveness_codes", nf=nf, lanes=lanes, T=B, cw=cw)
    if not g.choices_shared and cw * lanes * 4 >= 2**31:
        raise ValueError(f"{cw} choice words of {lanes} lanes are too many")
    scratch = None
    if not g.regs_shared:
        if nf * lanes >= 2**31:
            raise ValueError(f"liveness plane [{nf}, {lanes}] is too large")
        scratch = torch.empty(
            (B, nf, lanes), dtype=torch.uint8, device=packed_choices.device
        )
    cuda.launch(
        "liveness_codes", w1s, w2s, lengths, packed_choices, codes, scratch,
        cuda.order_table(op_order, packed_choices.device),
        B, Tt, L, nf, cw, lanes, g.chunk, g.mask_words,
        int(g.choices_shared), g.smem,
    )
    return codes


def liveness_codes_plain(
    w1s, w2s, lengths, packed_choices, *, nf: int, L: int, shared_tape: bool,
    op_order: tuple | None = None,
):
    """Plain PyTorch version of `liveness_codes` (same contract)."""
    B, cw, s0, _ = packed_choices.shape
    dev = packed_choices.device
    lw = -(-L // 16)
    codes = torch.zeros((B, lw, s0, 128), dtype=torch.int32, device=dev)
    w1h, w2h, _, lensh = _host_tape(w1s, w2s, w1s, lengths)
    ones = torch.ones((s0, 128), dtype=torch.bool, device=dev)
    nope = torch.zeros_like(ones)
    for bi in range(B):
        tr = 0 if shared_tape else bi
        live = torch.zeros((nf, s0, 128), dtype=torch.bool, device=dev)
        for j in reversed(range(min(int(lensh[tr]), L))):
            op, o, a, b, aux = _decode(
                int(w1h[tr, j]), int(w2h[tr, j]), op_order
            )
            oc = min(o, nf - 1)
            is_choice = (CHOICE_MASK >> op) & 1 == 1
            a_is_reg = op != int(TapeOp.INPUT) and a != IMM12
            b_is_reg = (BINARY_MASK >> op) & 1 == 1 and b != IMM12
            executed = ones if op == int(TapeOp.OUTPUT) else live[oc]
            if is_choice:
                word = packed_choices[bi, min(aux // 16, cw - 1)]
                c = (word >> ((aux % 16) * 2)) & 3
                left, right = c == 1, c == 2
                both = (c == 3) | (c == 0)
            else:
                left, right, both = nope, nope, ones
            elide = executed & (
                (left if a == o else nope) | (right if b == o else nope)
            )
            emit = executed & ~elide
            code = torch.where(
                both, 1, torch.where(left, 2, 3)
            ).to(torch.int32) * emit
            codes[bi, j // 16] |= code << ((j % 16) * 2)
            live[oc] &= ~emit
            if a_is_reg:
                live[min(a, nf - 1)] |= emit & (both | left)
            if b_is_reg:
                live[min(b, nf - 1)] |= emit & (both | right)
    return codes


def per_lane_to_rows(perlane, n: int):
    """[B, LW, S0, 128] word-major lane codes -> [n, LW] per-lane rows
    (lanes in row-major order, the first n kept)."""
    B, lw, s0, _ = perlane.shape
    rows = perlane.reshape(B, lw, s0 * 128).transpose(1, 2)
    return rows.reshape(B * s0 * 128, lw)[:n]


def per_instance_codes(
    w1s, w2s, lengths, packed_choices, *, nf: int,
    op_order: tuple | None = None,
):
    """Per-lane action codes of per-instance tapes (the counterpart of
    `DynamicSimplifier.codes`): K2 with tape row t for instance t.

    w1s/w2s: [T, L] int32 tapes; lengths: [T]; packed_choices:
    [T, CW, S0, 128] from `interp_interval` over the same tapes.
    Returns per-lane packed words [T, S0*128, LW] (a view)."""
    T, L = w1s.shape
    s0 = packed_choices.shape[2]
    codes = liveness_codes(
        w1s, w2s, lengths, packed_choices, nf=nf, L=L, shared_tape=False,
        op_order=op_order,
    )
    return codes.reshape(T, -(-L // 16), s0 * 128).transpose(1, 2)


def unpack_codes(per_tile, L: int):
    """[T, LW] packed words -> [T, L] uint8 action codes."""
    idx = torch.arange(L, device=per_tile.device)
    words = per_tile[:, idx // 16]
    shift = ((idx % 16) * 2).to(torch.int32)
    return ((words >> shift[None, :]) & 3).to(torch.uint8)


def reconstruct(w1p, w2p, immp, codes, *, op_order: tuple | None = None):
    """Builds child arenas from parent rows + per-child action codes.

    w1p/w2p/immp: [TC, L] parent tape rows per child (may be broadcast
    views), packed under `op_order` (None: canonical); codes: [TC, L]
    uint8 action codes. The child rows keep the parents' numbering.
    Returns (w1, w2, imm, lengths, n_choices): compacted [TC, L] arenas
    whose kept rows keep their order, surviving choice ops re-indexed
    in `aux`, and zeros past each length.
    """
    TC, L = codes.shape
    w1p = w1p.to(torch.int32)
    w2p = w2p.to(torch.int32)
    op = w1p & 127
    out = (w1p >> 7) & 0xFFF
    a = (w1p >> 19) & 0xFFF
    b = w2p & 0xFFF
    codes = codes.to(torch.int32)
    keep = codes > 0
    rank = _op_rank(op_order) if op_order is not None else None
    copy = int(TapeOp.COPY) if rank is None else int(rank[int(TapeOp.COPY)])
    copy_a = copy | (out << 7) | (a << 19)
    copy_b = copy | (out << 7) | (b << 19)
    w1_new = torch.where(
        codes == 1, w1p, torch.where(codes == 2, copy_a, copy_b)
    )
    w2_new = torch.where(codes == 1, w2p, torch.zeros_like(w2p))
    choice_at = sorted(
        int(o) if rank is None else int(rank[int(o)]) for o in CHOICE_TAPE_OPS
    )
    is_choice = (
        (op == choice_at[0]) | (op == choice_at[1])
        | (op == choice_at[2]) | (op == choice_at[3])
    )
    kept_choice = (codes == 1) & is_choice
    new_cidx = (torch.cumsum(kept_choice, dim=1, dtype=torch.int32) - 1)
    w2_new = torch.where(kept_choice, b | (new_cidx << 12), w2_new)
    n_choices = kept_choice.sum(dim=1, dtype=torch.int32)
    lengths = keep.sum(dim=1, dtype=torch.int32)
    # stable partition as a permutation: kept row j goes to (kept rows
    # before j), dropped row j to lengths + (dropped rows before j);
    # dropped rows carry zeros, so everything past a length is 0
    kept_before = torch.cumsum(keep, dim=1) - 1
    dest = torch.where(
        keep, kept_before, lengths[:, None] + torch.arange(L, device=codes.device)
        - kept_before - 1,
    )

    def compact(x, dtype):
        x = torch.where(keep, x.to(dtype), torch.zeros((), dtype=dtype,
                                                       device=codes.device))
        return torch.empty((TC, L), dtype=dtype, device=codes.device).scatter_(
            1, dest, x
        )

    return (
        compact(w1_new, torch.int32), compact(w2_new, torch.int32),
        compact(immp, torch.float32), lengths, n_choices,
    )


class DeviceSimplifier:
    """Batched simplifier for one parent tape.

    Usage:
      ds = DeviceSimplifier(tape, device="cpu")
      w1, w2, imm, lengths, n_choices = ds(choices)   # choices: [T, C]

    Operand-use flags come from the CANONICAL encoding of the tape; the
    child arenas it emits (`w1`, the COPY rewrites) use the renumbered
    one when `op_order` is given, so they feed kernels called with the
    same `op_order`. `device`: None means CUDA, and raises when there is
    no card.
    """

    def __init__(self, tape: Tape, op_order: tuple | None = None, *,
                 device=None):
        self.device = cuda.resolve_device(device)
        w1c, w2, _ = pack_rows(tape)
        packed = pack_tapes([tape], op_order=op_order)
        self.parent = tape
        self.op_order = op_order
        self.nf = tape.reg_count + tape.mem_count
        self.n_choices = tape.choice_count
        self.L = len(tape)
        op = w1c & 127
        out = (w1c >> 7) & 0xFFF
        a = (w1c >> 19) & 0xFFF
        b = w2 & 0xFFF
        aux = w2 >> 12
        is_choice = np.isin(op, [int(o) for o in CHOICE_TAPE_OPS])
        unary_like = np.isin(
            op, [int(TapeOp.COPY)] + [int(u) for u in UNARY_TAPE_OPS]
        )
        binary_like = np.isin(op, [int(o) for o in BINARY_TAPE_OPS])
        is_output = op == int(TapeOp.OUTPUT)
        #: static per-row facts of the scan path (host arrays)
        self._st = dict(
            out=out, a=a, b=b,
            cidx=np.where(is_choice, aux, 0),
            is_choice=is_choice,
            is_output=is_output,
            a_is_reg=(unary_like | binary_like | is_output) & (a != IMM12),
            b_is_reg=binary_like & ~unary_like & (b != IMM12),
        )
        #: the parent rows [1, L] on the device, in the emitted numbering
        self.arena = tuple(
            torch.from_numpy(x).to(self.device)
            for x in (packed.w1, packed.w2, packed.imm)
        )
        self._lengths = torch.full(
            (1,), self.L, dtype=torch.int32, device=self.device
        )

    # ------------------------------------------------------------------
    # liveness -> per-(tile, op) action codes

    def _codes_scan(self, choices):
        """Scan path: a reverse walk over the tape on the host, each step
        plain tensor ops over the tile axis. The renderers take the
        packed path (`codes_per_tile`, K2); this one serves callers that
        hold unpacked `[T, C]` traces and is what the packed path is
        tested against.

        choices: [T, C] integer choice codes. Returns [T, L] uint8."""
        st = self._st
        dev = self.device
        T = choices.shape[0]
        choices = choices.to(device=dev, dtype=torch.int32)
        if self.n_choices == 0:
            choices = torch.zeros((T, 1), dtype=torch.int32, device=dev)
        live = torch.zeros((T, self.nf), dtype=torch.bool, device=dev)
        codes = torch.zeros((T, self.L), dtype=torch.uint8, device=dev)
        ones = torch.ones((T,), dtype=torch.bool, device=dev)
        nope = torch.zeros_like(ones)
        for j in reversed(range(self.L)):
            out, a, b = int(st["out"][j]), int(st["a"][j]), int(st["b"][j])
            executed = ones if st["is_output"][j] else live[:, out]
            if st["is_choice"][j]:
                c = choices[:, int(st["cidx"][j])]
                left, right = c == 1, c == 2
                both = (c == 3) | (c == 0)
            else:
                left, right, both = nope, nope, ones
            elide = executed & (
                (left if a == out else nope) | (right if b == out else nope)
            )
            emit = executed & ~elide
            codes[:, j] = torch.where(
                both, 1, torch.where(left, 2, 3)
            ).to(torch.uint8) * emit
            live[:, out] &= ~emit
            if st["a_is_reg"][j]:
                live[:, a] |= emit & (both | left)
            if st["b_is_reg"][j]:
                live[:, b] |= emit & (both | right)
        return codes

    def _reconstruct(self, codes):
        """codes: [T, L] uint8 action codes -> packed child arenas."""
        w1, w2, imm = self.arena
        return reconstruct(w1, w2, imm, codes, op_order=self.op_order)

    # ------------------------------------------------------------------
    # public entry points

    def __call__(self, choices):
        """choices: [T, C] choice codes -> packed child arenas (w1, w2,
        imm, lengths, n_choices), by the scan path."""
        return self._reconstruct(self._codes_scan(choices))

    def codes_per_tile(self, packed_choices, *, n_tiles: int):
        """Packed-choice path (K2 over the shared parent tape).

        packed_choices: [B, CW, S0, 128] int32 straight from
        `interp_interval`; tiles are lanes in row-major order. Returns
        [n_tiles, LW] packed action-code words."""
        w1, w2, _ = self.arena
        perlane = liveness_codes(
            w1, w2, self._lengths, packed_choices, nf=self.nf, L=self.L,
            shared_tape=True, op_order=self.op_order,
        )
        return per_lane_to_rows(perlane, n_tiles)

    def simplify_packed(self, packed_choices, *, n_tiles: int):
        """Like `codes_per_tile`, then materializes compacted child
        tapes (needed when children feed further interval levels)."""
        per_tile = self.codes_per_tile(packed_choices, n_tiles=n_tiles)
        return self._reconstruct(unpack_codes(per_tile, self.L))
