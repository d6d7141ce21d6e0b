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

The counterparts of `fidget_tpu.eval.simplify_device._liveness_codes`,
`DeviceSimplifier.unpack_codes` and `DynamicSimplifier.reconstruct`.
Because a child tape is always a subsequence of its parent, the child
arena capacity equals the parent's and overflow cannot occur.
"""

from __future__ import annotations

import torch

from ..compiler.pack import IMM12
from ..compiler.tape import BINARY_MASK, CHOICE_MASK, TapeOp
from . import cuda
from .interp import _decode, _host_tape


def liveness_codes(
    w1s, w2s, lengths, packed_choices, *, nf: int, L: int, shared_tape: bool,
):
    """Reverse-liveness action codes.

    w1s/w2s: [Tt, L] int32 tapes; lengths: [Tt] int32; packed_choices:
    [B, CW, S0, 128] int32 as produced by `interp_interval`.
    `shared_tape=True` evaluates tape row 0 for every instance b
    (Tt == 1); otherwise instance b uses tape row b (Tt == B).
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
            shared_tape=shared_tape,
        )
    cuda.check_cuda(w1s, w2s, lengths, packed_choices)
    lanes = s0 * 128
    lw = -(-L // 16)
    codes = torch.empty(
        (B, lw, s0, 128), dtype=torch.int32, device=packed_choices.device
    )
    scratch = None
    if nf * cuda.BLOCK > cuda.SMEM_LIMIT:
        scratch = torch.empty(
            (B, nf, lanes), dtype=torch.uint8, device=packed_choices.device
        )
    cuda.launch(
        "liveness_codes", w1s, w2s, lengths, packed_choices, codes, scratch,
        B, Tt, L, nf, cw, lanes,
    )
    return codes


def liveness_codes_plain(
    w1s, w2s, lengths, packed_choices, *, nf: int, L: int, shared_tape: bool,
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
            op, o, a, b, aux = _decode(int(w1h[tr, j]), int(w2h[tr, j]))
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


def unpack_codes(per_tile, L: int):
    """[T, LW] packed words -> [T, L] uint8 action codes."""
    idx = torch.arange(L, device=per_tile.device)
    words = per_tile[:, idx // 16]
    shift = ((idx % 16) * 2).to(torch.int32)
    return ((words >> shift[None, :]) & 3).to(torch.uint8)


def reconstruct(w1p, w2p, immp, codes):
    """Builds child arenas from parent rows + per-child action codes.

    w1p/w2p/immp: [TC, L] parent tape rows per child (canonical op
    order; may be broadcast views); codes: [TC, L] uint8 action codes.
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
    copy = int(TapeOp.COPY)
    copy_a = copy | (out << 7) | (a << 19)
    copy_b = copy | (out << 7) | (b << 19)
    w1_new = torch.where(
        codes == 1, w1p, torch.where(codes == 2, copy_a, copy_b)
    )
    w2_new = torch.where(codes == 1, w2p, torch.zeros_like(w2p))
    is_choice = (
        (op == int(TapeOp.MIN)) | (op == int(TapeOp.MAX))
        | (op == int(TapeOp.AND)) | (op == int(TapeOp.OR))
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
