"""Value-mode arithmetic for tape evaluation.

Two value modes, each defined over an array namespace `xp` that is
either `torch` (the plain versions of the interpreter kernels) or
`numpy` (the host oracle behind `render_brute`):

- **float**: plain f32 arrays (point + bulk float-slice evaluation).
- **interval**: `(lower, upper)` array pairs with conservative range
  semantics matching fidget-core/src/types/interval.rs exactly,
  including NaN poisoning, quadrant-aware sin/cos, and 2-bit `Choice`
  capture for min/max/and/or (interval.rs:295-381).

This is `fidget_tpu.eval.arith` with the numpy-only idioms (`astype`,
scalar-only `where`) replaced by forms both namespaces share. The CUDA
kernels (csrc/ops.cuh) transcribe the same rules op by op. Unlike the
TPU kernels, nothing here needs the polynomial arctangent or fmod of
`fidget_tpu.eval.softmath`: both namespaces have native ones.

Choice codes: 1=Left, 2=Right, 3=Both (fidget-core/src/vm/choice.rs).
"""

from __future__ import annotations

import math

import numpy as np

from ..compiler.tape import CHOICE_BOTH, CHOICE_LEFT, CHOICE_RIGHT, TapeOp

F32PI = float(np.float32(np.pi))
F32TAU = float(np.float32(2 * np.pi))


def _rmin(xp, a, b):
    """Rust f32::min — ignores NaN unless both are NaN."""
    return xp.where(xp.isnan(a), b, xp.where(xp.isnan(b), a, xp.minimum(a, b)))


def _rmax(xp, a, b):
    return xp.where(xp.isnan(a), b, xp.where(xp.isnan(b), a, xp.maximum(a, b)))


def _nan_like(xp, a):
    return xp.full_like(a, math.nan)


def _round(xp, a):
    """Round half away from zero (Rust f32::round), not banker's.
    |a| >= 2^23: every f32 is already an integer, and the a±0.5 idiom
    would corrupt odd values (the f32 addition itself rounds
    ties-to-even) — return a unchanged."""
    r = xp.where(a >= 0, xp.floor(a + 0.5), xp.ceil(a - 0.5))
    return xp.where(xp.abs(a) >= 2.0**23, a, r)


def _codes(xp, like, *pairs):
    """Nested select of int32 2-bit choice codes: `pairs` are
    (mask, code) tried in order; the last entry is the default code."""
    *conds, default = pairs
    out = xp.full_like(like, default, dtype=xp.int32)
    for mask, code in reversed(conds):
        out = xp.where(mask, xp.full_like(out, code), out)
    return out


# ======================================================================
# float mode


class FloatMode:
    """Plain f32 evaluation (point / float-slice semantics)."""

    planes = 1

    def __init__(self, xp):
        self.xp = xp

    def const(self, imm, like):
        return self.xp.full_like(like, imm)

    def unary(self, op: TapeOp, a):
        xp = self.xp
        U = TapeOp
        if op == U.NEG:
            return -a
        if op == U.ABS:
            return xp.abs(a)
        if op == U.RECIP:
            return 1.0 / a
        if op == U.SQRT:
            return xp.sqrt(a)
        if op == U.SQUARE:
            return a * a
        if op == U.FLOOR:
            return xp.floor(a)
        if op == U.CEIL:
            return xp.ceil(a)
        if op == U.ROUND:
            return _round(xp, a)
        if op == U.SIN:
            return xp.sin(a)
        if op == U.COS:
            return xp.cos(a)
        if op == U.TAN:
            return xp.tan(a)
        if op == U.ASIN:
            return xp.arcsin(a)
        if op == U.ACOS:
            return xp.arccos(a)
        if op == U.ATAN:
            return xp.arctan(a)
        if op == U.EXP:
            return xp.exp(a)
        if op == U.LN:
            return xp.log(a)
        if op == U.NOT:
            return xp.where(a == 0.0, xp.ones_like(a), xp.zeros_like(a))
        raise ValueError(op)

    def binary(self, op: TapeOp, a, b):
        """Non-choice binary ops."""
        xp = self.xp
        B = TapeOp
        if op == B.ADD:
            return a + b
        if op == B.SUB:
            return a - b
        if op == B.MUL:
            return a * b
        if op == B.DIV:
            return a / b
        if op == B.ATAN2:
            return xp.arctan2(a, b)
        if op == B.COMPARE:
            nan = xp.isnan(a) | xp.isnan(b)
            zero = xp.zeros_like(a + b)
            cmp = xp.where(a < b, zero - 1.0, xp.where(a > b, zero + 1.0, zero))
            return xp.where(nan, _nan_like(xp, cmp), cmp)
        if op == B.MOD:
            # rem_euclid (Rust): r = fmod(a, b); r < 0 -> r + |b|
            r = xp.fmod(a, b)
            return xp.where(r < 0, r + xp.abs(b), r)
        raise ValueError(op)

    def choice_binary(self, op: TapeOp, a, b):
        """Choice ops: returns (value, choice codes) with point semantics
        (fidget-core/src/vm/mod.rs:665-851): strict comparison picks a
        side; ties and NaN produce Both (and NaN on NaN inputs)."""
        xp = self.xp
        B = TapeOp
        if op in (B.MIN, B.MAX):
            if op == B.MIN:
                left = a < b
                right = b < a
            else:
                left = a > b
                right = b > a
            nan = xp.isnan(a) | xp.isnan(b)
            tie_val = xp.where(nan, _nan_like(xp, b), b)
            value = xp.where(left, a, xp.where(right, b, tie_val))
            choice = _codes(
                xp, a, (left, CHOICE_LEFT), (right, CHOICE_RIGHT), CHOICE_BOTH
            )
            return value, choice
        if op == B.AND:
            left = a == 0.0
        elif op == B.OR:
            left = a != 0.0
        else:
            raise ValueError(op)
        value = xp.where(left, a, b)
        return value, _codes(xp, a, (left, CHOICE_LEFT), CHOICE_RIGHT)


# ======================================================================
# interval mode


class IntervalMode:
    """Interval arithmetic over (lower, upper) array pairs."""

    planes = 2

    def __init__(self, xp):
        self.xp = xp

    def const(self, imm, like):
        v = self.xp.full_like(like[0], imm)
        return (v, v)

    def has_nan(self, a):
        return self.xp.isnan(a[0]) | self.xp.isnan(a[1])

    def _poison(self, nan, lo, hi):
        n = _nan_like(self.xp, lo)
        return (self.xp.where(nan, n, lo), self.xp.where(nan, n, hi))

    def unary(self, op: TapeOp, a):
        xp = self.xp
        U = TapeOp
        al, au = a
        if op == U.NEG:
            return (-au, -al)
        if op == U.ABS:
            # interval.rs:67-78
            lo = xp.where(al < 0, xp.where(au > 0, xp.zeros_like(al), -au), al)
            hi = xp.where(al < 0, xp.where(au > 0, xp.maximum(au, -al), -al), au)
            return (lo, hi)
        if op == U.RECIP:
            ok = (al > 0) | (au < 0)
            return self._poison(~ok, 1.0 / au, 1.0 / al)
        if op == U.SQRT:
            return self._poison(al < 0, xp.sqrt(al), xp.sqrt(au))
        if op == U.SQUARE:
            # interval.rs:82-94
            lo2, hi2 = al * al, au * au
            m = xp.maximum(xp.abs(al), xp.abs(au))
            mixed_hi = m * m
            lo = xp.where(au < 0, hi2, xp.where(al > 0, lo2, xp.zeros_like(al)))
            hi = xp.where(au < 0, lo2, xp.where(al > 0, hi2, mixed_hi))
            return self._poison(self.has_nan(a), lo, hi)
        if op == U.FLOOR:
            return (xp.floor(al), xp.floor(au))
        if op == U.CEIL:
            return (xp.ceil(al), xp.ceil(au))
        if op == U.ROUND:
            return (_round(xp, al), _round(xp, au))
        if op == U.SIN:
            return self._sin_cos(a, is_sin=True)
        if op == U.COS:
            return self._sin_cos(a, is_sin=False)
        if op == U.TAN:
            # interval.rs:207-221
            tl, tu = xp.tan(al), xp.tan(au)
            bad = (au - al >= F32PI) | ~(tu >= tl)
            return self._poison(bad, tl, tu)
        if op == U.ASIN:
            bad = (al < -1.0) | (au > 1.0)
            return self._poison(bad, xp.arcsin(al), xp.arcsin(au))
        if op == U.ACOS:
            bad = (al < -1.0) | (au > 1.0)
            return self._poison(bad, xp.arccos(au), xp.arccos(al))
        if op == U.ATAN:
            return (xp.arctan(al), xp.arctan(au))
        if op == U.EXP:
            return (xp.exp(al), xp.exp(au))
        if op == U.LN:
            return self._poison(~(al > 0.0), xp.log(al), xp.log(au))
        if op == U.NOT:
            # vm/mod.rs:400-408
            no_zero = ~((al <= 0.0) & (au >= 0.0)) & ~self.has_nan(a)
            exactly_zero = (al == 0.0) & (au == 0.0)
            one, zero = xp.ones_like(al), xp.zeros_like(al)
            lo = xp.where(exactly_zero, one, zero)
            hi = xp.where(no_zero, zero, one)
            hi = xp.where(exactly_zero, one, hi)
            return (lo, hi)
        raise ValueError(op)

    def _sin_cos(self, a, is_sin: bool):
        """Quadrant-aware sin/cos bounds (interval.rs:109-204)."""
        xp = self.xp
        al, au = a
        fl, fu = (xp.sin(al), xp.sin(au)) if is_sin else (xp.cos(al), xp.cos(au))

        def quadrant(v):
            # floor(v / (pi/2)) rem_euclid 4, kept in f32. A NaN quadrant
            # (v = ±inf) reads as 0, the f32 -> i32 conversion of XLA and
            # of the CUDA kernels; every such lane is overridden below.
            q = xp.floor(v * (2.0 / F32PI))
            q = q - xp.floor(q / 4.0) * 4.0
            return xp.where(xp.isnan(q), xp.zeros_like(q), q)

        lq, uq = quadrant(al), quadrant(au)
        d = au - al

        # Case kinds: 0=INC(full if d>=pi), 1=DEC(full if d>=pi),
        # 2=[min(f_l,f_u), 1], 3=[-1, max(f_l,f_u)], 4=full.
        # sin increases in quadrants {Q3, Q0}, cos in {Q2, Q3}; crossing
        # from an increasing to a decreasing quadrant caps the max at 1,
        # the reverse caps the min at -1; wrapping all the way around
        # ((Q0,Q3) / (Q2,Q1) for sin) loses all information.
        if is_sin:
            a_inc = (lq == 0) | (lq == 3)
            b_inc = (uq == 0) | (uq == 3)
            full_ii = (lq == 0) & (uq == 3)
            full_dd = (lq == 2) & (uq == 1)
        else:
            a_inc = lq >= 2
            b_inc = uq >= 2
            full_ii = (lq == 3) & (uq == 2)
            full_dd = (lq == 1) & (uq == 0)
        inc = a_inc & b_inc & ~full_ii
        dec = ~a_inc & ~b_inc & ~full_dd
        up = a_inc & ~b_inc  # kind 2: [min(f_l, f_u), 1]
        down = ~a_inc & b_inc  # kind 3: [-1, max(f_l, f_u)]

        one = xp.ones_like(al)
        wide = d >= F32PI
        inc_lo = xp.where(wide, -one, fl)
        inc_hi = xp.where(wide, one, fu)
        dec_lo = xp.where(wide, -one, fu)
        dec_hi = xp.where(wide, one, fl)

        lo = xp.where(
            inc, inc_lo,
            xp.where(dec, dec_lo, xp.where(up, xp.minimum(fl, fu), -one)),
        )
        hi = xp.where(
            inc, inc_hi,
            xp.where(dec, dec_hi, xp.where(down, xp.maximum(fl, fu), one)),
        )
        full = d >= F32TAU
        lo = xp.where(full, -one, lo)
        hi = xp.where(full, one, hi)
        return self._poison(self.has_nan(a), lo, hi)

    def binary(self, op: TapeOp, a, b):
        xp = self.xp
        B = TapeOp
        al, au = a
        bl, bu = b
        nan = self.has_nan(a) | self.has_nan(b)
        if op == B.ADD:
            return (al + bl, au + bu)
        if op == B.SUB:
            return (al - bu, au - bl)
        if op == B.MUL:
            p0, p1, p2, p3 = al * bl, al * bu, au * bl, au * bu
            lo = _rmin(xp, _rmin(xp, _rmin(xp, p0, p1), p2), p3)
            hi = _rmax(xp, _rmax(xp, _rmax(xp, p0, p1), p2), p3)
            return self._poison(nan, lo, hi)
        if op == B.DIV:
            ok = (bl > 0) | (bu < 0)
            q0, q1, q2, q3 = al / bl, al / bu, au / bl, au / bu
            lo = _rmin(xp, _rmin(xp, _rmin(xp, q0, q1), q2), q3)
            hi = _rmax(xp, _rmax(xp, _rmax(xp, q0, q1), q2), q3)
            # NaN in EITHER operand poisons (a half-NaN divisor can pass
            # the sign test: e.g. [2,4]/[1,NaN] must not return [2,4])
            return self._poison(~ok | nan, lo, hi)
        if op == B.ATAN2:
            # interval.rs:488-553: branch cut check, else corner extremes
            c0, c1 = xp.arctan2(al, bl), xp.arctan2(al, bu)
            c2, c3 = xp.arctan2(au, bl), xp.arctan2(au, bu)
            lo = _rmin(xp, _rmin(xp, _rmin(xp, c0, c1), c2), c3)
            hi = _rmax(xp, _rmax(xp, _rmax(xp, c0, c1), c2), c3)
            cut = (al <= 0.0) & (au >= 0.0) & (bl < 0.0)
            pi = xp.full_like(al, F32PI)
            lo = xp.where(cut, -pi, lo)
            hi = xp.where(cut, pi, hi)
            return self._poison(nan, lo, hi)
        if op == B.COMPARE:
            # vm/mod.rs:488-521
            lt = au < bl
            gt = al > bu
            one = xp.ones_like(al)
            lo = xp.where(gt & ~lt, one, -one)
            hi = xp.where(lt, -one, one)
            return self._poison(nan, lo, hi)
        if op == B.MOD:
            # interval.rs:448-466 (rem_euclid)
            abs_hi = xp.maximum(xp.abs(bl), xp.abs(bu))  # |rhs|.upper
            qa = al / bl
            qb = au / bl
            const_pos = (bl == bu) & (bl > 0)
            same_floor = (qa != xp.floor(qa)) & (xp.floor(qa) == xp.floor(qb))
            fm = FloatMode(xp)
            exact_lo = fm.binary(B.MOD, al, bl)
            exact_hi = fm.binary(B.MOD, au, bl)
            use_exact = const_pos & same_floor
            lo = xp.where(use_exact, exact_lo, xp.zeros_like(al))
            hi = xp.where(use_exact, exact_hi, abs_hi)
            bad = nan | ((bl <= 0.0) & (bu >= 0.0))
            return self._poison(bad, lo, hi)
        raise ValueError(op)

    def choice_binary(self, op: TapeOp, a, b):
        """Choice ops (interval.rs:295-381): returns (value, choices)."""
        xp = self.xp
        B = TapeOp
        al, au = a
        bl, bu = b
        nan = self.has_nan(a) | self.has_nan(b)
        if op in (B.MIN, B.MAX):
            if op == B.MIN:
                left = au < bl
                right = bu < al
                lo, hi = xp.minimum(al, bl), xp.minimum(au, bu)
            else:
                left = al > bu
                right = bl > au
                lo, hi = xp.maximum(al, bl), xp.maximum(au, bu)
            choice = _codes(
                xp, al, (nan, CHOICE_BOTH), (left, CHOICE_LEFT),
                (right, CHOICE_RIGHT), CHOICE_BOTH,
            )
            return self._poison(nan, lo, hi), choice
        zero = (al == 0.0) & (au == 0.0)
        nonzero = ~((al <= 0.0) & (au >= 0.0))
        if op == B.AND:
            # an unambiguous 0 in lhs selects itself; no 0 selects rhs
            z = xp.zeros_like(al)
            lo = xp.where(zero, z, xp.where(nonzero, bl, xp.minimum(bl, z)))
            hi = xp.where(zero, z, xp.where(nonzero, bu, xp.maximum(bu, z)))
            choice = _codes(
                xp, al, (nan, CHOICE_BOTH), (zero, CHOICE_LEFT),
                (nonzero, CHOICE_RIGHT), CHOICE_BOTH,
            )
            return self._poison(nan, lo, hi), choice
        if op == B.OR:
            lo = xp.where(nonzero, al, xp.where(zero, bl, xp.minimum(al, bl)))
            hi = xp.where(nonzero, au, xp.where(zero, bu, xp.maximum(au, bu)))
            choice = _codes(
                xp, al, (nan, CHOICE_BOTH), (nonzero, CHOICE_LEFT),
                (zero, CHOICE_RIGHT), CHOICE_BOTH,
            )
            return self._poison(nan, lo, hi), choice
        raise ValueError(op)
