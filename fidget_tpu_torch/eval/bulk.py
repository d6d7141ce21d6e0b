"""Bulk flat-array evaluation.

The counterpart of `fidget_tpu.eval.bulk.BulkEvaluator`: it wraps the
tape interpreters for consumers that hold flat point lists (the mesher,
later the solver) rather than renderer-shaped lane planes. Points are
padded into `[T, S0, 128]` lane blocks, one instance per block, with a
power-of-two `T` and the instances past the last point at length 0;
the one tape is copied over the `T` instances, since the kernels take
one contiguous arena row per instance.

Evaluation is always batched; there is no scalar path (the reference's
`BulkEvaluator` trait, fidget-core/src/eval/bulk.rs:23-58). Inputs and
outputs are tensors on the evaluator's device: point mode runs K3
(`interp_float`), interval mode K1 (`interp_interval`) and the spatial
gradient K4 (`interp_grad`), or their plain versions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.pack import frequency_op_order, pack_tapes
from ..compiler.tape import Tape
from . import cuda
from .interp import interp_float, interp_grad, interp_interval

#: rows of 128 lanes in one instance's lane block. The reference sizes
#: it to a TPU VMEM budget (fidget_tpu/eval/bulk.py:48-53); on the card
#: a block's register file is sized by the tape's registers, not by S0
#: (`cuda.launch_geometry`), so S0 only sets how many instances share a
#: call's lanes, and so how many copies of the tape it materializes.
#: 64 rows (8,192 lanes: 16 blocks of K3 at 4 lanes a thread, 32 of K4
#: at 2, 64 of K1) keep that copy to 12 bytes a tape row per 8,192
#: points, while a call of a few points pads to no more than 8,192.
LANE_ROWS = 64


def _bucket(n_lanes: int, s0: int) -> tuple[int, int]:
    """(T, used): a power-of-two instance count covering `n_lanes`, and
    the instances that hold lanes."""
    used = -(-max(1, n_lanes) // (s0 * 128))
    return 1 << (used - 1).bit_length(), used


class BulkEvaluator:
    """Bulk evaluator of one tape in point, interval and gradient modes.

    Args:
      tape: the tape to evaluate.
      device: evaluation device; None means CUDA, and raises when there
        is no card. Pass "cpu" for the plain PyTorch versions.

    The arena is packed at the tape's own length under its
    `frequency_op_order`, and the kernels get the tape's own registers
    (`nf`), as the reference does outside interpret mode
    (fidget_tpu/eval/bulk.py:154-156).
    """

    def __init__(self, tape: Tape, *, device=None):
        self.tape = tape
        self.device = cuda.resolve_device(device)
        self.op_order = frequency_op_order(tape)
        self.packed = pack_tapes([tape], op_order=self.op_order)
        self.nf = tape.reg_count + tape.mem_count
        # padded to >= 1 so constant-only tapes still build var planes
        self.n_inputs = max(1, len(tape.var_map))
        self.n_outputs = tape.output_count
        self.c_words = max(1, -(-tape.choice_count // 16))
        self.axis_of = {v.kind: i for v, i in tape.var_map.items()}
        p = self.packed
        self._arena = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (p.w1, p.w2, p.imm, p.lengths)
        )
        self._arena_T = {}

    # ------------------------------------------------------------------

    def tape_args(self, T: int, used: int):
        """(w1, w2, imm, lengths) of the tape copied over T instances,
        the instances from `used` on at length 0. Kept per T: a mesh
        build calls with a handful of instance counts."""
        key = (T, used)
        args = self._arena_T.get(key)
        if args is None:
            w1, w2, imm, lens = self._arena
            lengths = torch.where(
                torch.arange(T, device=self.device) < used, lens.expand(T),
                torch.zeros_like(lens),
            ).to(torch.int32)
            args = tuple(
                a.expand(T, a.shape[1]).contiguous() for a in (w1, w2, imm)
            ) + (lengths.contiguous(),)
            if len(self._arena_T) >= 8:
                self._arena_T.pop(next(iter(self._arena_T)))
            self._arena_T[key] = args
        return args

    def _flat(self, a) -> torch.Tensor:
        """A flat f32 tensor on the evaluator's device."""
        t = torch.as_tensor(a, dtype=torch.float32, device=self.device)
        return t.reshape(-1)

    def _var_values(self, var_vec) -> torch.Tensor:
        """[n_inputs] f32 values of the non-axis inputs (0 where unset)."""
        v = torch.zeros(self.n_inputs, dtype=torch.float32, device=self.device)
        if var_vec is not None:
            vv = self._flat(var_vec)
            k = min(vv.numel(), self.n_inputs)
            v[:k] = vv[:k]
        return v

    def _planes(self, axes, var_vec, n, *, duals=False):
        """Input planes for `n` points: `axes` maps an axis kind to a
        flat [n] tensor (or, with `duals`, a [4, n] dual plane); the
        other inputs take their `var_vec` value on every lane (a zero
        tangent). Returns (planes [T, V, (4,) S0, 128], T, used)."""
        s0 = LANE_ROWS
        T, used = _bucket(n, s0)
        lanes = T * s0 * 128
        V = self.n_inputs
        vals = self._var_values(var_vec)
        if duals:
            out = torch.zeros((V, 4, lanes), dtype=torch.float32,
                              device=self.device)
            out[:, 0] = vals[:, None]
        else:
            out = vals[:, None].repeat(1, lanes)
        for kind, a in axes.items():
            idx = self.axis_of.get(kind)
            if idx is not None:
                out[idx, ..., :n] = a
        # [V, (4,) T, S0, 128] -> [T, V, (4,) S0, 128]
        out = out.reshape(out.shape[:-1] + (T, s0, 128))
        out = out.movedim(-3, 0).contiguous()
        return out, T, used

    # ------------------------------------------------------------------

    def eval(self, x, y, z, var_vec=None, *, signs: bool = False):
        """Point mode over flat arrays: [n_outputs, N] f32 on the
        evaluator's device; with `signs=True` bool occupancy
        (value < 0) instead."""
        x, y, z = self._flat(x), self._flat(y), self._flat(z)
        n = x.numel()
        vars_, T, used = self._planes({"x": x, "y": y, "z": z}, var_vec, n)
        out = interp_float(
            *self.tape_args(T, used), vars_, nf=self.nf,
            n_inputs=self.n_inputs, n_outputs=self.n_outputs, s0=LANE_ROWS,
            op_order=self.op_order,
        )
        out = out.movedim(1, 0).reshape(self.n_outputs, -1)[:, :n]
        return out < 0.0 if signs else out

    def eval_interval(self, xi, yi, zi, var_vec=None, *, capture=False,
                      classify=False):
        """Interval mode over flat (lo, hi) arrays.

        Returns (lo, hi) [O, N], or bool [O, N] "active" (not provably
        empty or full) with `classify=True`. `capture=True` appends the
        packed per-lane choice words [T, CW, S0, 128] and the lane
        geometry (S0, N), as the reference returns them."""
        lo = {k: self._flat(a[0]) for k, a in zip("xyz", (xi, yi, zi))}
        hi = {k: self._flat(a[1]) for k, a in zip("xyz", (xi, yi, zi))}
        n = lo["x"].numel()
        var_lo, T, used = self._planes(lo, var_vec, n)
        var_hi, _, _ = self._planes(hi, var_vec, n)
        olo, ohi, choices = interp_interval(
            *self.tape_args(T, used), var_lo, var_hi, nf=self.nf,
            n_inputs=self.n_inputs, n_outputs=self.n_outputs, s0=LANE_ROWS,
            c_words=self.c_words, op_order=self.op_order,
        )
        olo = olo.movedim(1, 0).reshape(self.n_outputs, -1)[:, :n]
        ohi = ohi.movedim(1, 0).reshape(self.n_outputs, -1)[:, :n]
        out = ~((olo > 0.0) | (ohi < 0.0)) if classify else (olo, ohi)
        if capture:
            return out, choices, (LANE_ROWS, n)
        return out

    def eval_grad(self, x, y, z, var_vec=None):
        """Forward duals seeded on the spatial axes: [O, 4, N] f32
        (value, d/dx, d/dy, d/dz)."""
        x, y, z = self._flat(x), self._flat(y), self._flat(z)
        n = x.numel()
        axes = {}
        for k, (kind, a) in enumerate((("x", x), ("y", y), ("z", z))):
            d = a.new_zeros((4, n))
            d[0] = a
            d[1 + k] = 1.0
            axes[kind] = d
        vars_, T, used = self._planes(axes, var_vec, n, duals=True)
        g = interp_grad(
            *self.tape_args(T, used), vars_, nf=self.nf,
            n_inputs=self.n_inputs, n_outputs=self.n_outputs, s0=LANE_ROWS,
            op_order=self.op_order,
        )  # [T, O, 4, S0, 128]
        return g.permute(1, 2, 0, 3, 4).reshape(self.n_outputs, 4, -1)[:, :, :n]
