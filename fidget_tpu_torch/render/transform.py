"""Homogeneous 4x4 transform helpers for point and interval planes.

The analog of the reference's `Transformable` input wrapper
(fidget-core/src/shape/mod.rs:894-948): coordinates are transformed
*outside* the tape, in batched tensor ops, rather than by prepending
ops to every tape. The counterpart of `fidget_tpu.render.transform`;
works on torch tensors and on numpy arrays alike.
"""

from __future__ import annotations

from ..compiler.tape import TapeOp


def transform_points(mat, x, y, z):
    """(x, y, z, 1) -> model (x, y, z) with perspective divide.

    All of x/y/z may be arrays or scalars (broadcast together); `mat`
    is a [4, 4] array.
    """

    def row(r):
        return mat[r, 0] * x + mat[r, 1] * y + mat[r, 2] * z + mat[r, 3]

    w = row(3)
    return row(0) / w, row(1) / w, row(2) / w


def transform_intervals(im, mat, xi, yi, zi):
    """Interval version. The w row goes through interval division,
    which is exact for affine matrices (w == [1, 1]) and correctly
    widens under perspective."""

    def row(r):
        mx = im.binary(TapeOp.MUL, xi, (mat[r, 0], mat[r, 0]))
        my = im.binary(TapeOp.MUL, yi, (mat[r, 1], mat[r, 1]))
        mz = im.binary(TapeOp.MUL, zi, (mat[r, 2], mat[r, 2]))
        s = im.binary(TapeOp.ADD, im.binary(TapeOp.ADD, mx, my), mz)
        return im.binary(TapeOp.ADD, s, (mat[r, 3], mat[r, 3]))

    wr = row(3)
    return tuple(im.binary(TapeOp.DIV, row(r), wr) for r in range(3))
