"""Closed-form batched QEF solve, namespace-parametric (numpy / torch).

The counterpart of `fidget_tpu.mesh.qef`: the truncated pseudo-inverse
of the symmetric PSD 3x3 AtA comes from a closed-form eigendecomposition
(Smith's trigonometric eigenvalues + a cross-product kernel vector + a
projected 2x2 rotation), fully componentwise so it vectorizes over the
batch in either numpy (host, float64) or torch (the device-resident
fine stage, float32, mesh/fused.py). The order of operations is the
reference's, term for term.

All functions take `xp` (the `numpy` or the `torch` module) and operate
on the last axes componentwise; inputs may carry any leading batch
shape. Symmetry assumption: only the upper triangle of AtA is read.
"""

from __future__ import annotations

import numpy as np
import torch


class _TorchNS:
    """The numpy functions this module calls, as torch's (`maximum`
    takes a python scalar, as numpy's does)."""

    sqrt, abs, isfinite, where, clip = (torch.sqrt, torch.abs, torch.isfinite,
                                        torch.where, torch.clip)
    arccos, arctan2, cos, sin = torch.arccos, torch.arctan2, torch.cos, torch.sin

    @staticmethod
    def maximum(a, b):
        like = a if isinstance(a, torch.Tensor) else b
        return torch.maximum(*(torch.as_tensor(v, dtype=like.dtype,
                                               device=like.device)
                               for v in (a, b)))


def _ns(xp):
    return _TorchNS if xp is torch else xp


def _is_f64(a) -> bool:
    return a.dtype in (np.float64, torch.float64)


def _cross_c(ax, ay, az, bx, by, bz):
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def sym_eigvals3(xp, a00, a01, a02, a11, a12, a22):
    """Eigenvalues (descending triple) of symmetric 3x3 batches."""
    xp = _ns(xp)
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (
        b00 * b00 + b11 * b11 + b22 * b22
        + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)
    ) / 6.0
    p = xp.sqrt(xp.maximum(p2, 0.0))
    det_b = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    denom = 2.0 * p * p * p
    r = xp.where(denom > 0, det_b / xp.where(denom == 0, 1.0, denom), 0.0)
    r = xp.clip(xp.where(xp.isfinite(r), r, 0.0), -1.0, 1.0)
    phi = xp.arccos(r) / 3.0
    w0 = q + 2.0 * p * xp.cos(phi)
    w2 = q + 2.0 * p * xp.cos(phi + 2.0 * np.pi / 3.0)
    return w0, 3.0 * q - w0 - w2, w2


def _eigvec3_c(xp, a00, a01, a02, a11, a12, a22, lam):
    """Unit eigenvector for eigenvalue lam via the largest cross
    product of rows of (A - lam I); `good` is False on degenerate
    (repeated-eigenvalue) rows where every cross product vanishes."""
    xp = _ns(xp)
    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    c0 = _cross_c(m00, a01, a02, a01, m11, a12)
    c1 = _cross_c(m00, a01, a02, a02, a12, m22)
    c2 = _cross_c(a01, m11, a12, a02, a12, m22)
    n0 = c0[0] * c0[0] + c0[1] * c0[1] + c0[2] * c0[2]
    n1 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2]
    n2 = c2[0] * c2[0] + c2[1] * c2[1] + c2[2] * c2[2]
    use1 = n1 >= n0
    nb = xp.where(use1, n1, n0)
    use2 = n2 >= nb
    nbest = xp.where(use2, n2, nb)
    vx = xp.where(use2, c2[0], xp.where(use1, c1[0], c0[0]))
    vy = xp.where(use2, c2[1], xp.where(use1, c1[1], c0[1]))
    vz = xp.where(use2, c2[2], xp.where(use1, c1[2], c0[2]))
    n = xp.sqrt(nbest)
    absum = (
        xp.abs(a00) + xp.abs(a11) + xp.abs(a22)
        + 2.0 * (xp.abs(a01) + xp.abs(a02) + xp.abs(a12))
    )
    # degeneracy threshold scales with dtype precision: 1e-14 for the
    # host float64 path, 2e-6 for the device float32 path
    eps = 1e-14 if _is_f64(lam) else 2e-6
    scale = xp.maximum(xp.abs(lam), absum)
    good = n > eps * xp.maximum(scale * scale, 1e-30)
    inv = xp.where(good, 1.0 / xp.where(n == 0, 1.0, n), 0.0)
    return (vx * inv, vy * inv, vz * inv), good


def sym_eig3_c(xp, a00, a01, a02, a11, a12, a22):
    """Full eigendecomposition: ((l0,l1,l2) descending, three unit
    eigenvector component-triples in matching order)."""
    w0, w1, w2 = sym_eigvals3(xp, a00, a01, a02, a11, a12, a22)
    xp = _ns(xp)
    iso_hi = (w0 - w1) >= (w1 - w2)
    lam_iso = xp.where(iso_hi, w0, w2)
    (vx, vy, vz), good = _eigvec3_c(
        xp, a00, a01, a02, a11, a12, a22, lam_iso
    )
    vx = xp.where(good, vx, 1.0)
    vy = xp.where(good, vy, 0.0)
    vz = xp.where(good, vz, 0.0)
    ax_, ay_, az_ = xp.abs(vx), xp.abs(vy), xp.abs(vz)
    min_x = (ax_ <= ay_) & (ax_ <= az_)
    min_y = ~min_x & (ay_ <= az_)
    altx = xp.where(min_x, 1.0, 0.0)
    alty = xp.where(min_y, 1.0, 0.0)
    altz = 1.0 - altx - alty
    ux, uy, uz = _cross_c(vx, vy, vz, altx, alty, altz)
    uinv = 1.0 / xp.sqrt(ux * ux + uy * uy + uz * uz)
    ux, uy, uz = ux * uinv, uy * uinv, uz * uinv
    wx, wy, wz = _cross_c(vx, vy, vz, ux, uy, uz)

    def matv(x, y, z):
        return (
            a00 * x + a01 * y + a02 * z,
            a01 * x + a11 * y + a12 * z,
            a02 * x + a12 * y + a22 * z,
        )

    Aux, Auy, Auz = matv(ux, uy, uz)
    Awx, Awy, Awz = matv(wx, wy, wz)
    p00 = ux * Aux + uy * Auy + uz * Auz
    p01 = ux * Awx + uy * Awy + uz * Awz
    p11 = wx * Awx + wy * Awy + wz * Awz
    theta = 0.5 * xp.arctan2(2.0 * p01, p00 - p11)
    c, s = xp.cos(theta), xp.sin(theta)
    va = (c * ux + s * wx, c * uy + s * wy, c * uz + s * wz)
    vb = (c * wx - s * ux, c * wy - s * uy, c * wz - s * uz)
    la = c * c * p00 + 2.0 * c * s * p01 + s * s * p11
    lb = (p00 + p11) - la

    def pick(cond, t, f):
        return tuple(xp.where(cond, a, b) for a, b in zip(t, f))

    l0, l1, l2 = lam_iso, la, lb
    v0 = (vx, vy, vz)
    # stable 3-element insertion sort, descending
    swap01 = l1 > l0
    k0, k1 = xp.where(swap01, l1, l0), xp.where(swap01, l0, l1)
    e0, e1 = pick(swap01, va, v0), pick(swap01, v0, va)
    swap12 = l2 > k1
    k1, k2 = xp.where(swap12, l2, k1), xp.where(swap12, k1, l2)
    e1, e2 = pick(swap12, vb, e1), pick(swap12, e1, vb)
    swap01b = k1 > k0
    k0, k1 = xp.where(swap01b, k1, k0), xp.where(swap01b, k0, k1)
    e0, e1 = pick(swap01b, e1, e0), pick(swap01b, e0, e1)
    return (k0, k1, k2), (e0, e1, e2)


def solve_qef_c(xp, ata, atb, mass):
    """Truncated QEF solve about the mass point, componentwise.

    ata: 6-tuple (a00, a01, a02, a11, a12, a22); atb / mass: 3-tuples.
    Truncation matches the reference: directions below 1e-3 of the
    largest eigenvalue are dropped (EIGENVALUE_CUTOFF_RELATIVE,
    fidget-mesh/src/qef.rs:96). Returns a 3-tuple; non-finite
    solutions fall back to the mass point."""
    a00, a01, a02, a11, a12, a22 = ata
    mx, my, mz = mass
    r0 = atb[0] - (a00 * mx + a01 * my + a02 * mz)
    r1 = atb[1] - (a01 * mx + a11 * my + a12 * mz)
    r2 = atb[2] - (a02 * mx + a12 * my + a22 * mz)
    (w0, w1, w2), (e0, e1, e2) = sym_eig3_c(
        xp, a00, a01, a02, a11, a12, a22
    )
    xp = _ns(xp)
    deltas = None
    for w, e in ((w0, e0), (w1, e1), (w2, e2)):
        keep = w > xp.maximum(w0 * 1e-3, 1e-12)
        winv = xp.where(keep, 1.0 / xp.where(keep, w, 1.0), 0.0)
        c = winv * (e[0] * r0 + e[1] * r1 + e[2] * r2)
        d = (e[0] * c, e[1] * c, e[2] * c)
        deltas = d if deltas is None else tuple(
            a + b for a, b in zip(deltas, d)
        )
    vx = mx + deltas[0]
    vy = my + deltas[1]
    vz = mz + deltas[2]
    fin = xp.isfinite(vx) & xp.isfinite(vy) & xp.isfinite(vz)
    return (
        xp.where(fin, vx, mx),
        xp.where(fin, vy, my),
        xp.where(fin, vz, mz),
    )


def qef_err_c(xp, v, ata, atb, btb):
    """QEF residual v^T AtA v - 2 Atb.v + btb, componentwise."""
    a00, a01, a02, a11, a12, a22 = ata
    x, y, z = v
    vav = (
        a00 * x * x + a11 * y * y + a22 * z * z
        + 2.0 * (a01 * x * y + a02 * x * z + a12 * y * z)
    )
    return vav - 2.0 * (atb[0] * x + atb[1] * y + atb[2] * z) + btb
