// Native host kernels for the mesh pipeline (ctypes-bound; built by
// g++ at first use, see native/__init__.py).
//
// The batched QEF solve (fidget-mesh/src/qef.rs analog: truncated
// pseudo-inverse about the mass point via closed-form symmetric 3x3
// eigendecomposition) and the per-vertex QEF accumulation, per element
// in registers. The same source as fidget_tpu/native/mesh_kernels.cpp,
// so both packages run the same float64 arithmetic in the same order
// (Smith's trigonometric eigenvalues, largest-cross-product
// eigenvector, projected 2x2 diagonalization, stable descending sort,
// EIGENVALUE_CUTOFF_RELATIVE = 1e-3, mass-point fallback on a
// non-finite solution); held to a LAPACK truncated-SVD solve by
// tests/test_torch_mesh.py::test_qef_solve_matches_svd.

#include <cmath>
#include <cstdint>

namespace {

struct V3 { double x, y, z; };

inline V3 cross(const V3& a, const V3& b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
inline double dot(const V3& a, const V3& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline double norm2(const V3& a) { return dot(a, a); }

// Eigenvalues of a symmetric 3x3, descending (Smith's method).
inline void sym_eigvals3(double a00, double a01, double a02, double a11,
                         double a12, double a22, double w[3]) {
    const double q = (a00 + a11 + a22) / 3.0;
    const double b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
    const double p2 =
        (b00 * b00 + b11 * b11 + b22 * b22 +
         2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0;
    const double p = std::sqrt(p2 > 0.0 ? p2 : 0.0);
    const double det_b =
        b00 * (b11 * b22 - a12 * a12) - a01 * (a01 * b22 - a12 * a02) +
        a02 * (a01 * a12 - b11 * a02);
    double r = 0.0;
    const double den = 2.0 * p * p * p;
    if (den != 0.0) {
        r = det_b / den;
        if (!std::isfinite(r)) r = 0.0;
    }
    if (r < -1.0) r = -1.0;
    if (r > 1.0) r = 1.0;
    const double phi = std::acos(r) / 3.0;
    const double w0 = q + 2.0 * p * std::cos(phi);
    const double w2 = q + 2.0 * p * std::cos(phi + 2.0 * M_PI / 3.0);
    w[0] = w0;
    w[1] = 3.0 * q - w0 - w2;
    w[2] = w2;
}

// Unit eigenvector for eigenvalue lam via the largest cross product of
// rows of (A - lam I); returns false when every cross vanishes
// (repeated eigenvalue at this lam -> caller uses any basis).
inline bool eigvec3(double a00, double a01, double a02, double a11,
                    double a12, double a22, double lam, V3* v) {
    const double m00 = a00 - lam, m11 = a11 - lam, m22 = a22 - lam;
    const V3 r0{m00, a01, a02}, r1{a01, m11, a12}, r2{a02, a12, m22};
    V3 c0 = cross(r0, r1), c1 = cross(r0, r2), c2 = cross(r1, r2);
    double n0 = norm2(c0), n1 = norm2(c1), n2 = norm2(c2);
    V3 best = c0;
    double nb = n0;
    if (n1 >= nb) { best = c1; nb = n1; }
    if (n2 >= nb) { best = c2; nb = n2; }
    const double absum = std::fabs(a00) + std::fabs(a11) +
                         std::fabs(a22) +
                         2.0 * (std::fabs(a01) + std::fabs(a02) +
                                std::fabs(a12));
    double scale = std::fabs(lam);
    if (absum > scale) scale = absum;
    double floor = 1e-14 * scale * scale;
    if (floor < 1e-14 * 1e-30) floor = 1e-14 * 1e-30;
    const double n = std::sqrt(nb);
    if (!(n > floor)) return false;
    const double inv = 1.0 / n;
    *v = {best.x * inv, best.y * inv, best.z * inv};
    return true;
}

}  // namespace

extern "C" {

// Batched truncated QEF solve about the mass point.
//   AtA:  [n, 3, 3] row-major symmetric
//   Atb:  [n, 3]
//   mass: [n, 3]
//   out:  [n, 3] solved positions (mass point where non-finite)
void fidget_qef_solve(int64_t n, const double* AtA, const double* Atb,
                      const double* mass, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        const double* A = AtA + 9 * i;
        const double a00 = A[0], a01 = A[1], a02 = A[2];
        const double a11 = A[4], a12 = A[5], a22 = A[8];
        const double mx = mass[3 * i], my = mass[3 * i + 1],
                     mz = mass[3 * i + 2];
        const double r0 = Atb[3 * i] - (a00 * mx + a01 * my + a02 * mz);
        const double r1 = Atb[3 * i + 1] - (a01 * mx + a11 * my + a12 * mz);
        const double r2 = Atb[3 * i + 2] - (a02 * mx + a12 * my + a22 * mz);

        double W[3];
        sym_eigvals3(a00, a01, a02, a11, a12, a22, W);
        // most isolated extreme eigenvalue first (well-conditioned
        // cross-product extraction), then the projected 2x2
        const bool iso_hi = (W[0] - W[1]) >= (W[1] - W[2]);
        const double lam_iso = iso_hi ? W[0] : W[2];
        V3 v{1.0, 0.0, 0.0};
        (void)eigvec3(a00, a01, a02, a11, a12, a22, lam_iso, &v);
        // orthonormal complement {u, w}
        const double ax = std::fabs(v.x), ay = std::fabs(v.y),
                     az = std::fabs(v.z);
        V3 alt{0.0, 0.0, 0.0};
        if (ax <= ay && ax <= az) alt.x = 1.0;
        else if (ay <= az) alt.y = 1.0;
        else alt.z = 1.0;
        V3 u = cross(v, alt);
        const double uinv = 1.0 / std::sqrt(norm2(u));
        u = {u.x * uinv, u.y * uinv, u.z * uinv};
        const V3 w = cross(v, u);
        auto matv = [&](const V3& t) -> V3 {
            return {a00 * t.x + a01 * t.y + a02 * t.z,
                    a01 * t.x + a11 * t.y + a12 * t.z,
                    a02 * t.x + a12 * t.y + a22 * t.z};
        };
        const V3 Au = matv(u), Aw = matv(w);
        const double p00 = dot(u, Au), p01 = dot(u, Aw), p11 = dot(w, Aw);
        const double theta = 0.5 * std::atan2(2.0 * p01, p00 - p11);
        const double c = std::cos(theta), s = std::sin(theta);
        const V3 va{c * u.x + s * w.x, c * u.y + s * w.y,
                    c * u.z + s * w.z};
        const V3 vb{c * w.x - s * u.x, c * w.y - s * u.y,
                    c * w.z - s * u.z};
        const double la = c * c * p00 + 2.0 * c * s * p01 + s * s * p11;
        const double lb = (p00 + p11) - la;

        // stable descending insertion sort of (lam, vec)
        double l[3] = {lam_iso, la, lb};
        V3 e[3] = {v, va, vb};
        if (l[1] > l[0]) { std::swap(l[0], l[1]); std::swap(e[0], e[1]); }
        if (l[2] > l[1]) { std::swap(l[1], l[2]); std::swap(e[1], e[2]); }
        if (l[1] > l[0]) { std::swap(l[0], l[1]); std::swap(e[0], e[1]); }

        // truncated pseudo-inverse about the mass point
        double vx = mx, vy = my, vz = mz;
        const double cutoff = l[0] * 1e-3 > 1e-12 ? l[0] * 1e-3 : 1e-12;
        for (int k = 0; k < 3; ++k) {
            if (!(l[k] > cutoff)) continue;
            const double coef =
                (e[k].x * r0 + e[k].y * r1 + e[k].z * r2) / l[k];
            vx += e[k].x * coef;
            vy += e[k].y * coef;
            vz += e[k].z * coef;
        }
        if (!(std::isfinite(vx) && std::isfinite(vy) &&
              std::isfinite(vz))) {
            vx = mx; vy = my; vz = mz;
        }
        out[3 * i] = vx;
        out[3 * i + 1] = vy;
        out[3 * i + 2] = vz;
    }
}

}  // extern "C"

extern "C" {

// Batched per-vertex QEF accumulation: one pass over E edge-sample
// instances replacing 14 numpy bincount passes (the host runs on one
// core). Column layout of out [NV, 14]:
//   0-2  sum(pt)      3  count
//   4-9  AtA (a00, a01, a02, a11, a12, a22)   (weighted rows only)
//   10-12 Atb          13 btb
//   vid:  [E] vertex id per instance
//   pt:   [E, 3] intersection points
//   nm:   [E, 3] unit normals
//   w:    [E] 1 = normal valid (weighted), 0 = mass-point only
void fidget_qef_accumulate(int64_t E, int64_t NV, const int64_t* vid,
                           const double* pt, const double* nm,
                           const uint8_t* w, double* out) {
    for (int64_t i = 0; i < NV * 14; ++i) out[i] = 0.0;
    for (int64_t e = 0; e < E; ++e) {
        const int64_t v = vid[e];
        if (v < 0 || v >= NV) continue;
        double* o = out + 14 * v;
        const double px = pt[3 * e], py = pt[3 * e + 1], pz = pt[3 * e + 2];
        o[0] += px; o[1] += py; o[2] += pz; o[3] += 1.0;
        if (!w[e]) continue;
        const double nx = nm[3 * e], ny = nm[3 * e + 1], nz = nm[3 * e + 2];
        const double b = nx * px + ny * py + nz * pz;
        o[4] += nx * nx; o[5] += nx * ny; o[6] += nx * nz;
        o[7] += ny * ny; o[8] += ny * nz; o[9] += nz * nz;
        o[10] += nx * b; o[11] += ny * b; o[12] += nz * b;
        o[13] += b * b;
    }
}

}  // extern "C"
