"""Post-processing effects: normal denoising, SSAO, blur, shading.

The port of `fidget_tpu.render.effects`, itself a vectorized version of
the reference's per-pixel CPU effects (fidget-raster/src/effects.rs:
16-114 and the per-pixel helpers at effects.rs:116-395). Every effect
is a short sequence of PyTorch ops on the device of its input tensors
(the renderer's `Image3D.depth` / `.normal`); nothing goes to the host
in between, and `apply_shading` returns a uint8 tensor on that device.

Launches are kept few: the windowed sums of denoise and blur stack all
their channels into one tensor and take one 3x3 box sum per call, of
which each of the four windows is a shifted view; the SSAO samples are
evaluated as a batch along a leading dim (the occlusion is a count of
0/1 values, so the batch changes no result).

Frame convention: world-frame normals from `render3d` (+y up, +z toward
the viewer), so normalized positions use y-up too; the reference's
y-down light rig (effects.rs:133-137) is mirrored accordingly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

#: reference light rig (effects.rs:133-137), mirrored to y-up:
#: (x, y, z, weight)
LIGHTS = np.array(
    [
        [5.0, 5.0, 10.0, 0.5],
        [-5.0, 0.0, 10.0, 0.15],
        [0.0, 5.0, 10.0, 0.15],
    ],
    dtype=np.float32,
)

SSAO_RADIUS = 0.1  # effects.rs:225

#: elements of one SSAO batch ([samples, H, W]): 64 samples at 512^2,
#: 32 at 1024^2; each live temporary of the batch is 4 bytes a sample
SSAO_BATCH_ELEMENTS = 1 << 24

_MASK32 = 0xFFFF_FFFF


@functools.lru_cache(maxsize=4)
def ssao_kernel(n: int = 64, seed: int = 0) -> np.ndarray:
    """Hemisphere sample kernel (effects.rs:403-431): unit-ball
    rejection sampling with z >= 0, normalized, then scaled by
    (i / (n-1))^2 * 0.9 + 0.1 to concentrate samples near the origin.
    Deterministic (seeded) unlike the reference's thread_rng."""
    rng = np.random.RandomState(seed)
    out = np.zeros((n, 3), np.float32)
    for i in range(n):
        while True:
            v = np.array(
                [
                    rng.uniform(-1.0, 1.0),
                    rng.uniform(-1.0, 1.0),
                    rng.uniform(0.0, 1.0),
                ]
            )
            r = np.linalg.norm(v)
            if np.finfo(np.float32).eps < r < 1.0:
                scale = (i / (n - 1)) ** 2 * 0.9 + 0.1
                out[i] = v * scale / r
                break
    return out


@functools.lru_cache(maxsize=4)
def ssao_noise(n: int = 256, seed: int = 1) -> np.ndarray:
    """Random XY rotation vectors (effects.rs:436-447)."""
    rng = np.random.RandomState(seed)
    return rng.uniform(-1.0, 1.0, size=(n, 2)).astype(np.float32)


def _pcg2d(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Jarzynski & Olano 2020 2D hash (effects.rs:157-172) over
    non-negative int64 tensors holding uint32 values: every step is
    masked to 32 bits, which is uint32 wraparound (a product of two
    values below 2^32 and 2^21 fits int64, and a shift of a
    non-negative value is logical). Returns the hash as int64."""
    M = 1664525
    A = 1013904223
    x = (x * M + A) & _MASK32
    y = (y * M + A) & _MASK32
    x = (x + y * M) & _MASK32
    y = (y + x * M) & _MASK32
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    x = (x + y * M) & _MASK32
    x = x ^ (x >> 16)
    return x


_ANCHORS2 = ((0, 0), (-2, 0), (0, -2), (-2, -2))


def _window_sums(a: torch.Tensor, r: int, anchors):
    """For each anchor (xmin, ymin), the (r+1)^2 box sum
    sum_{i,j in [0,r]} a[..., y+ymin+j, x+xmin+i] with zero padding.

    One box sum over the padded plane, its (r+1)^2 views added in (j, i)
    order as the reference adds them; each anchor's sums are a shifted
    view of it. a: [..., H, W]. Returns a list of [..., H, W] views."""
    H, W = a.shape[-2], a.shape[-1]
    ap = torch.nn.functional.pad(a, (r, r, r, r))
    box = None
    for j in range(r + 1):
        for i in range(r + 1):
            v = ap[..., j : j + H + r, i : i + W + r]
            box = v.clone() if box is None else box + v
    return [
        box[..., r + ymin : r + ymin + H, r + xmin : r + xmin + W]
        for xmin, ymin in anchors
    ]


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / max(|v|, 1e-20) over the last axis."""
    norm = torch.sqrt((v * v).sum(dim=-1, keepdim=True))
    return v / torch.clamp(norm, min=1e-20)


def denoise_normals(depth: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Replaces back-facing normals with the best neighbor average
    (effects.rs:16-35, denoise_pixel at :266-331): among 4 overlapping
    3x3 windows, take the mean of forward-facing neighbor normals from
    the window maximizing sum of dot(neighbor, mean).

    depth: int [H, W]; normal: f32 [H, W, 3], on one device. Returns
    f32 [H, W, 3] there."""
    normal = normal.to(torch.float32)
    filled = depth > 0
    forward = filled & (normal[..., 2] > 0.0)
    zero = torch.zeros((), dtype=torch.float32, device=normal.device)
    fwd_n = torch.where(forward[..., None], normal, zero)
    fill_n = torch.where(filled[..., None], normal, zero)
    # channels: forward count, forward normal sum xyz, filled normal sum xyz
    stack = torch.cat(
        [forward[None].to(torch.float32), fwd_n.permute(2, 0, 1),
         fill_n.permute(2, 0, 1)]
    )
    windows = torch.stack(_window_sums(stack, 2, _ANCHORS2))  # [4, 7, H, W]
    cnt = windows[:, 0]
    mean = windows[:, 1:4] / torch.clamp(cnt, min=1.0)[:, None]
    fs = windows[:, 4:7]
    # score = sum over *filled* neighbors of dot(n_i, mean)
    score = fs[:, 0] * mean[:, 0] + fs[:, 1] * mean[:, 1] + fs[:, 2] * mean[:, 2]
    take_ok = cnt > 0
    best_score = torch.full_like(score[0], -torch.inf)
    best_mean = normal
    for k in range(len(_ANCHORS2)):
        take = take_ok[k] & (score[k] > best_score)
        best_score = torch.where(take, score[k], best_score)
        best_mean = torch.where(take[..., None], mean[k].permute(1, 2, 0),
                                best_mean)
    out = torch.where((normal[..., 2] > 0.0)[..., None], normal, best_mean)
    return torch.where(filled[..., None], out, zero)


def compute_ssao(depth: torch.Tensor, normal: torch.Tensor, *, vdepth: int,
                 kernel=None, noise=None) -> torch.Tensor:
    """Screen-space ambient occlusion (effects.rs:70-93, :176-264).
    Returns f32 [H, W] on the inputs' device, NaN where empty. `vdepth`
    is the volume's voxel depth (VoxelSize.depth)."""
    if kernel is None:
        kernel = ssao_kernel()
    if noise is None:
        noise = ssao_noise()
    dev = depth.device
    kernel = torch.as_tensor(np.asarray(kernel, np.float32), device=dev)
    noise = torch.as_tensor(np.asarray(noise, np.float32), device=dev)
    normal = normal.to(torch.float32)
    H, W = depth.shape
    filled = depth > 0
    scale_min = min(W, H, vdepth)
    sx, sy, sz = scale_min / W, scale_min / H, scale_min / vdepth

    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    # normalized world-ish position, y-up (half-pixel offset per
    # effects.rs:203-210 to avoid quadrant bias)
    px = ((xs + 0.5) / W - 0.5) * 2.0
    py = -(((ys + 0.5) / H - 0.5) * 2.0)
    depth_f = depth.to(torch.float32)
    pz = (depth_f / vdepth - 0.5) * 2.0

    n = _unit(normal)
    yi, xi = torch.meshgrid(
        torch.arange(H, dtype=torch.int64, device=dev),
        torch.arange(W, dtype=torch.int64, device=dev),
        indexing="ij",
    )
    h = _pcg2d(yi, xi) % noise.shape[0]
    rv = noise[h]  # [H, W, 2]
    rvec = torch.cat([rv, torch.zeros_like(rv[..., :1])], dim=-1)
    # Gram-Schmidt TBN basis (effects.rs:219-222)
    tangent = _unit(rvec - n * (rvec * n).sum(dim=-1, keepdim=True))
    bitangent = torch.linalg.cross(n, tangent, dim=-1)
    # components as [1, H, W] planes, broadcast against [C, 1, 1] samples
    t = tangent.permute(2, 0, 1)[:, None]
    b = bitangent.permute(2, 0, 1)[:, None]
    nn = n.permute(2, 0, 1)[:, None]
    flat_depth = depth.reshape(-1)
    zero = torch.zeros((), dtype=depth.dtype, device=dev)

    S = kernel.shape[0]
    chunk = max(1, SSAO_BATCH_ELEMENTS // (H * W))
    occ = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for c0 in range(0, S, chunk):
        k = kernel[c0 : c0 + chunk]
        k0, k1, k2 = (k[:, j, None, None] for j in range(3))
        off = (t * k0 + b * k1 + nn * k2) * SSAO_RADIUS  # [3, C, H, W]
        sxp = px + off[0] * sx
        syp = py + off[1] * sy
        szp = pz + off[2] * sz
        # back to pixel coordinates (y-up flip mirrored)
        ix = (sxp / 2.0 + 0.5) * W
        iy = (-syp / 2.0 + 0.5) * H
        in_bounds = (ix > 0.0) & (ix < W) & (iy > 0.0) & (iy < H)
        # in bounds, the truncation toward zero lies in [0, W - 1] and
        # [0, H - 1]; elsewhere the sample reads 0
        gx = torch.where(in_bounds, ix, 0.0).to(torch.int64)
        gy = torch.where(in_bounds, iy, 0.0).to(torch.int64)
        actual_h = torch.where(in_bounds, flat_depth[gy * W + gx], zero)
        actual_z = (actual_h.to(torch.float32) / vdepth - 0.5) * 2.0
        occ = occ + (szp <= actual_z).to(torch.float32).sum(dim=0)
    out = 1.0 - occ / S
    return torch.where(filled, out, torch.nan)


def blur_ssao(ssao: torch.Tensor) -> torch.Tensor:
    """Edge-aware SSAO blur (effects.rs:96-114, :334-395): among 4
    overlapping 3x3 windows, the non-NaN mean from the window with the
    smallest variance; pixels with no valid window keep their value."""
    ssao = ssao.to(torch.float32)
    nan = torch.isnan(ssao)
    v = torch.where(nan, 0.0, ssao)
    stack = torch.stack([(~nan).to(torch.float32), v, v * v])
    windows = torch.stack(_window_sums(stack, 2, _ANCHORS2))  # [4, 3, H, W]
    c, s, q = windows[:, 0], windows[:, 1], windows[:, 2]
    cm = torch.clamp(c, min=1.0)
    mean = s / cm
    # stdev accumulates (mean - s_i)^2 over valid neighbors
    var = (q - 2.0 * mean * s + mean * mean * c) / cm
    ok = c > 0
    best_var = torch.full_like(ssao, torch.inf)
    best_mean = ssao
    for k in range(len(_ANCHORS2)):
        take = ok[k] & (var[k] < best_var)
        best_var = torch.where(take, var[k], best_var)
        best_mean = torch.where(take, mean[k], best_mean)
    return torch.where(nan, torch.nan, best_mean)


def _shade(depth: torch.Tensor, normal: torch.Tensor, ssao, *,
           vdepth: int) -> torch.Tensor:
    dev = depth.device
    H, W = depth.shape
    filled = depth > 0
    n = _unit(normal.to(torch.float32))
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    p = torch.stack(
        [
            2.0 * (xs / W - 0.5),
            -2.0 * (ys / H - 0.5),
            2.0 * (depth.to(torch.float32) / vdepth - 0.5),
        ],
        dim=-1,
    )
    accum = torch.full((H, W), 0.2, dtype=torch.float32, device=dev)  # ambient
    for light in LIGHTS:
        ld = _unit(torch.as_tensor(light[:3], device=dev) - p)
        lit = torch.clamp((ld * n).sum(dim=-1), min=0.0)
        accum = accum + lit * float(light[3])
    if ssao is not None:
        s = torch.where(torch.isnan(ssao), 1.0, ssao)
        accum = accum * (s * 0.6 + 0.4)
    accum = torch.clamp(accum, 0.0, 1.0)
    c = (accum * 255.0).to(torch.uint8)  # truncates, as astype does
    c = torch.where(filled, c, torch.zeros((), dtype=torch.uint8, device=dev))
    return torch.stack([c, c, c], dim=-1)


def apply_shading(depth: torch.Tensor, normal: torch.Tensor, *, vdepth: int,
                  ssao: bool = False) -> torch.Tensor:
    """Phong-ish grayscale shading (effects.rs:40-64, shade_pixel at
    :116-152), optionally modulated by blurred SSAO. Returns uint8
    [H, W, 3] on the inputs' device; the caller moves it to the host to
    write it."""
    s = None
    if ssao:
        s = blur_ssao(compute_ssao(depth, normal, vdepth=vdepth))
    return _shade(depth, normal, s, vdepth=vdepth)
