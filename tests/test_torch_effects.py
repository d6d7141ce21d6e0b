"""The port's post-effects (`fidget_tpu_torch.render.effects`) against
fidget_tpu's, on the CPU.

Both packages get the same numpy arrays: seeded synthetic depth and
normals (empty pixels and back-facing normals included) and a real
64^2 heightmap with normals of the gyroid sphere, rendered once by the
port. Tolerances:

- `ssao_kernel`, `ssao_noise`, the pcg2d hash (past 2^16 too) and the
  NaN masks: exact;
- `denoise_normals` and `blur_ssao`: atol 1e-6;
- `compute_ssao`: equal on at least 99.9% of filled pixels, the rest
  differ by exactly 1/64. XLA:CPU contracts a*b + c into an FMA, so a
  sample's `szp <= actual_z` can flip where the two sides nearly meet;
  one flipped sample moves the occlusion by 1/64;
- `_shade` on identical inputs: within 1 level;
- `apply_shading(ssao=True)`: within 1 level on at least 99% of
  pixels and within 4 everywhere.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fidget_tpu.render import effects as ref_fx
import fidget_tpu_torch as port
from fidget_tpu_torch.render import effects as fx
from fidget_tpu_torch.scenes import gyroid_sphere

N = 64
SSAO_SAMPLES = 64


def _synthetic(seed, n=N):
    """Random heights with empty pixels (about 20%) and random unit
    normals, about half of them back-facing."""
    rng = np.random.RandomState(seed)
    depth = rng.randint(1, n + 1, size=(n, n)).astype(np.int32)
    depth[rng.rand(n, n) < 0.2] = 0
    normal = rng.normal(size=(n, n, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    return depth, normal


_GYROID = None


def _gyroid():
    """A 64^2 heightmap and normals of the gyroid sphere (rotated, so
    the silhouette and the sheets overlap), rendered once by the port
    on the CPU."""
    global _GYROID
    if _GYROID is None:
        r = port.VoxelRenderer(
            gyroid_sphere(port), port.VoxelSize(N, N, N), tile_size=32,
            sub_size=16, device="cpu",
        )
        c, s = np.cos(0.5), np.sin(0.5)
        view = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0],
                         [0, 0, 0, 1]])
        img = r.render(view)
        _GYROID = img.depth.numpy(), img.normal.numpy()
    return _GYROID


INPUTS = {
    "synthetic0": lambda: _synthetic(0),
    "synthetic1": lambda: _synthetic(1),
    "gyroid": _gyroid,
}


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ssao_tables_exact():
    np.testing.assert_array_equal(fx.ssao_kernel(), ref_fx.ssao_kernel())
    np.testing.assert_array_equal(fx.ssao_noise(), ref_fx.ssao_noise())
    np.testing.assert_array_equal(fx.ssao_kernel(16, 3),
                                  ref_fx.ssao_kernel(16, 3))
    np.testing.assert_array_equal(fx.LIGHTS, ref_fx.LIGHTS)


@pytest.mark.parametrize("origin", [(0, 0), (65_530, 12), (70_001, 1 << 20),
                                    ((1 << 32) - 200, (1 << 31) + 5)])
def test_pcg2d_bit_equal(origin):
    """The hash over a 160 x 170 block of coordinates, past 2^16 and
    near 2^32 too, and its noise index."""
    y0, x0 = origin
    ys, xs = np.meshgrid(
        np.arange(y0, y0 + 160, dtype=np.uint64),
        np.arange(x0, x0 + 170 * 7, 7, dtype=np.uint64), indexing="ij",
    )
    ys, xs = ys.astype(np.uint32), xs.astype(np.uint32)
    want = np.asarray(ref_fx._pcg2d(jnp.asarray(ys), jnp.asarray(xs)))
    got = fx._pcg2d(_t(ys.astype(np.int64)), _t(xs.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal((got % 256).numpy(), want % np.uint32(256))


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_denoise_normals(name):
    depth, normal = INPUTS[name]()
    want = np.asarray(ref_fx.denoise_normals(depth, normal))
    got = fx.denoise_normals(_t(depth), _t(normal)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[depth == 0], 0.0)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_compute_ssao(name):
    depth, normal = INPUTS[name]()
    want = np.asarray(ref_fx.compute_ssao(depth, normal, vdepth=N))
    got = fx.compute_ssao(_t(depth), _t(normal), vdepth=N).numpy()
    np.testing.assert_array_equal(np.isnan(got), depth == 0)
    np.testing.assert_array_equal(np.isnan(want), depth == 0)
    filled = depth > 0
    diff = np.abs(got[filled].astype(np.float64) - want[filled])
    assert (diff == 0).mean() >= 0.999, (diff > 0).sum()
    np.testing.assert_array_equal(
        diff[diff > 0], np.full((diff > 0).sum(), 1.0 / SSAO_SAMPLES)
    )


def test_compute_ssao_batches_agree():
    """The sample batch is a launch-count choice only: one sample a
    batch gives the same occlusion."""
    depth, normal = _synthetic(2)
    whole = fx.compute_ssao(_t(depth), _t(normal), vdepth=N)
    old = fx.SSAO_BATCH_ELEMENTS
    try:
        fx.SSAO_BATCH_ELEMENTS = 1
        one = fx.compute_ssao(_t(depth), _t(normal), vdepth=N)
    finally:
        fx.SSAO_BATCH_ELEMENTS = old
    torch.testing.assert_close(one, whole, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_blur_ssao(name):
    depth, normal = INPUTS[name]()
    ssao = np.asarray(ref_fx.compute_ssao(depth, normal, vdepth=N))
    want = np.asarray(ref_fx.blur_ssao(ssao))
    got = fx.blur_ssao(_t(ssao)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_ssao", [False, True])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_shade_identical_inputs(name, with_ssao):
    depth, normal = INPUTS[name]()
    ssao = None
    if with_ssao:
        ssao = np.asarray(ref_fx.blur_ssao(
            ref_fx.compute_ssao(depth, normal, vdepth=N)))
    want = np.asarray(ref_fx._shade(
        jnp.asarray(depth), jnp.asarray(normal),
        None if ssao is None else jnp.asarray(ssao), vdepth=N,
    ))
    got = fx._shade(_t(depth), _t(normal),
                    None if ssao is None else _t(ssao), vdepth=N)
    assert got.dtype == torch.uint8 and got.shape == (N, N, 3)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_apply_shading_with_ssao(name):
    depth, normal = INPUTS[name]()
    want = ref_fx.apply_shading(depth, normal, vdepth=N, ssao=True)
    got = fx.apply_shading(_t(depth), _t(normal), vdepth=N, ssao=True)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert (diff <= 1).mean() >= 0.99
    assert diff.max() <= 4
    np.testing.assert_array_equal(got.numpy()[depth == 0], 0)


def test_effects_stay_on_the_input_device():
    """Every effect returns a tensor on its inputs' device (here the
    CPU's), and the shading is uint8."""
    depth, normal = _synthetic(3, n=32)
    d, n = _t(depth), _t(normal)
    for out in (fx.denoise_normals(d, n), fx.compute_ssao(d, n, vdepth=32),
                fx.apply_shading(d, n, vdepth=32, ssao=True)):
        assert isinstance(out, torch.Tensor) and out.device == d.device
