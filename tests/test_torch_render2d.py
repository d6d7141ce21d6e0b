"""The port's 2D frame against fidget_tpu's, stage by stage, on the CPU.

`PixelRenderer(device="cpu")` runs the plain PyTorch versions of the
three kernels. The reference runs the same single-level bucketed frame
(`_frame_core` under `_TracedBind`) with its Pallas kernels in
interpret mode. Every stage that `stop_after` exposes is compared:
root intervals allclose and choice words exact; action codes exact;
simplified tape lengths and words exact; leaf distances allclose; then
the whole frame with fills exact and distances allclose where they
were evaluated, and occupancy equal to the port's `render_brute`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fidget_tpu as ref
from fidget_tpu.render import render2d as ref_r2d

import fidget_tpu_torch as port
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.render.render2d import FILL_INSIDE, FILL_NONE, FILL_OUTSIDE
from test_torch_compiler import SHAPES, port_tape_from_ref

#: a pan and zoom of the view, so tiles straddle the shapes differently
PAN = np.array([[1.3, 0.0, 0.21], [0.0, 1.3, -0.17], [0.0, 0.0, 1.0]])


def _reference_stages(r, world_to_model):
    """Every stage of the reference's bucketed single-level frame, run
    eagerly (the Pallas kernels compile once per shape and are reused
    across stages)."""
    p = r.packed_b
    b = ref_r2d._TracedBind(
        jnp.asarray(p.w1), jnp.asarray(p.w2), jnp.asarray(p.imm),
        jnp.asarray(p.lengths), jnp.asarray(r.axis_idx), r.Lcap_b, r.nf_b,
        r.n_inputs, r.cw_b, True, False,
    )
    args = (
        b, r.T0, r.T0, r.n0x, jnp.asarray(r.tile_x0), jnp.asarray(r.tile_y0),
        jnp.asarray(r._mat4(world_to_model)), jnp.float32(0.0),
        jnp.asarray(r._var_vec(None)),
    )
    return {
        stage: tuple(
            np.asarray(a)
            for a in ref_r2d._frame_core(
                *args, pixel_perfect=False, stop_after=stage
            )
        )
        for stage in ("root", "codes", "simplify", "leaf", None)
    }


def _port_stages(r, world_to_model):
    mat, vec = r._mat4(world_to_model), r._var_vec(None)
    return {
        stage: tuple(
            a.numpy() for a in r._frame(mat, 0.0, vec, stop_after=stage)
        )
        for stage in ("root", "codes", "simplify", "leaf", None)
    }


CASES = [
    ("circle", 128, None),
    ("spiky", 128, PAN),
    ("union", 128, None),
    ("union", 256, PAN),
]


@pytest.mark.parametrize(
    "name,n,view", CASES,
    ids=[f"{c[0]}-{c[1]}-{'pan' if c[2] is not None else 'id'}" for c in CASES],
)
def test_frame_matches_reference_stage_by_stage(name, n, view):
    ctx = ref.Context()
    t_ref = ref.lower(ctx, [SHAPES[name](ctx)])
    size = ref.ImageSize(n, n)
    rr = ref_r2d.PixelRenderer(t_ref, size, tile_size=64, interpret=True)
    pr = port.PixelRenderer(
        port_tape_from_ref(t_ref), port.ImageSize(n, n), tile_size=64,
        device="cpu",
    )
    for attr in ("Lcap_b", "nf_b", "cw_b", "n0", "s0r", "s0l", "n_inputs"):
        assert getattr(pr, attr) == getattr(rr, attr), attr
    want = _reference_stages(rr, view)
    got = _port_stages(pr, view)

    rlo_g, ch_g = got["root"]
    rlo_w, ch_w = want["root"]
    np.testing.assert_allclose(rlo_g, rlo_w, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ch_g, ch_w)

    for g, w in zip(got["codes"], want["codes"]):
        np.testing.assert_array_equal(g, w)
    active = got["codes"][1]
    assert active.any()

    for g, w in zip(got["simplify"], want["simplify"]):
        np.testing.assert_array_equal(g, w)

    (dist_g,), (dist_w,) = got["leaf"], want["leaf"]
    np.testing.assert_allclose(
        dist_g[active], dist_w[active], rtol=1e-5, atol=1e-6
    )

    img_g, fill_g = got[None]
    img_w, fill_w = want[None]
    np.testing.assert_array_equal(fill_g, fill_w)
    ev = fill_g == FILL_NONE
    np.testing.assert_allclose(img_g[ev], img_w[ev], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["spiky", "union"])
def test_render_matches_brute(name):
    """The public entry point on the CPU: occupancy equal to the port's
    numpy oracle, distances allclose where evaluated, fills
    conservative, and no kernel launched (32-px tiles, so some tiles
    are proven inside or outside)."""
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES[name](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(192, 128), tile_size=32,
                           device="cpu")
    cuda.reset_launches()
    img = r.render(PAN)
    assert cuda.LAUNCHES == {k: 0 for k in cuda.KERNELS}
    brute = r.render_brute(PAN)
    dist, fill = img.distance.numpy(), img.fill.numpy()
    assert dist.shape == fill.shape == brute.shape == (128, 192)
    assert fill.dtype == np.int8
    ev = fill == FILL_NONE
    np.testing.assert_allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6)
    assert (brute[fill == FILL_INSIDE] < 0).all()
    assert (brute[fill == FILL_OUTSIDE] > 0).all()
    np.testing.assert_array_equal(img.inside().numpy(), brute < 0)
    assert (fill != FILL_NONE).any() and ev.any()


def test_pixel_perfect_evaluates_every_pixel():
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["circle"](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(128, 128), tile_size=64,
                           device="cpu")
    img = r.render(pixel_perfect=True)
    assert (img.fill == FILL_NONE).all()
    np.testing.assert_allclose(
        img.distance.numpy(), r.render_brute(), rtol=1e-5, atol=1e-6
    )


def test_module_render_and_vm_route():
    """Reference .vm text through the port's parser and `lower`, into
    the module-level entry point, against the reference's oracle."""
    ctx = ref.Context()
    text = ctx.export(SHAPES["spiky"](ctx))
    pc, proot = port.Context.from_text(text)
    img = port.render2d(
        port.lower(pc, [proot]), port.ImageSize(128, 128), tile_size=64,
        device="cpu",
    )
    rc, rroot = ref.Context.from_text(text)
    rr = ref_r2d.PixelRenderer(
        ref.lower(rc, [rroot]), ref.ImageSize(128, 128), tile_size=64,
        interpret=True,
    )
    np.testing.assert_array_equal(img.inside().numpy(), rr.render_brute() < 0)


def test_image_stays_on_the_render_device():
    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["circle"](ctx)])
    img = port.PixelRenderer(
        tape, port.ImageSize(64, 64), device="cpu"
    ).render()
    assert isinstance(img.distance, torch.Tensor)
    assert img.distance.device.type == "cpu"
    assert img.distance.dtype == torch.float32


def test_fired_cancel_token_stops_the_frame():
    from fidget_tpu_torch.render.config import CancelToken, RenderCancelled

    ctx = port.Context()
    tape = port.lower(ctx, [SHAPES["circle"](ctx)])
    r = port.PixelRenderer(tape, port.ImageSize(64, 64), device="cpu")
    token = CancelToken()
    assert r.render(cancel=token).inside().any()
    token.cancel()
    with pytest.raises(RenderCancelled):
        r.render(cancel=token)
