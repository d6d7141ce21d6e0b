"""The CUDA kernels of fidget_tpu_torch against their plain PyTorch
versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one. The file imports neither JAX nor fidget_tpu, so it runs
where only PyTorch is installed; tests/conftest.py imports JAX, so
there run it as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import fidget_tpu_torch as port
from fidget_tpu_torch.compiler.pack import frequency_op_order, pack_tapes
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval.interp import (
    interp_float,
    interp_float_coded,
    interp_float_coded_plain,
    interp_float_plain,
    interp_grad,
    interp_grad_plain,
    interp_interval,
    interp_interval_plain,
    interp_voxel_depth,
    interp_voxel_depth_plain,
)
from fidget_tpu_torch.eval.simplify_device import (
    liveness_codes,
    liveness_codes_plain,
    per_lane_to_rows,
    reconstruct,
    unpack_codes,
)
from fidget_tpu_torch.render.render2d import FILL_INSIDE, FILL_NONE, FILL_OUTSIDE
from fidget_tpu_torch.scenes import (
    adversarial_arena,
    gyroid_sphere,
    sphere_union_shape,
)

S0 = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _tapes():
    """A circle, a box-and-sine shape, and a seeded 40-circle union."""
    out = []
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    out.append(port.lower(ctx, [ctx.sub(
        ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y))), 0.6)]))
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    box = ctx.max(ctx.sub(ctx.abs(x), 0.5), ctx.sub(ctx.abs(y), 0.25))
    out.append(port.lower(ctx, [ctx.add(box, ctx.mul(ctx.sin(ctx.mul(y, 5.0)), 0.1))]))
    out.append(_union_tape(40))
    return out


def _union_tape(n, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, size=(n, 2))
    r = rng.uniform(0.05, 0.3, size=n)
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    parts = [
        ctx.sub(ctx.sqrt(ctx.add(
            ctx.square(ctx.sub(x, float(c[i, 0]))),
            ctx.square(ctx.sub(y, float(c[i, 1]))),
        )), float(r[i]))
        for i in range(n)
    ]
    while len(parts) > 1:
        nxt = [ctx.min(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return port.lower(ctx, [parts[0]])


@pytest.mark.cuda
@pytest.mark.parametrize("nf_pad", [0, 512])
def test_kernels_match_plain(card, nf_pad):
    """nf_pad = 512 oversizes the register file past what shared memory
    holds (K3's single file of one lane a thread fits up to nf 428), so
    the kernels take their global-memory scratch path."""
    tapes = _tapes()
    packed = pack_tapes(tapes, capacity=512)
    nf = max(packed.nf, nf_pad)
    for kernel in ("interp_float", "interp_interval"):
        g = cuda.launch_geometry(kernel, nf=nf, lanes=S0 * 128, T=len(tapes),
                                 cw=4)
        assert g.regs_shared == (nf_pad == 0)
    arena = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
             for a in (packed.w1, packed.w2, packed.imm, packed.lengths)]
    rng = np.random.default_rng(1)
    lo = rng.uniform(-1.5, 1.5, size=(len(tapes), 2, S0, 128)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.5, size=lo.shape).astype(np.float32)
    lo, hi = torch.from_numpy(lo).to(card), torch.from_numpy(hi).to(card)
    kw = dict(nf=nf, n_inputs=2, n_outputs=1, s0=S0)
    torch.testing.assert_close(
        interp_float(*arena, lo, **kw), interp_float_plain(*arena, lo, **kw),
        rtol=2e-5, atol=2e-5,
    )
    got = interp_interval(*arena, lo, hi, c_words=4, **kw)
    want = interp_interval_plain(*arena, lo, hi, c_words=4, **kw)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, equal_nan=True)
    assert torch.equal(got[2], want[2])
    L = packed.w1.shape[1]
    w1, w2, _, lens = arena
    codes = liveness_codes(w1, w2, lens, want[2], nf=nf, L=L, shared_tape=False)
    plain = liveness_codes_plain(
        w1, w2, lens, want[2], nf=nf, L=L, shared_tape=False
    )
    assert torch.equal(codes, plain)


#: (s0, nf_pad, c_words): 4, 2 and 1 lanes a thread of K3 on the
#: shared-memory register file; the global scratch; choice words too many
#: for shared memory, beside either register file
ADVERSARIAL_CASES = [
    (8, 0, 2), (2, 0, 2), (1, 0, 2), (8, 512, 2), (1, 512, 512), (8, 0, 512),
]


@pytest.mark.cuda
@pytest.mark.parametrize("s0,nf_pad,cw", ADVERSARIAL_CASES)
def test_adversarial_tapes_match_plain(card, s0, nf_pad, cw):
    """The hand-packed tapes of `scenes.adversarial_arena` (lengths
    around the staging chunk, past L and 0; dependent and independent
    chains; immediate-only rows; two OUTPUT rows; a register past nf)
    through K3 and K1 against the plain versions, bit for bit; with 2
    choice words the 272 choices of the long chains fold into the last."""
    A = adversarial_arena(cuda.TAPE_CHUNK)
    arena = [torch.from_numpy(A[k]).to(card)
             for k in ("w1", "w2", "imm", "lengths")]
    T = len(A["names"])
    nf = max(A["nf"], nf_pad)
    gf = cuda.launch_geometry("interp_float", nf=nf, lanes=s0 * 128, T=T)
    gi = cuda.launch_geometry("interp_interval", nf=nf, lanes=s0 * 128, T=T,
                              cw=cw)
    assert gf.r == min(4, s0)
    assert gf.regs_shared == gi.regs_shared == (nf_pad == 0)
    assert gi.choices_shared == (cw == 2)
    rng = np.random.default_rng(5)
    lo = rng.uniform(-1.5, 1.5, size=(T, 2, s0, 128)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.5, size=lo.shape).astype(np.float32)
    lo, hi = torch.from_numpy(lo).to(card), torch.from_numpy(hi).to(card)
    kw = dict(nf=nf, n_inputs=2, n_outputs=2, s0=s0)
    cuda.reset_launches()
    got = interp_float(*arena, lo, **kw)
    want = interp_float_plain(*arena, lo, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[0] == 0).all() and (got[1, 0] == 1.5).all()
    got = interp_interval(*arena, lo, hi, c_words=cw, **kw)
    want = interp_interval_plain(*arena, lo, hi, c_words=cw, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    assert (got[2] != 0).any() and (got[2][0] == 0).all()
    assert cuda.LAUNCHES["interp_float"] == 1
    assert cuda.LAUNCHES["interp_interval"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("nf_pad", [0, 256])
def test_grad_and_voxel_kernels_match_plain(card, nf_pad):
    """K4 and K5 against their plain versions; nf_pad = 256 takes both
    to their global-scratch register files (K4 already goes there at
    nf > 48)."""
    tapes = [gyroid_sphere(port).tape()] + _tapes()
    packed = pack_tapes(tapes, capacity=512)
    nf = max(packed.nf, nf_pad)
    arena = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
             for a in (packed.w1, packed.w2, packed.imm, packed.lengths)]
    arena[3][-1] = 0  # a culled instance
    T = len(tapes)
    rng = np.random.default_rng(2)
    duals = torch.from_numpy(
        rng.uniform(-1, 1, size=(T, 3, 4, S0, 128)).astype(np.float32)
    ).to(card)
    kw = dict(nf=nf, n_inputs=3, n_outputs=1, s0=S0)
    got, want = interp_grad(*arena, duals, **kw), interp_grad_plain(*arena, duals, **kw)
    torch.testing.assert_close(got[:, :, 0], want[:, :, 0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got[:, :, 1:], want[:, :, 1:], rtol=1e-4, atol=1e-4)
    pts = torch.from_numpy(
        rng.uniform(-1, 1, size=(T, 3, 32, 128)).astype(np.float32)
    ).to(card)
    kw = dict(nf=nf, n_inputs=3, s0=32, sub=16)
    got = interp_voxel_depth(*arena, pts, **kw)
    assert torch.equal(got, interp_voxel_depth_plain(*arena, pts, **kw))
    assert (got[0] > 0).any() and (got[-1] == 0).all()


@pytest.mark.cuda
def test_voxel_render_on_card_matches_brute(card):
    """A union of spheres, whose ops f32 rounds correctly on the card and
    in numpy alike, so depth equals numpy's `render_brute` exactly."""
    ctx = port.Context()
    tape = port.lower(ctx, [sphere_union_shape(ctx, n=60)])
    r = port.VoxelRenderer(tape, port.VoxelSize(128, 128, 128), tile_size=32,
                           sub_size=16)
    assert r.device.type == "cuda"
    cuda.reset_launches()
    img = r.render()
    torch.cuda.synchronize()
    assert {k for k, n in cuda.LAUNCHES.items() if n} == {
        "interp_interval", "liveness_codes", "interp_grad",
        "interp_voxel_depth",
    }
    depth = img.depth.cpu().numpy()
    np.testing.assert_array_equal(depth, r.render_brute().depth.numpy())
    hit = depth > 0
    np.testing.assert_allclose(img.normal.cpu().numpy()[hit],
                               r.brute_normals(depth)[hit], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
def test_render_on_card_matches_brute(card):
    tape = _union_tape(40)
    r = port.PixelRenderer(tape, port.ImageSize(256, 256), tile_size=32)
    assert r.device.type == "cuda"
    cuda.reset_launches()
    img = r.render()
    torch.cuda.synchronize()
    assert cuda.LAUNCHES == {
        k: int(k in ("interp_interval", "liveness_codes", "interp_float"))
        for k in cuda.KERNELS
    }
    brute = r.render_brute()
    dist, fill = img.distance.cpu().numpy(), img.fill.cpu().numpy()
    ev = fill == FILL_NONE
    np.testing.assert_allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(img.inside().cpu().numpy(), brute < 0)
    assert (~ev).any()


@pytest.mark.cuda
@pytest.mark.parametrize("nf_pad", [0, 256])
def test_coded_kernel_matches_plain(card, nf_pad):
    """K6 on real codes (K1 over seeded boxes as lanes, K2 over the
    shared tape) with the tape packed at its own length, so the last
    code word is ragged: the kernel equals its plain version and
    reconstruct + K3 bit for bit, through the shared-memory register
    file and (nf_pad = 256) the global scratch."""
    tape = _union_tape(40)
    packed = pack_tapes([tape])
    L = packed.w1.shape[1]
    assert L % 16
    nf = max(packed.nf, nf_pad)
    w1, w2, imm, lens = (
        torch.from_numpy(np.ascontiguousarray(a)).to(card)
        for a in (packed.w1, packed.w2, packed.imm, packed.lengths)
    )
    n = 48
    rng = np.random.default_rng(3)
    c = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    half = rng.uniform(0.05, 0.4, size=(n, 1)).astype(np.float32)
    lo = np.zeros((1, 2, S0, 128), np.float32)
    hi = np.zeros_like(lo)
    lo.reshape(2, -1)[:, :n] = (c - half).T
    hi.reshape(2, -1)[:, :n] = (c + half).T
    kw = dict(nf=nf, n_inputs=2, n_outputs=1)
    ch = interp_interval(
        w1, w2, imm, lens, torch.from_numpy(lo).to(card),
        torch.from_numpy(hi).to(card), s0=S0, c_words=4, **kw,
    )[2]
    words = per_lane_to_rows(
        liveness_codes(w1, w2, lens, ch, nf=nf, L=L, shared_tape=True), n
    ).contiguous()
    u = rng.uniform(-1, 1, size=(n, 2, S0, 128)).astype(np.float32)
    pts = torch.from_numpy(c[:, :, None, None] + half[:, :, None, None] * u)
    pts = pts.to(card)
    lengths = lens.expand(n).clone()
    lengths[5] = 0  # a culled tile
    cuda.reset_launches()
    got = interp_float_coded(w1, w2, imm, lengths, words, pts, s0=S0, **kw)
    assert cuda.LAUNCHES["interp_float_coded"] == 1
    want = interp_float_coded_plain(w1, w2, imm, lengths, words, pts, s0=S0, **kw)
    assert torch.equal(got, want)
    assert (got[5] == 0).all() and (got[0] != 0).any()
    w1c, w2c, immc, lensc, _ = reconstruct(w1, w2, imm, unpack_codes(words, L))
    lensc = torch.where(lengths > 0, lensc, 0)
    leaf = interp_float(w1c, w2c, immc, lensc, pts, s0=S0, **kw)
    assert torch.equal(got, leaf)


@pytest.mark.cuda
def test_kernels_under_op_order_match_plain_and_canonical(card):
    """K1, K2 and K3 on an arena packed under a frequency order: equal
    to their plain versions with the same order and bit-equal to their
    own results on the canonical arena."""
    tapes = _tapes()
    order = frequency_op_order(tapes[-1])
    assert order != tuple(range(31))
    to = lambda p: [torch.from_numpy(np.ascontiguousarray(a)).to(card)
                    for a in (p.w1, p.w2, p.imm, p.lengths)]
    canon = to(pack_tapes(tapes, capacity=512))
    arena = to(pack_tapes(tapes, capacity=512, op_order=order))
    nf = pack_tapes(tapes).nf
    rng = np.random.default_rng(4)
    lo = rng.uniform(-1.5, 1.5, size=(len(tapes), 2, S0, 128)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.5, size=lo.shape).astype(np.float32)
    lo, hi = torch.from_numpy(lo).to(card), torch.from_numpy(hi).to(card)
    kw = dict(nf=nf, n_inputs=2, n_outputs=1, s0=S0)
    got = interp_float(*arena, lo, op_order=order, **kw)
    torch.testing.assert_close(
        got, interp_float_plain(*arena, lo, op_order=order, **kw),
        rtol=2e-5, atol=2e-5,
    )
    assert torch.equal(got, interp_float(*canon, lo, **kw))
    got = interp_interval(*arena, lo, hi, c_words=4, op_order=order, **kw)
    want = interp_interval_plain(*arena, lo, hi, c_words=4, op_order=order, **kw)
    same = interp_interval(*canon, lo, hi, c_words=4, **kw)
    for g, w, c in zip(got[:2], want[:2], same[:2]):
        torch.testing.assert_close(g, w, rtol=2e-5, atol=2e-5, equal_nan=True)
        assert torch.equal(g, c)
    assert torch.equal(got[2], want[2]) and torch.equal(got[2], same[2])
    w1, w2, _, lens = arena
    lk = dict(nf=nf, L=512, shared_tape=False)
    codes = liveness_codes(w1, w2, lens, got[2], op_order=order, **lk)
    assert torch.equal(codes, liveness_codes_plain(
        w1, w2, lens, got[2], op_order=order, **lk))
    assert torch.equal(codes, liveness_codes(
        canon[0], canon[1], canon[3], got[2], **lk))


@pytest.mark.cuda
def test_two_level_render_on_card_matches_brute(card):
    """`tile_sizes=(128, 32)`: the per-shape arena under its op_order
    through K1 (root and subtiles), K2 (shared and per instance) and
    K3, against `render_brute`; subtile proofs carry level tag 1."""
    tape = _union_tape(40)
    r = port.PixelRenderer(tape, port.ImageSize(256, 256), tile_sizes=(128, 32))
    assert r.device.type == "cuda"
    cuda.reset_launches()
    img = r.render()
    torch.cuda.synchronize()
    assert cuda.LAUNCHES == {
        "interp_interval": 2, "liveness_codes": 2, "interp_float": 1,
        "interp_grad": 0, "interp_voxel_depth": 0, "interp_float_coded": 0,
    }
    brute = r.render_brute()
    dist, fill = img.distance.cpu().numpy(), img.fill.cpu().numpy()
    ev = fill == FILL_NONE
    np.testing.assert_allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(img.inside().cpu().numpy(), brute < 0)
    cls = img.fill_class().cpu().numpy()
    assert (brute[cls == FILL_INSIDE] < 0).all()
    assert (brute[cls == FILL_OUTSIDE] > 0).all()
    assert (img.fill_level() == 1).any()
