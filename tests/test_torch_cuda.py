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
    pack_action_codes,
    seeded_action_codes,
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
@pytest.mark.parametrize("nf_pad", [0, 256, 512])
def test_grad_and_voxel_kernels_match_plain(card, nf_pad):
    """K4 and K5 against their plain versions; nf_pad = 256 takes K4 to
    its global-scratch register files and K5 to one lane a thread, 512
    takes K5 to its global scratch."""
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
    g4 = cuda.launch_geometry("interp_grad", nf=nf, lanes=S0 * 128, T=T)
    g5 = cuda.launch_geometry("interp_voxel_depth", nf=nf, lanes=4096, T=T,
                              sub=16)
    assert (g4.regs_shared, g5.regs_shared) == (nf_pad < 256, nf_pad < 512)


@pytest.mark.cuda
def test_grad_and_voxel_under_op_order_match_plain_and_canonical(card):
    """K4 and K5 on an arena packed under the gyroid's frequency order:
    equal to their plain versions with the same order (K5 exactly) and
    bit-equal to their own results on the canonical arena."""
    tapes = [gyroid_sphere(port).tape()] + _tapes()
    order = frequency_op_order(tapes[0])
    assert order != tuple(range(31))
    to = lambda p: [torch.from_numpy(np.ascontiguousarray(a)).to(card)
                    for a in (p.w1, p.w2, p.imm, p.lengths)]
    canon = to(pack_tapes(tapes, capacity=512))
    arena = to(pack_tapes(tapes, capacity=512, op_order=order))
    nf = pack_tapes(tapes).nf
    T = len(tapes)
    rng = np.random.default_rng(5)
    duals = torch.from_numpy(
        rng.uniform(-1, 1, size=(T, 3, 4, S0, 128)).astype(np.float32)
    ).to(card)
    kw = dict(nf=nf, n_inputs=3, n_outputs=1, s0=S0)
    got = interp_grad(*arena, duals, op_order=order, **kw)
    want = interp_grad_plain(*arena, duals, op_order=order, **kw)
    torch.testing.assert_close(got[:, :, 0], want[:, :, 0], rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got[:, :, 1:], want[:, :, 1:], rtol=1e-4, atol=1e-4)
    assert torch.equal(got, interp_grad(*canon, duals, **kw))
    pts = torch.from_numpy(
        rng.uniform(-1, 1, size=(T, 3, 32, 128)).astype(np.float32)
    ).to(card)
    kw = dict(nf=nf, n_inputs=3, s0=32, sub=16)
    got = interp_voxel_depth(*arena, pts, op_order=order, **kw)
    assert torch.equal(got, interp_voxel_depth_plain(*arena, pts,
                                                     op_order=order, **kw))
    assert torch.equal(got, interp_voxel_depth(*canon, pts, **kw))
    assert (got > 0).any()


#: (s0, nf_pad) of K4 on the adversarial tapes: its lanes a thread on
#: the shared-memory register files, and the global scratch
GRAD_CASES = [(8, 0), (1, 0), (8, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("s0,nf_pad", GRAD_CASES)
def test_adversarial_grad_matches_plain(card, s0, nf_pad):
    """K4 on the adversarial tapes: bit for bit against the plain
    version (every op of these tapes rounds correctly in f32, duals
    too), on both register-file routes."""
    A = adversarial_arena(cuda.TAPE_CHUNK)
    arena = [torch.from_numpy(A[k]).to(card)
             for k in ("w1", "w2", "imm", "lengths")]
    T = len(A["names"])
    nf = max(A["nf"], nf_pad)
    g = cuda.launch_geometry("interp_grad", nf=nf, lanes=s0 * 128, T=T)
    assert g.regs_shared == (nf_pad == 0)
    rng = np.random.default_rng(9)
    duals = torch.from_numpy(rng.uniform(
        -1.5, 1.5, size=(T, 2, 4, s0, 128)).astype(np.float32)).to(card)
    kw = dict(nf=nf, n_inputs=2, n_outputs=2, s0=s0)
    cuda.reset_launches()
    got = interp_grad(*arena, duals, **kw)
    assert cuda.LAUNCHES["interp_grad"] == 1
    want = interp_grad_plain(*arena, duals, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got[A["names"].index("len0")] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tangents", [1, 2])
@pytest.mark.parametrize("s0,nf_pad", GRAD_CASES)
def test_narrow_grad_equals_the_four_plane_kernel(card, tangents, s0, nf_pad):
    """K4 at 2 and 3 planes a dual on the adversarial tapes: bit for bit
    the first 1 + tangents planes of the four-plane kernel's result and
    the narrow plain version, at two lanes and one lane a thread with
    shared register files, and at two with the global scratch, where the
    narrow dual runs as four planes (one launch)."""
    A = adversarial_arena(cuda.TAPE_CHUNK)
    arena = [torch.from_numpy(A[k]).to(card)
             for k in ("w1", "w2", "imm", "lengths")]
    T = len(A["names"])
    nf = max(A["nf"], nf_pad)
    P = 1 + tangents
    g = cuda.launch_geometry("interp_grad", nf=nf, lanes=s0 * 128, T=T,
                             tangents=tangents)
    assert (g.r, g.regs_shared) == (1 if s0 == 1 else 2, nf_pad == 0)
    rng = np.random.default_rng(9)
    duals = torch.from_numpy(rng.uniform(
        -1.5, 1.5, size=(T, 2, 4, s0, 128)).astype(np.float32)).to(card)
    kw = dict(nf=nf, n_inputs=2, n_outputs=2, s0=s0)
    full = interp_grad(*arena, duals, **kw)
    narrow = duals[:, :, :P].contiguous()
    cuda.reset_launches()
    got = interp_grad(*arena, narrow, **kw)
    assert cuda.LAUNCHES["interp_grad"] == 1
    assert got.shape == (T, 2, P, s0, 128)
    want = full[:, :, :P].contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    plain = interp_grad_plain(*arena, narrow, **kw)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


#: (sub, nf_pad) of K5 on the adversarial tapes: four lanes a thread at
#: sub 16 and 32 (4 and 32 blocks a subtile), one lane a thread (nf 256)
#: and the global scratch (nf 512)
VOXEL_CASES = [(16, 0), (32, 0), (16, 256), (16, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("sub,nf_pad", VOXEL_CASES)
def test_adversarial_voxel_depth_matches_plain(card, sub, nf_pad):
    """K5 on the adversarial tapes, with a ramp over vz in the inputs so
    that the surface moves within a column: depths bit for bit against
    the plain version."""
    A = adversarial_arena(cuda.TAPE_CHUNK)
    arena = [torch.from_numpy(A[k]).to(card)
             for k in ("w1", "w2", "imm", "lengths")]
    T = len(A["names"])
    nf = max(A["nf"], nf_pad)
    g = cuda.launch_geometry("interp_voxel_depth", nf=nf, lanes=sub**3, T=T,
                             sub=sub)
    assert g.regs_shared == (nf_pad < 512)
    rng = np.random.default_rng(10)
    vz = np.arange(sub**3) // (sub * sub)
    x = rng.uniform(-1.5, 1.5, size=(T, 2, sub**3)) + (vz / sub * 3 - 1.5)
    pts = torch.from_numpy(
        x.astype(np.float32).reshape(T, 2, sub**3 // 128, 128)).to(card)
    kw = dict(nf=nf, n_inputs=2, s0=sub**3 // 128, sub=sub)
    got = interp_voxel_depth(*arena, pts, **kw)
    assert torch.equal(got, interp_voxel_depth_plain(*arena, pts, **kw))
    assert len(got.unique()) > 4 and (got[A["names"].index("len0")] == 0).all()


@pytest.mark.cuda
def test_voxel_render_on_card_matches_brute(card):
    """A union of spheres, whose ops f32 rounds correctly on the card and
    in numpy alike, so depth equals numpy's `render_brute` exactly."""
    ctx = port.Context()
    tape = port.lower(ctx, [sphere_union_shape(ctx, n=60)])
    r = port.VoxelRenderer(tape, port.VoxelSize(128, 128, 128), tile_size=32,
                           sub_size=16, specialize=False)
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
    want = {"interp_interval": 2, "liveness_codes": 2, "interp_float": 1}
    assert cuda.LAUNCHES == {k: want.get(k, 0) for k in cuda.KERNELS}
    brute = r.render_brute()
    dist, fill = img.distance.cpu().numpy(), img.fill.cpu().numpy()
    ev = fill == FILL_NONE
    np.testing.assert_allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(img.inside().cpu().numpy(), brute < 0)
    cls = img.fill_class().cpu().numpy()
    assert (brute[cls == FILL_INSIDE] < 0).all()
    assert (brute[cls == FILL_OUTSIDE] > 0).all()
    assert (img.fill_level() == 1).any()


#: (nf_pad, cw) of K2 on the adversarial tapes: one mask word (nf 6),
#: two (64), choice words too many for shared memory, the byte plane in
#: shared memory (512) beside shared and device-memory choice words, and
#: the byte plane in device memory (2048)
LIVENESS_CASES = [(0, 2), (64, 2), (0, 512), (512, 2), (512, 512), (2048, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("nf_pad,cw", LIVENESS_CASES)
def test_adversarial_liveness_matches_plain(card, nf_pad, cw):
    """K2 on `scenes.adversarial_arena(liveness=True)` (tapes cut around
    the staging chunk, past L and 0, opcodes past the value modes,
    raw-field elisions that clamping would change, choices folding into
    the last word) per instance and, on the longest chain, as a shared
    tape: bit for bit against the plain version, on every route."""
    A = adversarial_arena(cuda.TAPE_CHUNK, liveness=True)
    w1, w2, lens = (torch.from_numpy(A[k]).to(card)
                    for k in ("w1", "w2", "lengths"))
    T, L = w1.shape
    nf = max(A["nf"], nf_pad)
    g = cuda.launch_geometry("liveness_codes", nf=nf, lanes=128, T=T, cw=cw)
    assert g.mask_words == (1 if nf <= 32 else 2 if nf <= 64 else 0)
    assert g.regs_shared == (nf <= 512)
    assert g.choices_shared == (cw == 2)
    rng = np.random.default_rng(6)
    ch = torch.from_numpy(
        rng.integers(-2**31, 2**31, size=(T, cw, 1, 128)).astype(np.int32)
    ).to(card)
    kw = dict(nf=nf, L=L, shared_tape=False)
    cuda.reset_launches()
    got = liveness_codes(w1, w2, lens, ch, **kw)
    assert cuda.LAUNCHES["liveness_codes"] == 1
    assert torch.equal(got, liveness_codes_plain(w1, w2, lens, ch, **kw))
    assert (got != 0).any() and (got[A["names"].index("len0")] == 0).all()
    t = A["names"].index(f"chain{L}")
    one = (w1[t:t + 1], w2[t:t + 1], lens[t:t + 1])
    kw = dict(nf=nf, L=L, shared_tape=True)
    got = liveness_codes(*one, ch[:3], **kw)
    assert torch.equal(got, liveness_codes_plain(*one, ch[:3], **kw))


#: (s0, nf_pad) of K6 on the adversarial tapes: 4, 2 and 1 lanes a
#: thread on the shared-memory register file, and the global scratch
CODED_CASES = [(8, 0), (2, 0), (1, 0), (8, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("s0,nf_pad", CODED_CASES)
def test_adversarial_coded_matches_plain(card, s0, nf_pad):
    """K6 with each adversarial tape as the shared tape of seven tiles:
    every row run, seeded codes that keep the dataflow (COPY from b on
    unary rows and immediates included), uniformly random codes (rows
    that read registers nothing wrote read 0), the seeded codes under a
    length past L, a culled tile, and random codes beyond a length cut
    inside a word (masked): bit for bit against the plain version."""
    A = adversarial_arena(cuda.TAPE_CHUNK)
    L = A["w1"].shape[1]
    nf = max(A["nf"], nf_pad)
    tiles = 7
    g = cuda.launch_geometry("interp_float_coded", nf=nf, lanes=s0 * 128,
                             T=tiles)
    assert g.r == min(4, s0) and g.regs_shared == (nf_pad == 0)
    rng = np.random.default_rng(8)
    for t, name in enumerate(A["names"]):
        n = min(int(A["lengths"][t]), L)
        codes = np.zeros((tiles, L), np.uint32)
        codes[0, :n] = 1
        codes[1] = seeded_action_codes(A["w1"][t], A["w2"][t], n, A["nf"], rng,
                                       any_row=True)
        codes[2] = rng.integers(0, 4, size=L)
        codes[3] = codes[1]
        codes[5] = rng.integers(0, 4, size=L)
        codes[6] = rng.integers(0, 4, size=L)
        lengths = torch.tensor([n, n, n, L + 7, 0, max(n - 5, 0), n],
                               dtype=torch.int32, device=card)
        words = torch.from_numpy(pack_action_codes(codes)).to(card)
        shared = [torch.from_numpy(np.ascontiguousarray(A[k][t:t + 1])).to(card)
                  for k in ("w1", "w2", "imm")]
        vars_ = torch.from_numpy(rng.uniform(
            -1.5, 1.5, size=(tiles, 2, s0, 128)).astype(np.float32)).to(card)
        kw = dict(nf=nf, n_inputs=2, n_outputs=2, s0=s0)
        got = interp_float_coded(*shared, lengths, words, vars_, **kw)
        want = interp_float_coded_plain(*shared, lengths, words, vars_, **kw)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name
        assert (got[4] == 0).all()


def _param_circle():
    """The circle of tests/test_grad_parity.py, sqrt((x-cx)^2 + y^2) - r,
    with its two Vars and their indices."""
    ctx = port.Context()
    cx, rv = port.Var.new(), port.Var.new()
    x, y = ctx.x(), ctx.y()
    dx = ctx.sub(x, ctx.input(cx))
    f = ctx.sub(ctx.sqrt(ctx.add(ctx.square(dx), ctx.square(y))), ctx.input(rv))
    tape = port.lower(ctx, [f])
    return tape, tape.var_map[cx], tape.var_map[rv]


@pytest.mark.cuda
def test_float_diff_on_card_matches_plain(card):
    """interp_float's derivative rules on the card (K3 primal, K4
    Jacobian in two passes for V = 4) against the same Function on the
    CPU's plain versions: primal 2e-5, reverse and forward derivatives
    1e-4, as the grad mode is held elsewhere."""
    import torch.autograd.forward_ad as fwAD

    tape, icx, irv = _param_circle()
    p = pack_tapes([tape], op_order=frequency_op_order(tape))
    rng = np.random.default_rng(5)
    vals = rng.uniform(-1, 1, size=(3, 4, S0, 128)).astype(np.float32)
    vals[:, icx], vals[:, irv] = 0.1, 0.5
    dv = rng.normal(size=vals.shape).astype(np.float32)
    w = rng.normal(size=(3, 1, S0, 128)).astype(np.float32)
    kw = dict(nf=tape.reg_count, n_inputs=4, n_outputs=1, s0=S0,
              op_order=frequency_op_order(tape))
    out = {}
    for dev in (card, torch.device("cpu")):
        arena = [torch.from_numpy(np.repeat(a, 3, axis=0)).to(dev)
                 for a in (p.w1, p.w2, p.imm)]
        arena.append(torch.full((3,), len(tape), dtype=torch.int32, device=dev))
        v = torch.from_numpy(vals).to(dev).requires_grad_(True)
        cuda.reset_launches()
        prim = interp_float(*arena, v, **kw)
        (prim * torch.from_numpy(w).to(dev)).sum().backward()
        with fwAD.dual_level():
            d = fwAD.make_dual(torch.from_numpy(vals).to(dev),
                               torch.from_numpy(dv).to(dev))
            tang = fwAD.unpack_dual(interp_float(*arena, d, **kw)).tangent
        if dev.type == "cuda":
            assert cuda.LAUNCHES["interp_float"] == 2
            assert cuda.LAUNCHES["interp_grad"] == 4  # two passes a mode
        out[dev.type] = [t.detach().cpu() for t in (prim, v.grad, tang)]
    (p_g, g_g, t_g), (p_c, g_c, t_c) = out["cuda"], out["cpu"]
    torch.testing.assert_close(p_g, p_c, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(g_g, g_c, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(t_g, t_c, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_bulk_evaluator_on_card_matches_cpu(card):
    """BulkEvaluator's four modes on the card (K3, K1, K4 over the tape
    copied on a power-of-two instance count) against the CPU's plain
    versions: values 2e-5, duals 1e-4, signs, classification and choice
    words exact, over a ragged count that spans three instances."""
    from fidget_tpu_torch.eval.bulk import LANE_ROWS, BulkEvaluator

    ctx = port.Context()
    tape = port.lower(ctx, [sphere_union_shape(ctx, n=40)])
    n = 2 * LANE_ROWS * 128 + 77
    rng = np.random.default_rng(6)
    pts = [rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3)]
    ivs = [(a, a + 0.05) for a in pts]
    res = {}
    for dev in ("cuda", "cpu"):
        ev = BulkEvaluator(tape, device=dev)
        (lo, hi), ch, _ = ev.eval_interval(*ivs, capture=True)
        res[dev] = [t.cpu() for t in (
            ev.eval(*pts), ev.eval(*pts, signs=True), lo, hi,
            ev.eval_interval(*ivs, classify=True), ch, ev.eval_grad(*pts),
        )]
    g, c = res["cuda"], res["cpu"]
    for i in (0, 2, 3):
        torch.testing.assert_close(g[i], c[i], rtol=2e-5, atol=2e-5)
    for i in (1, 4, 5):
        assert torch.equal(g[i], c[i])
    torch.testing.assert_close(g[6], c[6], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_build_mesh_on_card_matches_cpu(card):
    """A depth-5 mesh of a 40-sphere union (collapse on) built on the
    card equals the same build on the CPU's plain versions: triangles
    equal, vertices within 1e-5; K1, K3 and K4 all launched."""
    ctx = port.Context()
    tape = port.lower(ctx, [sphere_union_shape(ctx, n=40)])
    cuda.reset_launches()
    got = port.build_mesh(tape, port.MeshSettings(depth=5))
    launched = dict(cuda.LAUNCHES)
    want = port.build_mesh(tape, port.MeshSettings(depth=5, device="cpu"))
    for k in ("interp_interval", "interp_float", "interp_grad"):
        assert launched[k] > 0, k
    assert len(got.triangles) > 1000
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_unrolled_mesh_on_card_matches_cpu(card):
    """The compiled mesher (eval="unrolled") on the card: a depth-5 mesh
    of a 40-sphere union equal to the CPU's build (triangles equal,
    vertices within 1e-5), through U1-P (the sign table's leaf and merge
    entries, the edge search), U2-B on the levels and K4 and no K1 or K3;
    then the leaf entry and the first collapse round's merge entry (each
    from the table as the build left it before the call), the two again
    on a key list with duplicates, padding and a live count below its
    length (into a fresh table and into the build's), U1-P (both
    epilogues) and U2-B against their plain versions bit for bit (masks,
    topo, and the table's keys, signs and counts), on points and boxes
    with a live count, and the edge search and a level on the build's own
    crossing list and parents."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    ctx = port.Context()
    tape = port.lower(ctx, [sphere_union_shape(ctx, n=40)])
    from fidget_tpu_torch.mesh import fused

    calls = {}
    saved = {n: getattr(fused, n) for n in ("unrolled_edges", "level_active",
                                            "leaf_masks", "merge_topo")}

    def recorder(name):
        def call(*args, **kw):
            if name not in calls:  # the table as it was before the call
                tables = [a.clone() for a in args
                          if isinstance(a, uc.SignTable)]
                calls[name] = (args, kw, tables)
            return saved[name](*args, **kw)
        return call

    cuda.reset_launches()
    try:
        for n in saved:
            setattr(fused, n, recorder(n))
        got = port.build_mesh(tape, port.MeshSettings(depth=5,
                                                      eval="unrolled"))
    finally:
        for n, f in saved.items():
            setattr(fused, n, f)
    launched = dict(cuda.LAUNCHES)
    want = port.build_mesh(tape, port.MeshSettings(depth=5, device="cpu",
                                                   eval="unrolled"))
    for k in ("leaf_masks", "merge_topo", "unrolled_edges", "level_active",
              "interp_grad"):
        assert launched[k] > 0, k
    assert launched["unrolled_points"] == 0
    args, kw, _ = calls["unrolled_edges"]
    a = uc.unrolled_edges(*args, **kw)
    b = uc.unrolled_edges_plain(*args, **kw)
    assert torch.equal(a.nan_to_num(7.0), b.nan_to_num(7.0))
    args, kw, _ = calls["level_active"]
    assert all(torch.equal(x, y) for x, y in zip(
        uc.level_active(*args, **kw), uc.level_active_plain(*args, **kw)))
    assert launched["interp_interval"] == launched["interp_float"] == 0

    def plain_copy(table):
        t = uc.SignTable(0, card, plain=True)
        t.keys, t.signs = table.entries()
        t.count = table.count.clone()
        return t

    def held(table, plain):
        """The kernel's table holds the plain version's keys and signs."""
        for x, y in zip(table.entries(), plain.entries()):
            assert torch.equal(x, y)
        assert table.count.tolist() == plain.count.tolist()

    def both(name, args, table):
        """`name` on the card on `table` and its plain version on a plain
        copy of it: equal outputs, and the two tables hold the same."""
        plain = plain_copy(table)
        out = getattr(uc, name)(*args, table)
        ref = getattr(uc, name + "_plain")(*args, plain)
        assert torch.equal(out, ref), name
        held(table, plain)
        return out

    for name in ("leaf_masks", "merge_topo"):
        args, kw, (before,) = calls[name]
        out = both(name, args[:-1], before)
        assert 0 < int(before.count[0]) < int(out.numel()) * (
            8 if name == "leaf_masks" else 27)
    # a key list with duplicates, -1 padding and a live count below its
    # length, into a fresh table and into the one the build left, then a
    # collapse round on it: each distinct live point evaluated once
    kern, keys, _, h, mat, vv, _ = calls["leaf_masks"][0]
    ks = uc.LATTICE_KS
    keys = keys[keys >= 0][::3]
    keys = torch.cat([keys, keys[:50], keys[10:30] + ks,
                      torch.full((20,), -1, dtype=torch.int32, device=card)])
    keys = keys[torch.randperm(keys.numel(), device=card)]
    live = torch.tensor([keys.numel() - 15], dtype=torch.int32, device=card)
    for table in (uc.SignTable(8 * keys.numel(), card), before):
        both("leaf_masks", (kern, keys, live, h, mat, vv), table)
        both("merge_topo", calls["merge_topo"][0][:-1], table)
    assert len(got.triangles) > 1000
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=0, atol=1e-5)

    axis_of = {v.kind: i for v, i in tape.var_map.items()}
    V = max(1, len(tape.var_map))
    g = torch.Generator().manual_seed(5)
    pts = (torch.rand((3, 7, 1000), generator=g) * 2.4 - 1.2).to(card)
    count = torch.tensor([700], dtype=torch.int32, device=card)
    params = torch.zeros(V, device=card)
    for epi in uc.POINT_EPILOGUES:
        k = uc.PointsKernel(tape, axis_of, V, epi)
        a = uc.unrolled_points(k, *pts, params, count)
        b = uc.unrolled_points_plain(k, *pts, params, count)
        assert torch.equal(a, b), epi
    lo = pts - 0.05
    hi = pts + 0.05
    k = uc.BoxesKernel(tape, axis_of, V)
    a = uc.unrolled_interval_boxes(k, tuple(lo), tuple(hi), params, count)
    b = uc.unrolled_interval_boxes_plain(k, tuple(lo), tuple(hi), params,
                                         count)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# ----------------------------------------------------------------------
# the kernels generated per tape (eval/unrolled_cuda.py)


def _nan_div_tape():
    """NaN, an immediate denominator of 0 and one that spans zero, under
    min/max, and AND/OR choices."""
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    r = ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y)))
    d = ctx.min(ctx.sub(r, 0.6),
                ctx.max(ctx.sqrt(ctx.sub(x, 0.25)), ctx.sub(ctx.abs(x), 0.9)))
    d = ctx.max(d, ctx.min(ctx.div(ctx.sub(y, 0.1), 0.0), ctx.sub(r, 0.95)))
    d = ctx.min(d, ctx.max(ctx.div(ctx.sub(x, 0.3), ctx.add(y, 0.05)),
                           ctx.sub(r, 0.4)))
    return port.lower(ctx, [ctx.or_(ctx.and_(d, ctx.sub(r, 0.5)),
                                    ctx.sub(ctx.abs(y), 0.8))])


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["union", "nan_div"])
def test_unrolled_kernels_match_plain(card, which, monkeypatch):
    """U2 with each epilogue (flags and words exact) at 4 and 8 warps a
    group and U1 over a union plan's programs and the fallback in one
    launch, and over the full tape alone (exact: these tapes hold no
    transcendental), against their plain versions on the card, on the
    tiles and worklist of a 256^2 union frame; each launch counted under
    its own name."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc
    from fidget_tpu_torch.render import unrolled2d as u2

    tape = _union_tape(40) if which == "union" else _nan_div_tape()
    r = port.PixelRenderer(tape, port.ImageSize(256, 256))
    r.render_unrolled(leaf="union", block_px=64)
    st = u2.state(r)
    plan = st.plans[(8, 64)]
    tb = u2.union_tables(r, plan, 128)
    x0, y0 = st.tiles(8)
    mat, z, vec = u2._device_args(r, r._mat4(None), 0.0, r._var_vec(None))
    params = uc.params_tensor(mat, z, vec)
    xp, yp = x0[tb.perm], y0[tb.perm]
    V = r.n_inputs
    cuda.reset_launches()
    for warps in (4, 8):
        monkeypatch.setattr(uc, "INTERVAL_WARPS", warps)
        for epi in uc.EPILOGUES:
            k = uc.IntervalKernel(tape, r.axis_of, V, epi)
            u = tb.u_tile if epi == "violation" else None
            got = uc.unrolled_interval(k, xp, yp, params, 8.0, u)
            want = uc.unrolled_interval_plain(k, xp, yp, params, 8.0, u)
            for g, w in zip(got, want):
                assert (g is None and w is None) or torch.equal(g, w), epi
    assert cuda.LAUNCHES["unrolled_interval"] == 6
    n = tb.total
    idx = torch.randint(0, x0.shape[0], (n,), generator=torch.Generator()
                        .manual_seed(2)).to(card)
    valid = torch.arange(n, device=card) % 7 != 3
    programs = list(plan.programs) + [tape]
    for tapes, seg in ((programs, tb.seg), ([tape], (0,))):
        k = uc.FloatKernel(tapes, r.axis_of, V)
        got = uc.unrolled_float(k, x0[idx], y0[idx], valid, params, seg,
                                tw=8, pp=64)
        want = uc.unrolled_float_plain(k, x0[idx], y0[idx], valid,
                                       params, seg, tw=8, pp=64)
        torch.testing.assert_close(got, want, rtol=0, atol=0,
                                   equal_nan=True)
        assert (got[~valid] == 0).all()
    assert cuda.LAUNCHES["unrolled_float"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gyroid", "union"])
def test_3d_unrolled_kernels_match_plain(card, which):
    """U2-3D (`unrolled_interval3`) on 3D boxes at two edges, under an
    affine and a perspective matrix, and U1-3D (`unrolled_voxel_depth`)
    over a worklist of 16^3 subtiles with invalid slots, at every group
    of lanes a column, against their plain versions on the card: proofs
    and depths bit for bit, each launch counted under its own name; then
    their frame entries: U2-3D's `unrolled_proofs3` over the roots of a
    128^3 frame and their subtiles at each layout, U1-3D's
    `unrolled_voxel_fold` on a stratum's worklist at every group."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    if which == "gyroid":
        tape = gyroid_sphere(port).tape()
    else:
        ctx = port.Context()
        tape = port.lower(ctx, [sphere_union_shape(ctx, n=60)])
    axis_of = {v.kind: i for v, i in tape.var_map.items()}
    V = max(1, len(tape.var_map))
    s2w = port.VoxelSize(128, 128, 128).screen_to_world().astype(np.float32)
    turn = np.array([[0.96, -0.28, 0.0, 0.05], [0.2688, 0.9216, -0.28, -0.03],
                     [0.0784, 0.2688, 0.96, 0.02], [0.0, 0.0, 0.0, 1.0]])
    persp = np.eye(4)
    persp[3, 2] = 0.3
    rng = np.random.default_rng(14)
    k3 = uc.Interval3Kernel(tape, axis_of, V)
    kv = uc.VoxelKernel(tape, axis_of, V)
    cuda.reset_launches()
    for m in (turn, persp @ turn):
        mat = torch.from_numpy((m @ s2w).astype(np.float32)).to(card)
        params = uc.params_tensor(mat, torch.zeros((), device=card),
                                  torch.zeros(V, device=card))
        for edge in (16, 32):
            x0, y0, z0 = (torch.from_numpy((rng.integers(0, 128 // edge, 3000)
                                            * edge).astype(np.float32)).to(card)
                          for _ in range(3))
            got = uc.unrolled_interval3(k3, x0, y0, z0, params, edge)
            want = uc.unrolled_interval3_plain(k3, x0, y0, z0, params, edge)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
        n, sub = 700, 16
        bx, by, bz = (torch.from_numpy((rng.integers(0, 8, n) * sub)
                                       .astype(np.float32)).to(card)
                      for _ in range(3))
        valid = torch.arange(n, device=card) % 7 != 3
        want = uc.unrolled_voxel_depth_plain(kv, bx, by, bz, valid, params,
                                             sub=sub)
        for G in uc.VOXEL_GROUPS:
            got = uc.unrolled_voxel_depth(kv, bx, by, bz, valid, params,
                                          sub=sub, group=G)
            assert torch.equal(got, want)
        assert (got[~valid] == 0).all() and len(got.unique()) > 4
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["unrolled_interval3"] == 4
    assert cuda.LAUNCHES["unrolled_voxel_depth"] == 2 * len(uc.VOXEL_GROUPS)

    from fidget_tpu_torch.render import render3d

    ts, sub = 32, 16
    geo = render3d._geo3(128, 128, 128, ts, sub)
    st = geo.statics(card)
    roots = st["tile_x0"], st["tile_y0"], st["tile_z0"]
    act = torch.from_numpy(rng.random(geo.nl * geo.ny2 * geo.nx2) < 0.4)
    act = act.to(card)
    order = render3d._compact_stratum(act, nl=geo.nl, ny2=geo.ny2,
                                      nx2=geo.nx2, cap_s=160,
                                      decode=False)["order"]
    z_lo = torch.tensor([64.0], device=card)
    floor = torch.from_numpy(rng.integers(0, 64, (128, 128)).astype(
        np.int32)).to(card)
    cuda.reset_launches()
    want = uc.unrolled_proofs3_plain(k3, *roots, params, ts, sub)
    for k in uc.PROOFS3_WARPS:
        kk = uc.Interval3Kernel(tape, axis_of, V, warps=k)
        got = uc.unrolled_proofs3(kk, *roots, params, ts, sub)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    want = uc.unrolled_voxel_fold_plain(kv, order, act.sum(), z_lo, params,
                                        floor.clone(), sub=sub, nl=geo.nl)
    assert not torch.equal(want, floor)
    for G in uc.VOXEL_GROUPS:
        got = uc.unrolled_voxel_fold(kv, order, act.sum(), z_lo, params,
                                     floor.clone(), sub=sub, nl=geo.nl,
                                     group=G)
        assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["unrolled_proofs3"] == len(uc.PROOFS3_WARPS)
    assert cuda.LAUNCHES["unrolled_voxel_fold"] == len(uc.VOXEL_GROUPS)


@pytest.mark.cuda
def test_per_shape_and_compiled_voxel_render_on_card_match_brute(card):
    """The per-shape frame (the default) and the compiled frames
    (`leaf="unrolled"` under both proofs) of a sphere union at 128^3 on
    the card: depth equal to `render_brute` exactly, normals allclose to
    `brute_normals`, each mode through its own kernels; the per-shape
    frame adopts a strata schedule after its first frame."""
    ctx = port.Context()
    tape = port.lower(ctx, [sphere_union_shape(ctx, n=60)])
    size = port.VoxelSize(128, 128, 128)
    brute = None
    modes = [
        ({}, {"interp_interval", "liveness_codes", "interp_grad",
              "interp_voxel_depth"}),
        ({"leaf": "unrolled"}, {"interp_interval", "liveness_codes",
                                "interp_grad", "unrolled_voxel_fold"}),
        ({"leaf": "unrolled", "proofs": "unrolled"},
         {"unrolled_proofs3", "interp_grad", "unrolled_voxel_fold"}),
    ]
    for kw, kernels in modes:
        r = port.VoxelRenderer(tape, size, tile_size=32, sub_size=16, **kw)
        assert r.device.type == "cuda" and r.specialize
        r.render()
        assert r._sched is not None
        if brute is None:
            brute = r.render_brute().depth.numpy()
        cuda.reset_launches()
        img = r.render()
        torch.cuda.synchronize()
        assert {k for k, v in cuda.LAUNCHES.items() if v} == kernels, kw
        depth = img.depth.cpu().numpy()
        np.testing.assert_array_equal(depth, brute)
        hit = depth > 0
        np.testing.assert_allclose(img.normal.cpu().numpy()[hit],
                                   r.brute_normals(depth)[hit], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.cuda
def test_render_unrolled_on_card_matches_brute(card):
    """render_unrolled (union and full leaf, cull unrolled and interp,
    8- and 16-px tiles) and render_dense on the card: occupancy equal to
    render_brute and to render()'s, distances allclose where evaluated,
    each mode through its own kernels."""
    tape = _union_tape(40)
    r = port.PixelRenderer(tape, port.ImageSize(256, 256))
    pan = np.array([[1.1, 0.0, 0.05], [0.0, 1.1, -0.03], [0.0, 0.0, 1.0]])
    brute = r.render_brute(pan)
    occ = r.render(pan).inside().cpu().numpy()
    modes = [
        (dict(leaf="union", block_px=64), {"unrolled_interval",
                                            "unrolled_float"}),
        (dict(leaf="full"), {"unrolled_interval", "unrolled_float"}),
        (dict(leaf="full", cull="interp", tile_size=16),
         {"interp_interval", "unrolled_float"}),
        (None, {"unrolled_float"}),
    ]
    for kw, kernels in modes:
        if kw is not None:
            r.render_unrolled(pan, **kw)  # builds, sizes the worklist
        cuda.reset_launches()
        img = (r.render_dense(pan) if kw is None
               else r.render_unrolled(pan, **kw))
        torch.cuda.synchronize()
        assert {k for k, v in cuda.LAUNCHES.items() if v} == kernels, kw
        dist, fill = img.distance.cpu().numpy(), img.fill.cpu().numpy()
        ev = fill == FILL_NONE
        np.testing.assert_allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(img.inside().cpu().numpy(), brute < 0)
        np.testing.assert_array_equal(img.inside().cpu().numpy(), occ)


@pytest.mark.cuda
def test_unrolled_gradients_on_card_match_cpu(card):
    """The dense and the pixel_perfect unrolled frame are differentiable
    on the card (U1 value, K4 Jacobian): reverse mode equals forward
    mode there and the CPU's gradient."""
    cx = port.Var.new()
    ctx = port.Context()
    x, y = ctx.x(), ctx.y()
    dx = ctx.sub(x, ctx.input(cx))
    tape = port.lower(ctx, [ctx.sub(
        ctx.sqrt(ctx.add(ctx.square(dx), ctx.square(y))), 0.5)])
    out = {}
    for dev in ("cuda", "cpu"):
        r = port.PixelRenderer(tape, port.ImageSize(64, 64), device=dev)
        mat, vec = r._mat4(None), r._var_vec({cx: 0.1})
        for label, frame in (
            ("dense", lambda v: r._dense(mat, 0.0, v)),
            ("unrolled", lambda v: r._frame_unrolled(
                mat, 0.0, v, tile_size=16, pixel_perfect=True)[0]),
        ):
            loss = lambda v: (frame(v) ** 2).sum()
            v = torch.tensor(vec, device=dev, requires_grad=True)
            loss(v).backward()
            g_fwd = torch.func.jacfwd(loss)(torch.tensor(vec, device=dev))
            torch.testing.assert_close(v.grad, g_fwd, rtol=1e-5, atol=1e-6)
            out[(dev, label)] = v.grad.cpu()
    for label in ("dense", "unrolled"):
        torch.testing.assert_close(out[("cuda", label)], out[("cpu", label)],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_unrolled_build_is_cached(card):
    """A second build of the same kernels runs no nvcc."""
    from fidget_tpu_torch.eval import unrolled_cuda as uc

    tape = _union_tape(8, seed=4)
    axis = {v.kind: i for v, i in tape.var_map.items()}
    kernels = [uc.FloatKernel([tape], axis, 2),
               uc.IntervalKernel(tape, axis, 2, "capture")]
    uc.build_kernels(kernels)
    assert uc.built(kernels)
    assert uc.build_kernels(kernels) == {}


# ----------------------------------------------------------------------
# the probes P2 (two tape streams an instance) and P3 (a grid step)


def _bit_equal(got, want):
    return bool(((got.view(torch.int32) == want.view(torch.int32))
                 | (torch.isnan(got) & torch.isnan(want))).all())


def _interleave_case(which, dev):
    """(args, nf, s0) of the inputs chip_smoke.py's phase 12 checks."""
    from fidget_tpu_torch.demos import exp_interleave as p2
    from fidget_tpu_torch.scenes import (
        interleave_op_arena,
        mixed_class_tapes,
        prefixed_random_tapes,
    )

    if which == "reference":
        return p2.split_streams(*p2.reference_inputs(dev)), p2.NF_REF, p2.S0_REF
    if which == "ops":
        *tapes, vars_, _ = interleave_op_arena(8, past_nf=True)
        T, L = tapes[0].shape
        lens = np.full(T, L, np.int32)
        return [torch.from_numpy(a).to(dev) for a in (*tapes, lens, vars_)], 8, 8
    # random tapes behind INPUT rows: "prefixed" and "odd" (an odd length
    # past two chunks) of `random_tape`s, "mixed" of classed and switch
    # rows in every chunk, "scratch" with files no block holds
    T, L, nf, s0 = {"prefixed": (64, 700, 32, 8), "odd": (16, 555, 32, 4),
                    "mixed": (64, 700, 32, 8),
                    "scratch": (8, 100, 600, 1)}[which]
    make = mixed_class_tapes if which == "mixed" else prefixed_random_tapes
    w1, w2, imm, rng = make(2 * T, L, nf, 3, seed=7)
    vars_ = rng.normal(size=(T, 3, s0, 128)).astype(np.float32)
    lens = rng.integers(0, nf + L, T).astype(np.int32)
    arrays = (w1[:T], w2[:T], imm[:T], w1[T:], w2[T:], imm[T:], lens, vars_)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays], nf, s0


INTERLEAVE_CASES = ["reference", "prefixed", "odd", "mixed", "ops", "scratch"]


@pytest.mark.cuda
@pytest.mark.parametrize("which", INTERLEAVE_CASES)
def test_interleave_kernel_matches_plain(card, which):
    """P2 against its plain version, bit for bit: the reference's own
    tapes at its shapes, INPUT-prefixed random tapes (with `lens` short
    of Lcap, which the kernel must ignore; one case of odd length), tapes
    that mix classed and switch rows in one chunk, one tape per opcode
    0-30 and 31, 40, 127 with immediates, an aux past V and registers
    past nf, and register files in the global scratch (nf 600)."""
    from fidget_tpu_torch.demos import exp_interleave as p2

    args, nf, s0 = _interleave_case(which, card)
    assert args[0].shape[1] % 2 == (which == "odd")
    g = cuda.launch_geometry("interp_float2", nf=nf, lanes=s0 * 128,
                             T=args[0].shape[0])
    assert g.regs_shared == (which != "scratch")
    before = cuda.LAUNCHES["interp_float2"]
    got = p2.interp_float2(*args, nf=nf, s0=s0)
    torch.cuda.synchronize()
    assert cuda.LAUNCHES["interp_float2"] == before + 1
    want = p2.interp_float2_plain(*args, nf=nf, s0=s0)
    assert _bit_equal(got, want)
    full = list(args)
    full[6] = torch.full_like(args[6], args[0].shape[1])
    assert _bit_equal(p2.interp_float2(*full, nf=nf, s0=s0), got)


@pytest.mark.cuda
@pytest.mark.parametrize("which", INTERLEAVE_CASES)
@pytest.mark.parametrize("r", [4, 2, 1])
def test_interleave_each_layout_matches_plain(card, r, which):
    """P2 at each lanes a thread (4: one block an SM at nf 32) on every
    case of `test_interleave_kernel_matches_plain` whose lanes it
    divides, bit for bit."""
    from fidget_tpu_torch.demos import exp_interleave as p2

    args, nf, s0 = _interleave_case(which, card)
    if (s0 * 128) % (cuda.BLOCK * r):
        pytest.skip(f"{s0 * 128} lanes are no whole blocks of {r} lanes "
                    f"a thread")
    got = p2.interp_float2(*args, nf=nf, s0=s0, lanes_per_thread=r)
    assert _bit_equal(got, p2.interp_float2_plain(*args, nf=nf, s0=s0))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1024, 4096, 16384])
@pytest.mark.parametrize("G", [1, 4, 16])
def test_grid_step_matches_plain(card, T, G):
    """P3 against its plain version, bit for bit (a multiply and an add,
    each rounded, on both sides)."""
    from fidget_tpu_torch.demos import exp_grid_overhead as p3

    x = torch.from_numpy((np.random.default_rng(T + G).normal(
        size=(T, 8, 128)) * 1000).astype(np.float32)).to(card)
    assert torch.equal(p3.grid_step(x, G), p3.grid_step_plain(x, G))


@pytest.mark.cuda
def test_grid_step_graph_matches_eager(card):
    """`many` replayed from a CUDA graph gives the eager acc bit for bit;
    the kernel's launches count at capture, not at replay."""
    from fidget_tpu_torch.demos import exp_grid_overhead as p3

    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1024, 8, 128)).astype(np.float32)).to(card)
    eager = float(p3.many(x, 8, 4))
    graph, static_x, acc = p3.capture(x, 8, 4)
    before = cuda.LAUNCHES["grid_step"]
    graph.replay()
    graph.replay()
    assert float(acc) == eager
    assert cuda.LAUNCHES["grid_step"] == before


@pytest.mark.cuda
def test_cli_render3d_ssao_effects_match_the_cpu(card, tmp_path, monkeypatch):
    """`render3d --mode shaded --ssao` at 128^3 on the card: its frame is
    captured, and the effects run again on the CPU on that frame's depth
    and normals; denoised normals within 1e-6, SSAO equal on 99.9% of
    filled pixels (the rest by exactly 1/64), the written image within 1
    level on 99% of pixels and within 4 everywhere."""
    from fidget_tpu_torch import cli
    from fidget_tpu_torch.io.image import png_pixels
    from fidget_tpu_torch.render import effects, render3d
    from fidget_tpu_torch.scenes import GYROID_SPHERE_RHAI

    frames = []
    render = render3d.VoxelRenderer.render

    def capture(self, *a, **k):
        img = render(self, *a, **k)
        frames.append(img)
        return img

    monkeypatch.setattr(render3d.VoxelRenderer, "render", capture)
    src = tmp_path / "gyroid.rhai"
    src.write_text(GYROID_SPHERE_RHAI)
    out = tmp_path / "out.png"
    assert cli.main(["render3d", str(src), "-s", "128", "--mode", "shaded",
                     "--ssao", "--pitch", "-25", "--yaw", "-30",
                     "-o", str(out)]) == 0
    (img,) = frames
    assert img.depth.is_cuda
    got = png_pixels(out.read_bytes())

    depth, normal = img.depth.cpu(), img.normal.cpu()
    dn_card = effects.denoise_normals(img.depth, img.normal)
    dn = effects.denoise_normals(depth, normal)
    torch.testing.assert_close(dn_card.cpu(), dn, rtol=0, atol=1e-6)
    s_card = effects.compute_ssao(img.depth, dn_card, vdepth=128).cpu()
    s = effects.compute_ssao(depth, dn, vdepth=128)
    filled = depth > 0
    assert torch.equal(torch.isnan(s_card), ~filled)
    diff = (s_card - s)[filled].abs()
    assert (diff == 0).double().mean() >= 0.999
    assert torch.all((diff == 0) | (diff == 1.0 / 64))
    want = torch.flip(effects.apply_shading(depth, dn, vdepth=128, ssao=True),
                      dims=[0]).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d <= 1).mean() >= 0.99 and d.max() <= 4


def test_solve_on_card_matches_cpu(card):
    """`solve` on the card (K3 residuals, K4 Jacobians) against the plain
    versions on the CPU: the linkage and a 16-point chain."""
    from fidget_tpu_torch import solver as S
    from fidget_tpu_torch.scenes import chain_system, linkage_system

    for eqs, start in (linkage_system(port), chain_system(port, 16)):
        free = [v for v, (_, f) in start.items() if f]
        fixed = [v for v, (_, f) in start.items() if not f]
        params = {v: S.Parameter.Free(x) if f else S.Parameter.Fixed(x)
                  for v, (x, f) in start.items()}
        cuda.reset_launches()
        got = S.solve(eqs, params)
        assert cuda.LAUNCHES["interp_float"] and cuda.LAUNCHES["interp_grad"]
        want = S.Solver(eqs, free, fixed, device="cpu").solve(params)
        np.testing.assert_allclose([got[v] for v in free],
                                   [want[v] for v in free], rtol=0, atol=1e-4)


def _param_standin(n):
    """The parametrized stand-in at n circles (x, y, shift, grow), with
    its two Vars."""
    from fidget_tpu_torch.scenes import param_standin_shape

    ctx = port.Context()
    shift, grow = port.Var.new(), port.Var.new()
    tape = port.lower(ctx, [param_standin_shape(
        ctx, ctx.input(shift), ctx.input(grow), n=n)])
    return tape, shift, grow


@pytest.mark.cuda
def test_fit_backward_waits_for_nothing(card):
    """The fit's backward through U1's leaf (its Jacobian in one K4
    pass) only queues work: no call in it waits for the card, under
    CUDA's sync debug mode. A copy from the host inside it would stall
    the step's launches behind K4."""
    from fidget_tpu_torch.parallel import sharding as sh
    from fidget_tpu_torch.render.unrolled2d import ready, state

    tape, shift, grow = _param_standin(40)
    r = sh._renderer(port.PixelRenderer, tape, port.ImageSize(256, 256), card)
    ready(r, [state(r).float_full], "block")
    vec = torch.tensor(r._var_vec({shift: 0.013, grow: -0.004}),
                       device=card, requires_grad=True)
    mat = torch.as_tensor(r._mat4(None), device=card)
    z = torch.zeros((), device=card)
    loss = (sh._dense_rows(r, 0, 256, mat, z, vec) ** 2).sum()
    torch.cuda.synchronize()
    cuda.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        (g,) = torch.autograd.grad(loss, vec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda.LAUNCHES["interp_grad"] == 1
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.cuda
def test_fit_step_takes_one_narrow_jacobian_pass(card, monkeypatch):
    """A 256^2 `fit_step` through U1 on a 40-circle parametrized
    stand-in (x, y, shift, grow): K4 once a step, in the two shape
    parameters alone, and the gradient it reduces equals, bit for bit,
    that of the Jacobian in every input (passes of 3 tangents and 1,
    then the axis columns zeroed), which the step took before."""
    import socket

    import torch.distributed as dist

    from fidget_tpu_torch.parallel import sharding as sh
    from fidget_tpu_torch.render import unrolled2d

    tape, shift, grow = _param_standin(40)
    size = port.ImageSize(256, 256)
    params = {shift: 0.013, grow: -0.004}
    target = torch.from_numpy(np.random.default_rng(3).uniform(
        -0.2, 0.2, size=(256, 256)).astype(np.float32))
    reduced = []
    all_reduce = sh.all_reduce

    def record(mesh, t):
        reduced.append(t.detach().clone())
        return all_reduce(mesh, t)

    jacobian = unrolled2d._FloatJacobian

    class EveryInput:
        @staticmethod
        def apply(*args):
            *tensors, cfg = args
            J = jacobian.apply(*tensors, cfg[:5])
            keep = torch.zeros(cfg[1], dtype=J.dtype, device=J.device)
            keep[list(cfg[5])] = 1.0
            return J * keep[:, None, None]

    monkeypatch.setattr(sh, "all_reduce", record)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port_no}",
                            rank=0, world_size=1)
    try:
        mesh = sh.make_mesh()
        steps, grads = [], []
        for every in (False, True):
            if every:
                monkeypatch.setattr(unrolled2d, "_FloatJacobian", EveryInput)
            reduced.clear()
            cuda.reset_launches()
            steps.append(sh.fit_step(tape, size, mesh, params, target))
            torch.cuda.synchronize()
            assert cuda.LAUNCHES["interp_grad"] == (2 if every else 1)
            grads.append(reduced[0])
    finally:
        dist.destroy_process_group()
    (new, loss), (old, old_loss) = steps
    kept = [tape.var_map[shift], tape.var_map[grow]]
    g, g_old = grads[0][kept], grads[1][kept]
    assert g.abs().min() > 0
    assert torch.equal(g.view(torch.int32), g_old.view(torch.int32))
    assert torch.equal(grads[0], grads[1])  # the axis entries 0 in both
    assert new == old and loss == old_loss


def test_sharded_world_of_one_on_card(card):
    """The sharded frames in a world of 1 under NCCL equal the
    single-device frames of their bindings, bit for bit."""
    import socket

    import torch.distributed as dist

    from fidget_tpu_torch.parallel import sharding as sh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port_no = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port_no}",
                            rank=0, world_size=1)
    try:
        mesh = sh.make_mesh()
        ctx = port.Context()
        x, y = ctx.x(), ctx.y()
        ring = port.lower(ctx, [ctx.sub(ctx.abs(ctx.sub(ctx.sqrt(ctx.add(
            ctx.square(x), ctx.square(y))), 0.6)), 0.15)])
        size = port.ImageSize(256, 256)
        img = sh.render_tiles_sharded(ring, size, mesh)
        want = port.PixelRenderer(ring, size, specialize=True).render()
        assert torch.equal(img.distance, want.distance)
        assert torch.equal(img.fill, want.fill)
        img = sh.render_unrolled_sharded(ring, size, mesh)
        want = port.PixelRenderer(ring, size).render_unrolled()
        assert torch.equal(img.distance, want.distance)
        assert torch.equal(img.fill, want.fill)
        size3 = port.VoxelSize(128, 128, 128)
        gyroid = gyroid_sphere(port)
        img = sh.render_voxels_sharded(gyroid, size3, mesh, tile_size=32,
                                       sub_size=16)
        want = port.VoxelRenderer(gyroid, size3, tile_size=32,
                                  sub_size=16).render()
        assert torch.equal(img.depth, want.depth)
        torch.testing.assert_close(img.normal, want.normal, rtol=0,
                                   atol=1e-4)
    finally:
        dist.destroy_process_group()
