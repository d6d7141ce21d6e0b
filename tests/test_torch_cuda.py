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
