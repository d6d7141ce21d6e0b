"""The launch geometry of the redesigned kernels (K1-K6), and the
hand-packed tapes that `chip_smoke.py` and the card tests run through
them, on the CPU.

`launch_geometry` (fidget_tpu_torch/eval/cuda.py) is plain Python: it
decides lanes per thread, shared-memory bytes, the tape chunk and the
register-file (K2: liveness) and choice-word routes of a launch, so
every branch of it is covered here without a card. The adversarial
tapes (`scenes.adversarial_arena`) are built to break the kernels' tape
staging; on the card the kernels are held to the plain PyTorch versions
on them, so here the plain versions are held to the reference's
`interp_float` / `interp_interval` / `_liveness_codes` /
`interp_float_coded` / `interp_grad` / `interp_voxel_depth` in
interpret mode on the same arena and the same seeded numpy inputs
(values equal at rtol 1e-6, atol 1e-7, the tolerance of
tests/test_torch_kernels.py; every op of these tapes rounds correctly
in f32; choice words, action codes and voxel depths exact; K4 at its
tolerances of tests/test_torch_cuda.py, 2e-5 on values and 1e-4 on
derivatives).
"""

import numpy as np
import pytest
import torch

from fidget_tpu.eval import pallas_interp as ref_interp
from fidget_tpu.eval.simplify_device import _liveness_codes

from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval.interp import (
    interp_float,
    interp_float_coded,
    interp_grad,
    interp_interval,
    interp_voxel_depth,
)
from fidget_tpu_torch.eval.simplify_device import liveness_codes
from fidget_tpu_torch.scenes import (
    adversarial_arena,
    pack_action_codes,
    seeded_action_codes,
)

SMEM_BLOCK_MAX = 232448

#: (label, nf, lanes, T, cw): the main paths' launches (bucketed nf 64 and
#: the tape's 13 registers; leaf, two-level leaf and subtile lanes; the
#: bucket's, the shape's and the 3D choice words), oversized register
#: files, and choice words too many for shared memory
GEOMETRY_CASES = [
    ("2d-root-bucket", 64, 1024, 1, 128),
    ("2d-root-regs", 13, 1024, 1, 128),
    ("2d-root-shape", 13, 1024, 1, 67),
    ("2d-leaf-bucket", 64, 16384, 64, 0),
    ("2d-leaf-regs", 13, 16384, 64, 0),
    ("2d-leaf-two-level", 13, 1024, 1024, 0),
    ("2d-subtiles", 13, 128, 64, 67),
    ("3d-root", 64, 1024, 1, 1),
    ("3d-subtiles", 64, 128, 64, 1),
    ("3d-voxels-sub8", 64, 512, 1024, 0),
    ("nf256", 256, 1024, 3, 4),
    ("nf256-pad", 256 + 64, 16384, 64, 4),
    ("nf512", 512, 1024, 9, 2),
    ("nf512-wide", 512, 16384, 64, 2),
    ("cw-overflow", 13, 1024, 1, 512),
    ("cw-overflow-nf512", 512, 128, 9, 512),
]


@pytest.mark.parametrize(
    "kernel",
    ["interp_float", "interp_interval", "liveness_codes", "interp_float_coded"],
)
@pytest.mark.parametrize("case", GEOMETRY_CASES, ids=lambda c: c[0])
def test_launch_geometry(kernel, case):
    _, nf, lanes, T, cw = case
    g = cuda.launch_geometry(kernel, nf=nf, lanes=lanes, T=T, cw=cw)
    assert g.chunk > 0 and g.chunk % 16 == 0
    assert g.smem <= SMEM_BLOCK_MAX
    assert g.r in (1, 2, 4) and lanes % (cuda.BLOCK * g.r) == 0
    assert g.blocks == T * lanes // (cuda.BLOCK * g.r)
    if kernel == "liveness_codes":
        # one lane a thread; liveness in one 32-bit mask word a lane up to
        # nf 32, two up to 64, else a byte plane [nf][BLOCK] in shared
        # memory if it fits beside the ring and the choice words
        ring = cuda.live_ring_bytes(g.chunk)
        assert ring % 16 == 0 and g.r == 1
        assert g.mask_words == (1 if nf <= 32 else 2 if nf <= 64 else 0)
        words = cw * cuda.BLOCK * 4
        assert g.choices_shared == (ring + words <= SMEM_BLOCK_MAX)
        used = ring + (words if g.choices_shared else 0)
        plane = nf * cuda.BLOCK
        if g.mask_words:
            assert g.regs_shared and g.smem == used
        else:
            assert g.regs_shared == (used + plane <= SMEM_BLOCK_MAX)
            assert g.smem == used + (plane if g.regs_shared else 0)
        return
    ring = cuda.tape_ring_bytes(g.chunk)
    assert ring % 16 == 0 and g.mask_words == 0
    if kernel in ("interp_float", "interp_float_coded"):
        if kernel == "interp_float_coded":
            # K6 compacts into the ring's own buffers: K3's geometry
            assert g == cuda.launch_geometry(
                "interp_float", nf=nf, lanes=lanes, T=T, cw=cw)
        file_bytes = nf * cuda.BLOCK * g.r * 4
        fits_at_all = ring + nf * cuda.BLOCK * 4 <= SMEM_BLOCK_MAX
        # the global route exactly when not even one lane a thread fits
        assert g.regs_shared == fits_at_all
        assert g.smem == ring + (file_bytes if g.regs_shared else 0)
        assert not g.choices_shared
        if g.regs_shared and g.r < 4 and lanes % (cuda.BLOCK * 2 * g.r) == 0:
            # more lanes a thread were possible: they must not have fit
            # the budget the grid allows (two blocks an SM, or one when
            # the grid has no more blocks than the card has SMs)
            wider = ring + nf * cuda.BLOCK * 2 * g.r * 4
            blocks = T * lanes // (cuda.BLOCK * 2 * g.r)
            budget = SMEM_BLOCK_MAX if blocks <= cuda.N_SM else (
                cuda.SMEM_SM // 2 - cuda.SMEM_BLOCK_RESERVED)
            assert wider > budget
    else:
        assert g.r == 1
        regs, words = nf * cuda.BLOCK * 8, cw * cuda.BLOCK * 4
        assert g.regs_shared == (ring + regs <= SMEM_BLOCK_MAX)
        used = ring + (regs if g.regs_shared else 0)
        assert g.choices_shared == (used + words <= SMEM_BLOCK_MAX)
        assert g.smem == used + (words if g.choices_shared else 0)


def test_main_path_geometry():
    """What the 2D main path gets: four lanes a thread and 26 KB of
    register file for K3 at the tape's 13 registers (two at the bucket's
    64), and K1's register file and choice words both in shared memory."""
    leaf = cuda.launch_geometry("interp_float", nf=13, lanes=16384, T=64)
    assert (leaf.r, leaf.regs_shared) == (4, True)
    assert leaf.smem - cuda.tape_ring_bytes(leaf.chunk) == 13 * 512 * 4
    assert cuda.launch_geometry(
        "interp_float", nf=64, lanes=16384, T=64).r == 2
    root = cuda.launch_geometry(
        "interp_interval", nf=13, lanes=1024, T=1, cw=128)
    assert root.regs_shared and root.choices_shared
    assert root.smem == cuda.tape_ring_bytes(root.chunk) + 13 * 1024 + 65536


def test_main_path_geometry_k2_k6():
    """What the main paths give K2 and K6: the bucketed root (nf 64, 128
    choice words) two mask words a lane and 64 KB of choice words in
    shared memory; the per-shape root and second level (nf 13) one mask
    word; the 3D passes (nf 64, 1 word) two; the coded leaf at the
    tape's 13 registers K3's four lanes a thread and 39,984 bytes, two
    blocks an SM and more."""
    root = cuda.launch_geometry("liveness_codes", nf=64, lanes=1024, T=1,
                                cw=128)
    assert (root.mask_words, root.choices_shared, root.r) == (2, True, 1)
    assert root.smem == cuda.live_ring_bytes(root.chunk) + 128 * 512
    for nf, lanes, T, cw, words in ((13, 1024, 1, 67, 1), (13, 128, 64, 67, 1),
                                    (64, 128, 32, 1, 2)):
        g = cuda.launch_geometry("liveness_codes", nf=nf, lanes=lanes, T=T,
                                 cw=cw)
        assert (g.mask_words, g.choices_shared) == (words, True)
    leaf = cuda.launch_geometry("interp_float_coded", nf=13, lanes=16384, T=64)
    assert (leaf.r, leaf.regs_shared, leaf.smem) == (4, True, 39984)
    assert 2 * (leaf.smem + cuda.SMEM_BLOCK_RESERVED) <= cuda.SMEM_SM
    # the bucket's 64 registers would have halved the lanes a thread
    assert cuda.launch_geometry(
        "interp_float_coded", nf=64, lanes=16384, T=64).r == 2


#: (label, nf, lanes, T, sub) of K4 and K5: the 3D path's launches at
#: the tape's 6 registers and the bucket's 64, K5 at sub 32, 48 and 64,
#: few instances, and register files too large for shared memory
GEOMETRY_3D_CASES = [
    ("normals-regs", 6, 8192, 32, 0),
    ("normals-bucket", 64, 8192, 32, 0),
    ("voxels-regs", 6, 4096, 1024, 16),
    ("voxels-bucket", 64, 4096, 1024, 16),
    ("voxels-sub32", 6, 32768, 4, 32),
    ("voxels-sub48", 6, 48**3, 4, 48),
    ("voxels-sub64", 6, 64**3, 2, 64),
    ("few", 13, 4096, 3, 16),
    ("nf256", 256, 4096, 10, 16),
    ("nf512", 512, 4096, 10, 16),
    ("nf512-sub32", 512, 32768, 2, 32),
]


@pytest.mark.parametrize("kernel", ["interp_grad", "interp_voxel_depth"])
@pytest.mark.parametrize("case", GEOMETRY_3D_CASES, ids=lambda c: c[0])
def test_launch_geometry_3d(kernel, case):
    """K4 takes GRAD_LANES and four register files; K5 VOXEL_LANES, the
    fewest columns a block that take it VOXEL_PASSES passes of whole
    slices, and a fold of BLOCK * r ints where a pass spans several
    slices; both keep the global scratch for files that not even one
    lane a thread fits, and the budget of two blocks an SM where the
    grid has more blocks than SMs."""
    _, nf, lanes, T, sub = case
    if kernel == "interp_grad":
        g = cuda.launch_geometry(kernel, nf=nf, lanes=lanes, T=T)
        rs = [r for r in cuda.GRAD_LANES if lanes % (cuda.BLOCK * r) == 0]
        planes = 4
        fold = lambda r: 0
        blocks = lambda r: T * lanes // (cuda.BLOCK * r)
    else:
        if not sub:
            return
        g = cuda.launch_geometry(kernel, nf=nf, lanes=lanes, T=T, sub=sub)
        cols = sub * sub
        rs = [r for r in cuda.VOXEL_LANES if cuda._voxel_cols(sub, r)]
        planes = 1
        cb = cuda._voxel_cols
        fold = lambda r: 4 * cuda.BLOCK * r if cuda.BLOCK * r > cb(sub, r) else 0
        blocks = lambda r: T * cols // cb(sub, r)
        # a block's columns: whole slices of a pass that divides sub, at
        # least VOXEL_PASSES passes, and no fewer columns would do
        P = cuda.BLOCK * g.r
        assert g.cols == cb(sub, g.r)
        assert cols % g.cols == 0 and P % g.cols == 0 and g.cols % g.r == 0
        assert sub % (P // g.cols) == 0
        passes = sub * g.cols // P
        assert passes >= cuda.VOXEL_PASSES
        assert not [c for c in range(g.r, g.cols, g.r)
                    if cols % c == 0 and P % c == 0 and sub % (P // c) == 0
                    and sub * c // P >= cuda.VOXEL_PASSES]
    ring = cuda.tape_ring_bytes(g.chunk)
    assert g.r in rs and g.chunk == cuda.TAPE_CHUNK
    assert g.blocks == blocks(g.r) and g.smem <= SMEM_BLOCK_MAX
    file_bytes = lambda r: planes * nf * cuda.BLOCK * r * 4
    fits_at_all = ring + file_bytes(min(rs)) + fold(min(rs)) <= SMEM_BLOCK_MAX
    assert g.regs_shared == fits_at_all
    assert g.smem == ring + fold(g.r) + (file_bytes(g.r) if g.regs_shared else 0)
    assert not g.choices_shared and g.mask_words == 0
    assert (g.cols > 0) == (kernel == "interp_voxel_depth")
    if g.regs_shared:
        for r in rs[:rs.index(g.r)]:  # every wider choice must not fit
            budget = SMEM_BLOCK_MAX if blocks(r) <= cuda.N_SM else (
                cuda.SMEM_SM // 2 - cuda.SMEM_BLOCK_RESERVED)
            assert ring + file_bytes(r) + fold(r) > budget
    else:
        assert g.r == rs[0]


def test_main_path_geometry_k4_k5():
    """What the 3D path gives K4 and K5 at the gyroid's 6 registers: K4
    two lanes a thread with its four files in shared memory (at the
    bucket's 64 one lane, 128 KB of files), K5 four lanes a thread, four
    blocks a subtile of 64 columns, eight slices a pass and two passes,
    eight blocks an SM."""
    k4 = cuda.launch_geometry("interp_grad", nf=6, lanes=8192, T=32)
    assert (k4.r, k4.regs_shared, k4.blocks) == (2, True, 1024)
    assert k4.smem == cuda.tape_ring_bytes(k4.chunk) + 4 * 6 * 256 * 4
    wide = cuda.launch_geometry("interp_grad", nf=64, lanes=8192, T=32)
    assert (wide.r, wide.regs_shared) == (1, True)
    k5 = cuda.launch_geometry("interp_voxel_depth", nf=6, lanes=4096, T=1024,
                              sub=16)
    assert (k5.r, k5.regs_shared, k5.blocks, k5.cols) == (4, True, 4096, 64)
    assert k5.smem == cuda.tape_ring_bytes(k5.chunk) + 6 * 512 * 4 + 512 * 4
    assert 8 * (k5.smem + cuda.SMEM_BLOCK_RESERVED) <= cuda.SMEM_SM


#: (tangents, smem, blocks an SM) of K4 at the fitting step's shape:
#: the stand-in's 14 registers over 2048^2 lanes, one instance
FIT_K4 = [(1, 42032, 5), (2, 56368, 4), (3, 70704, 3)]


@pytest.mark.parametrize("tangents,smem,per_sm", FIT_K4)
def test_fit_jacobian_geometry(tangents, smem, per_sm):
    """K4's register files follow its planes, 1 + tangents: the fit's
    pass in the two shape parameters (2 tangents) takes 56,368 B a block
    where four planes take 70,704 B, so four blocks share an SM, not
    three; two lanes a thread and the grid stay."""
    g = cuda.launch_geometry("interp_grad", nf=14, lanes=2048 * 2048, T=1,
                             tangents=tangents)
    assert (g.r, g.regs_shared, g.blocks) == (2, True, 16384)
    assert g.smem == smem == (cuda.tape_ring_bytes(g.chunk)
                              + (1 + tangents) * 14 * 256 * 4)
    assert cuda.SMEM_SM // (g.smem + cuda.SMEM_BLOCK_RESERVED) == per_sm
    if tangents == 3:
        assert g == cuda.launch_geometry("interp_grad", nf=14,
                                         lanes=2048 * 2048, T=1)


def test_launch_geometry_rejects_bad_subtiles():
    with pytest.raises(ValueError, match="sub"):
        cuda.launch_geometry("interp_voxel_depth", nf=6, lanes=512, T=1,
                             sub=8)
    with pytest.raises(ValueError, match="sub"):
        cuda.launch_geometry("interp_voxel_depth", nf=6, lanes=4096, T=1)


def test_live_ring_bytes_matches_the_layout():
    """Two buffers of `chunk` decoded 32-byte rows and two raw words a
    row (csrc/liveness.cu `LiveRing`)."""
    for chunk in (16, 256, 1024):
        assert cuda.live_ring_bytes(chunk) == chunk * (2 * 32 + 2 * 4)


@pytest.mark.parametrize("lanes", [0, 100, -128])
def test_launch_geometry_rejects_ragged_lanes(lanes):
    with pytest.raises(ValueError):
        cuda.launch_geometry("interp_float", nf=8, lanes=lanes, T=1)


def test_launch_geometry_rejects_other_kernels():
    with pytest.raises(ValueError):
        cuda.launch_geometry("interp_nothing", nf=8, lanes=128, T=1)


def test_tape_ring_bytes_matches_the_layout():
    """Two buffers of chunk + 1 rows (16 bytes and a 4-byte immediate
    each) and three raw words a row, rounded up to 16 bytes."""
    for chunk in (1, 7, 128, 256, 1000):
        want = 2 * (chunk + 1) * (16 + 4) + 3 * 4 * chunk
        got = cuda.tape_ring_bytes(chunk)
        assert got % 16 == 0 and want <= got < want + 16


# ----------------------------------------------------------------------
# the adversarial tapes: plain versions against the reference

S0 = 8
ARENA = adversarial_arena(cuda.TAPE_CHUNK)
NAMES = ARENA["names"]


def _written(name):
    """The outputs a tape writes. The port defines the others as 0; the
    reference leaves them as its output block came (NaN in interpret
    mode), so only written outputs are held to it."""
    if name == "len0":
        return []
    return [0, 1] if name in ("apart", "clamp") else [0]


def test_adversarial_arena_covers_what_it_claims():
    chunk = cuda.TAPE_CHUNK
    L = ARENA["w1"].shape[1]
    assert L == 3 * chunk + 5
    lens = dict(zip(NAMES, ARENA["lengths"].tolist()))
    assert [lens[k] for k in ("len0", "len1")] == [0, 1]
    assert {lens[f"chain{n}"] for n in (chunk - 1, chunk, chunk + 1, L)} == {
        chunk - 1, chunk, chunk + 1, L}
    assert lens["over"] > L
    op = ARENA["w1"] & 127
    out = (ARENA["w1"] >> 7) & 0xFFF
    a = (ARENA["w1"] >> 19) & 0xFFF
    b = ARENA["w2"] & 0xFFF
    t = NAMES.index(f"chain{L}")
    n = lens[f"chain{L}"]
    # every chain row after the two inputs reads the row before it, but
    # for the restarts from immediate + immediate
    reads_prev = (a[t, 3:n] == out[t, 2:n - 1]) | (b[t, 3:n] == out[t, 2:n - 1])
    both_imm = (a[t, 3:n] == 0xFFF) & (b[t, 3:n] == 0xFFF)
    assert (reads_prev | both_imm).all() and both_imm.sum() > 10
    t = NAMES.index("apart")
    n = lens["apart"]
    apart = (a[t, 6:n - 2] != out[t, 5:n - 3]) & (b[t, 6:n - 2] != out[t, 5:n - 3])
    assert apart.all()
    assert (op[t, :n] == 0).sum() == 2  # two OUTPUT rows
    assert ARENA["n_choices"] > 16 * 2  # folds into the last of 2 words
    assert out[NAMES.index("clamp")].max() >= ARENA["nf"]


def _planes():
    rng = np.random.default_rng(5)
    T = len(NAMES)
    lo = rng.uniform(-1.5, 1.5, size=(T, 2, S0, 128)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.5, size=lo.shape).astype(np.float32)
    return lo, hi


@pytest.fixture(scope="module")
def evaluated():
    """The arena through the port's wrappers (plain versions on the CPU)
    and through the reference's kernels in interpret mode."""
    lo, hi = _planes()
    A = ARENA
    arena = [torch.from_numpy(A[k]) for k in ("w1", "w2", "imm", "lengths")]
    kw = dict(nf=A["nf"], n_inputs=2, n_outputs=2, s0=S0)
    ref_arena = (A["w1"], A["w2"], A["imm"], A["lengths"])
    out = {
        "float": (
            interp_float(*arena, torch.from_numpy(lo), **kw).numpy(),
            np.asarray(ref_interp.interp_float(
                *ref_arena, lo, interpret=True, **kw)),
        ),
    }
    for cw in (2, 32):
        got = interp_interval(
            *arena, torch.from_numpy(lo), torch.from_numpy(hi), c_words=cw, **kw
        )
        want = ref_interp.interp_interval(
            *ref_arena, lo, hi, c_words=cw, interpret=True, **kw
        )
        out[f"interval-cw{cw}"] = (
            [g.numpy() for g in got], [np.asarray(w) for w in want]
        )
    return out


@pytest.mark.parametrize("name", NAMES)
def test_adversarial_float_matches_reference(evaluated, name):
    t = NAMES.index(name)
    got, want = evaluated["float"]
    for o in range(2):
        if o in _written(name):
            np.testing.assert_allclose(
                got[t, o], want[t, o], rtol=1e-6, atol=1e-7
            )
            assert np.isfinite(got[t, o]).all() and (got[t, o] != 0).any()
        else:
            assert (got[t, o] == 0).all()
    if name == "len1":
        assert (got[t, 0] == 1.5).all()


@pytest.mark.parametrize("cw", [2, 32])
@pytest.mark.parametrize("name", NAMES)
def test_adversarial_interval_matches_reference(evaluated, name, cw):
    t = NAMES.index(name)
    got, want = evaluated[f"interval-cw{cw}"]
    for g, w in zip(got[:2], want[:2]):
        for o in range(2):
            if o in _written(name):
                np.testing.assert_allclose(
                    g[t, o], w[t, o], rtol=1e-6, atol=1e-7
                )
            else:
                assert (g[t, o] == 0).all()
    np.testing.assert_array_equal(got[2][t], want[2][t])
    if name.startswith("chain") or name in ("over", "apart"):
        assert (got[2][t] != 0).any()
        assert (got[0][t, 0] <= got[1][t, 0]).all()
    if name in ("len0", "len1", "clamp"):
        assert (got[2][t] == 0).all()


def test_adversarial_choices_fold_into_the_last_word(evaluated):
    """With 2 words, choices 32.. of the long chains OR into word 1;
    with 32 words they spread out, and word 1 of the folded result is
    the OR of words 1.. of the spread one."""
    folded = evaluated["interval-cw2"][0][2]
    spread = evaluated["interval-cw32"][0][2]
    np.testing.assert_array_equal(folded[:, 0], spread[:, 0])
    np.testing.assert_array_equal(
        folded[:, 1], np.bitwise_or.reduce(spread[:, 1:], axis=1)
    )
    assert (spread[:, 2:] != 0).any()


# ----------------------------------------------------------------------
# the liveness pass (K2) and the coded leaf (K6) on the adversarial tapes

LIVE_ARENA = adversarial_arena(cuda.TAPE_CHUNK, liveness=True)
LIVE_NAMES = LIVE_ARENA["names"]

#: (nf, cw): one and two mask words, the byte plane in shared memory and
#: (nf 2048) in device memory, choice words folded into 2 and too many
#: (512) for shared memory
LIVE_CASES = [(6, 2), (13, 2), (64, 2), (512, 2), (512, 512), (2048, 2)]


def _ref_liveness(w1, w2, lengths, ch, nf, shared):
    """The reference's `_liveness_codes` in interpret mode. It walks a
    length past L from rows past the tape's end (interpret mode clamps
    the index); the port walks min(length, L) rows, as its interpreter
    kernels do, so the reference is given that."""
    Tt, L = w1.shape
    return np.asarray(_liveness_codes(
        w1.reshape(Tt, 1, L), w2.reshape(Tt, 1, L),
        np.minimum(lengths, L).reshape(Tt, 1, 1), ch, nf=nf, L=L,
        shared_tape=shared, interpret=True,
    ))


@pytest.fixture(scope="module")
def live_codes():
    """Every adversarial tape through K2's plain version and the
    reference, per instance, with seeded choice words (all four codes)
    at each of LIVE_CASES; and the longest chain as the shared tape of
    three instances."""
    A = LIVE_ARENA
    T, L = A["w1"].shape
    rng = np.random.default_rng(9)
    out = {}
    tape = [torch.from_numpy(A[k]) for k in ("w1", "w2", "lengths")]
    for nf, cw in LIVE_CASES:
        ch = rng.integers(-2**31, 2**31, size=(T, cw, 1, 128)).astype(np.int32)
        got = liveness_codes(*tape, torch.from_numpy(ch), nf=nf, L=L,
                             shared_tape=False).numpy()
        out[nf, cw] = got, _ref_liveness(A["w1"], A["w2"], A["lengths"], ch,
                                         nf, False)
    t = LIVE_NAMES.index(f"chain{L}")
    ch = rng.integers(-2**31, 2**31, size=(3, 2, 1, 128)).astype(np.int32)
    one = [a[t:t + 1] for a in tape]
    got = liveness_codes(*one, torch.from_numpy(ch), nf=6, L=L,
                         shared_tape=True).numpy()
    out["shared"] = got, _ref_liveness(
        A["w1"][t:t + 1], A["w2"][t:t + 1], A["lengths"][t:t + 1], ch, 6, True)
    return out


@pytest.mark.parametrize("case", LIVE_CASES, ids=lambda c: f"nf{c[0]}-cw{c[1]}")
@pytest.mark.parametrize("name", LIVE_NAMES)
def test_adversarial_liveness_matches_reference(live_codes, name, case):
    t = LIVE_NAMES.index(name)
    got, want = live_codes[case]
    np.testing.assert_array_equal(got[t], want[t])
    L = LIVE_ARENA["w1"].shape[1]
    n = min(int(LIVE_ARENA["lengths"][t]), L)
    # words past the tape's end stay 0; a tape's last row emits
    assert (got[t, -(-n // 16):] == 0).all()
    if n:
        assert (got[t, (n - 1) // 16] >> (2 * ((n - 1) % 16)) & 3).any()


def test_adversarial_liveness_shared_tape_matches_reference(live_codes):
    got, want = live_codes["shared"]
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[0], got[1])


def test_adversarial_liveness_tapes_cover_what_they_claim(live_codes):
    """`unknown` holds opcodes 31, 40 and 127 whose b (register 1) no
    other row reads: such an op takes no b, so INPUT y is dropped on
    every lane, and op 127 (a counts as a register) always runs. In
    `rawclamp` the elision compares the raw fields: the MIN whose raw a
    (9) differs from out (5) but clamps to the same register becomes a
    COPY from a on some lanes (a clamped comparison would elide it),
    the MIN with raw b (5) against out (9) a COPY from b, while the MAX
    whose raw a equals out and the MAX whose raw b equals out never
    become the COPY they would elide."""
    A = LIVE_ARENA
    got, _ = live_codes[6, 2]
    shifts = (2 * np.arange(16))[:, None, None]
    t = LIVE_NAMES.index("unknown")
    op = A["w1"][t, :A["lengths"][t]] & 127
    assert op.tolist() == [1, 1, 31, 40, 6, 127, 0]
    codes = (got[t, 0] >> shifts) & 3
    assert (codes[1] == 0).all() and (codes[5] == 1).all()
    assert (codes[6] == 1).all() and (codes[0] == 0).any()
    t = LIVE_NAMES.index("rawclamp")
    codes = (got[t, 0] >> shifts) & 3
    assert (codes[2] == 2).any() and (codes[4] == 3).any()
    assert not (codes[3] == 2).any() and not (codes[5] == 3).any()
    assert (codes[3] == 1).any() and (codes[5] == 2).any()


# seeded codes of the coded leaf over one adversarial tape: tile 0 runs
# every row; 1-5 carry seeded codes 0-3 on every row kind (COPY from b on
# unary rows too, where b is an immediate or a register); 6 repeats 1
# under a length past L; 7 is culled; 8 repeats 0 with its last 3 rows
# cut off, so that a word's codes past the length must be masked
K6_TILES = 9


def _k6_case(name, rng):
    A = ADV_K6
    t = NAMES.index(name)
    L = A["w1"].shape[1]
    n = min(int(A["lengths"][t]), L)
    codes = np.zeros((K6_TILES, L), np.uint32)
    codes[0, :n] = 1
    for k in range(1, 6):
        codes[k] = seeded_action_codes(A["w1"][t], A["w2"][t], n, A["nf"], rng,
                                       any_row=True)
    codes[6] = codes[1]
    codes[8] = codes[0]
    lengths = np.array([n] * 6 + [L + 7, 0, max(n - 3, 0)], np.int32)
    vars_ = rng.uniform(-1.5, 1.5, size=(K6_TILES, 2, 1, 128)).astype(np.float32)
    vars_[6] = vars_[1]
    shared = [np.ascontiguousarray(A[k][t:t + 1]) for k in ("w1", "w2", "imm")]
    return shared, lengths, codes, vars_


def _k6_written(shared, lengths, codes, O):
    """[tiles, O]: whether an executed OUTPUT row (code 1) writes each
    output within each tile's length."""
    w1, w2 = shared[0][0], shared[1][0]
    L = w1.shape[0]
    rows = np.arange(L)
    written = np.zeros((len(lengths), O), bool)
    for k, n in enumerate(lengths):
        run = (codes[k] == 1) & (rows < min(n, L)) & ((w1 & 127) == 0)
        for j in np.nonzero(run)[0]:
            written[k, min(int(w2[j]) >> 12, O - 1)] = True
    return written


ADV_K6 = ARENA


@pytest.mark.parametrize("name", NAMES)
def test_adversarial_coded_matches_reference(name):
    """K6's plain version against the reference's `interp_float_coded`
    on each adversarial tape as the shared tape of K6_TILES tiles, bit
    for bit where an OUTPUT row ran; outputs the tile never wrote are 0
    in the port (the reference leaves them as its block came)."""
    rng = np.random.default_rng(13 + NAMES.index(name))
    shared, lengths, codes, vars_ = _k6_case(name, rng)
    words = pack_action_codes(codes)
    kw = dict(nf=ARENA["nf"], n_inputs=2, n_outputs=2, s0=1)
    want = np.asarray(ref_interp.interp_float_coded(
        *shared, lengths, words, vars_, interpret=True, **kw))
    got = interp_float_coded(
        *(torch.from_numpy(a) for a in (*shared, lengths, words, vars_)), **kw
    ).numpy()
    written = _k6_written(shared, lengths, codes, 2)
    for k in range(K6_TILES):
        for o in range(2):
            if written[k, o]:
                np.testing.assert_array_equal(got[k, o].view(np.uint32),
                                              want[k, o].view(np.uint32))
            else:
                assert (got[k, o] == 0).all()
    assert not written[7].any()
    np.testing.assert_array_equal(got[6], got[1])


def test_adversarial_coded_codes_cover_every_row_kind():
    """Over the arena, the seeded codes hold COPY from a and from b on
    binary and on unary rows, from a register and from an immediate."""
    seen = set()
    for name in NAMES:
        rng = np.random.default_rng(13 + NAMES.index(name))
        shared, lengths, codes, _ = _k6_case(name, rng)
        w1, w2 = shared[0][0], shared[1][0]
        op = w1 & 127
        unary = np.isin(op, [2, 7, 12])  # COPY, NEG, ABS: no b to read
        src_imm = {2: ((w1 >> 19) & 0xFFF) == 0xFFF, 3: (w2 & 0xFFF) == 0xFFF}
        for c in (2, 3):
            hit = (codes[1:6] == c).any(axis=0)
            seen |= {(c, "unary" if u else "binary", "imm" if i else "reg")
                     for u, i in zip(unary[hit], src_imm[c][hit])}
    assert {(3, "unary", "imm"), (3, "unary", "reg"), (3, "binary", "imm"),
            (3, "binary", "reg"), (2, "unary", "reg"),
            (2, "binary", "reg")} <= seen


# ----------------------------------------------------------------------
# K4 and K5 on the adversarial tapes

VOX_SUBS = (16, 32)


def _voxel_planes(sub, rng):
    """[T, 2, sub^3 / 128, 128]: seeded inputs with a ramp over vz, so
    that the chains' distances change sign within a column."""
    T = len(NAMES)
    vz = np.arange(sub**3) // (sub * sub)
    x = rng.uniform(-1.5, 1.5, size=(T, 2, sub**3)) + (vz / sub * 3 - 1.5)
    return x.astype(np.float32).reshape(T, 2, sub**3 // 128, 128)


@pytest.fixture(scope="module")
def evaluated_3d():
    """The arena through the port's K4 and K5 (plain versions on the
    CPU) and the reference's in interpret mode; K5 at sub 16 and 32."""
    A = ARENA
    arena = [torch.from_numpy(A[k]) for k in ("w1", "w2", "imm", "lengths")]
    ref_arena = (A["w1"], A["w2"], A["imm"], A["lengths"])
    rng = np.random.default_rng(21)
    duals = rng.uniform(-1.5, 1.5, size=(len(NAMES), 2, 4, S0, 128))
    duals = duals.astype(np.float32)
    kw = dict(nf=A["nf"], n_inputs=2, n_outputs=2, s0=S0)
    out = {"grad": (
        interp_grad(*arena, torch.from_numpy(duals), **kw).numpy(),
        np.asarray(ref_interp.interp_grad(*ref_arena, duals, interpret=True,
                                          **kw)),
    )}
    for sub in VOX_SUBS:
        planes = _voxel_planes(sub, rng)
        kw = dict(nf=A["nf"], n_inputs=2, s0=sub**3 // 128, sub=sub)
        out[sub] = (
            interp_voxel_depth(*arena, torch.from_numpy(planes), **kw).numpy(),
            np.asarray(ref_interp.interp_voxel_depth(
                *ref_arena, planes, interpret=True, **kw)),
        )
    return out


@pytest.mark.parametrize("name", NAMES)
def test_adversarial_grad_matches_reference(evaluated_3d, name):
    t = NAMES.index(name)
    got, want = evaluated_3d["grad"]
    for o in range(2):
        if o in _written(name):
            np.testing.assert_allclose(got[t, o, 0], want[t, o, 0],
                                       rtol=2e-5, atol=2e-5)
            np.testing.assert_allclose(got[t, o, 1:], want[t, o, 1:],
                                       rtol=1e-4, atol=1e-4)
            assert np.isfinite(got[t, o]).all()
            assert name == "len1" or (got[t, o, 1:] != 0).any()
        else:
            assert (got[t, o] == 0).all()
    if name == "len1":  # an immediate is (imm, 0, 0, 0)
        assert (got[t, 0, 0] == 1.5).all() and (got[t, 0, 1:] == 0).all()


@pytest.mark.parametrize("sub", VOX_SUBS)
@pytest.mark.parametrize("name", NAMES)
def test_adversarial_voxel_depth_matches_reference(evaluated_3d, name, sub):
    """Depth exact on every tape: the chains across chunk boundaries and
    cut mid-chunk, past L, two OUTPUT rows (the last one counts) and a
    register past nf; a tape without rows is empty."""
    t = NAMES.index(name)
    got, want = evaluated_3d[sub]
    np.testing.assert_array_equal(got[t], want[t])
    pp = sub * sub // 128
    assert (got[t, pp:] == 0).all()
    if name == "len0":
        assert (got[t] == 0).all()
    elif name in ("chain255", "chain773", "over", "clamp"):
        # the ramp over vz moves these tapes' surface inside the columns
        # (others end on a value of one sign, as chain256 on an ABS)
        assert len(np.unique(got[t, :pp])) > 2
