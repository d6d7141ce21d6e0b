"""The launch geometry of the redesigned K1 / K3 kernels, and the
hand-packed tapes that `chip_smoke.py` and the card tests run through
them, on the CPU.

`launch_geometry` (fidget_tpu_torch/eval/cuda.py) is plain Python: it
decides lanes per thread, shared-memory bytes, the tape chunk and the
register-file route of a launch, so every branch of it is covered here
without a card. The adversarial tapes (`scenes.adversarial_arena`) are
built to break the kernels' tape staging; on the card the kernels are
held to the plain PyTorch versions on them, so here the plain versions
are held to the reference's `interp_float` / `interp_interval` in
interpret mode on the same arena and the same seeded numpy inputs
(values equal at rtol 1e-6, atol 1e-7, the tolerance of
tests/test_torch_kernels.py; every op of these tapes rounds correctly
in f32; choice words exact).
"""

import numpy as np
import pytest
import torch

from fidget_tpu.eval import pallas_interp as ref_interp

from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval.interp import interp_float, interp_interval
from fidget_tpu_torch.scenes import adversarial_arena

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


@pytest.mark.parametrize("kernel", ["interp_float", "interp_interval"])
@pytest.mark.parametrize("case", GEOMETRY_CASES, ids=lambda c: c[0])
def test_launch_geometry(kernel, case):
    _, nf, lanes, T, cw = case
    g = cuda.launch_geometry(kernel, nf=nf, lanes=lanes, T=T, cw=cw)
    ring = cuda.tape_ring_bytes(g.chunk)
    assert g.chunk > 0 and ring % 16 == 0
    assert g.smem <= SMEM_BLOCK_MAX
    assert g.r in (1, 2, 4) and lanes % (cuda.BLOCK * g.r) == 0
    assert g.blocks == T * lanes // (cuda.BLOCK * g.r)
    if kernel == "interp_float":
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


@pytest.mark.parametrize("lanes", [0, 100, -128])
def test_launch_geometry_rejects_ragged_lanes(lanes):
    with pytest.raises(ValueError):
        cuda.launch_geometry("interp_float", nf=8, lanes=lanes, T=1)


def test_launch_geometry_rejects_other_kernels():
    with pytest.raises(ValueError):
        cuda.launch_geometry("liveness_codes", nf=8, lanes=128, T=1)


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
