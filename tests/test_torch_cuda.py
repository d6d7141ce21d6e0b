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
from fidget_tpu_torch.compiler.pack import pack_tapes
from fidget_tpu_torch.eval import cuda
from fidget_tpu_torch.eval.interp import (
    interp_float,
    interp_float_plain,
    interp_interval,
    interp_interval_plain,
)
from fidget_tpu_torch.eval.simplify_device import (
    liveness_codes,
    liveness_codes_plain,
)
from fidget_tpu_torch.render.render2d import FILL_NONE

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
@pytest.mark.parametrize("nf_pad", [0, 256])
def test_kernels_match_plain(card, nf_pad):
    """nf_pad = 256 oversizes the register file past the shared-memory
    budget, so the kernels take their global-memory scratch path."""
    tapes = _tapes()
    packed = pack_tapes(tapes, capacity=512)
    nf = max(packed.nf, nf_pad)
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


@pytest.mark.cuda
def test_render_on_card_matches_brute(card):
    tape = _union_tape(40)
    r = port.PixelRenderer(tape, port.ImageSize(256, 256), tile_size=32)
    assert r.device.type == "cuda"
    cuda.reset_launches()
    img = r.render()
    torch.cuda.synchronize()
    assert cuda.LAUNCHES == {k: 1 for k in cuda.KERNELS}
    brute = r.render_brute()
    dist, fill = img.distance.cpu().numpy(), img.fill.cpu().numpy()
    ev = fill == FILL_NONE
    np.testing.assert_allclose(dist[ev], brute[ev], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(img.inside().cpu().numpy(), brute < 0)
    assert (~ev).any()
