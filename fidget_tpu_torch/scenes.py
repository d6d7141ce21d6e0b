"""Seeded procedural scenes that the port's checks render.

`standin_shape` stands in for prospero in 2D, `gyroid_sphere` is the
3D gyroid sphere of the reference's own tests, and `sphere_union_shape`
is a tape-heavy 3D union. Every builder uses only the graph API that
this package and the reference package share, so a test can build the
same scene in both and compare the tapes they lower to.
`seeded_action_codes` makes per-tile action codes for the coded leaf
kernel without an interval pass.
"""

from __future__ import annotations

import numpy as np


def _min_tree(ctx, parts):
    """Reduces `parts` by a balanced tree of `min`s."""
    while len(parts) > 1:
        nxt = [ctx.min(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


def standin_shape(ctx, n=800, seed=0):
    """Seeded 2D stand-in of prospero's size: n circles (radii
    0.01-0.06, centres in [-1, 1]), every third clipped to a horizontal
    band by a `max`, reduced by a balanced tree of `min`s. Lowered:
    7,203 ops, 13 registers, 1,066 choices."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, size=(n, 2))
    r = rng.uniform(0.01, 0.06, size=n)
    x, y = ctx.x(), ctx.y()
    parts = []
    for i in range(n):
        dx = ctx.sub(x, float(c[i, 0]))
        dy = ctx.sub(y, float(c[i, 1]))
        d = ctx.sub(
            ctx.sqrt(ctx.add(ctx.square(dx), ctx.square(dy))), float(r[i])
        )
        if i % 3 == 0:
            d = ctx.max(d, ctx.sub(ctx.abs(dy), float(r[i]) * 0.5))
        parts.append(d)
    return _min_tree(ctx, parts)


def gyroid_sphere(pkg, scale=4.0):
    """The gyroid sphere of tests/test_render3d.py as a `pkg.Shape`: a
    gyroid sheet of half-thickness 0.2 clipped to a sphere; 28 ops, 6
    registers, 1 choice. `pkg` is the package whose `Tree` and `Shape`
    build it."""
    x, y, z = pkg.Tree.axes()
    xs, ys, zs = x * scale, y * scale, z * scale
    g = xs.sin() * ys.cos() + ys.sin() * zs.cos() + zs.sin() * xs.cos()
    sphere = (xs.square() + ys.square() + zs.square()).sqrt() - scale * 0.8
    return pkg.Shape.from_tree(sphere.max(abs(g) - 0.2))


def sphere_union_shape(ctx, n=300, seed=1):
    """Seeded union of n spheres (centres in [-0.9, 0.9]^3, then radii
    0.02-0.12 from the same generator), reduced by a balanced tree of
    `min`s. Lowered at n = 300: 3,303 ops, 13 registers, 299 choices.
    Its ops (sub, square, add, sqrt, min) are all correctly rounded in
    f32, so a card and numpy agree on it bit for bit."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.9, 0.9, size=(n, 3))
    r = rng.uniform(0.02, 0.12, size=n)
    x, y, z = ctx.x(), ctx.y(), ctx.z()
    parts = []
    for i in range(n):
        d2 = ctx.add(
            ctx.square(ctx.sub(x, float(c[i, 0]))),
            ctx.add(ctx.square(ctx.sub(y, float(c[i, 1]))),
                    ctx.square(ctx.sub(z, float(c[i, 2])))),
        )
        parts.append(ctx.sub(ctx.sqrt(d2), float(r[i])))
    return _min_tree(ctx, parts)


def seeded_action_codes(w1, w2, n, nf, rng):
    """Seeded 2-bit action codes [L] for the first n rows of one packed
    tape (canonical op order) that mix all four values and keep the
    dataflow valid, so that no executed row reads a register a skipped
    row should have written: a reverse liveness walk that picks keep /
    COPY-from-a / COPY-from-b at random for every executed row,
    whatever its op, and skips the rows that leaves dead."""
    from .compiler.pack import IMM12
    from .compiler.tape import BINARY_MASK, TapeOp

    codes = np.zeros(len(w1), np.uint32)
    live = np.zeros(nf, bool)
    for j in reversed(range(n)):
        op = int(w1[j]) & 127
        out = (int(w1[j]) >> 7) & 0xFFF
        a = (int(w1[j]) >> 19) & 0xFFF
        b = int(w2[j]) & 0xFFF
        if op != int(TapeOp.OUTPUT) and not live[out]:
            continue
        binary = (BINARY_MASK >> op) & 1 == 1
        if op in (int(TapeOp.OUTPUT), int(TapeOp.INPUT)):
            c = 1
        else:
            c = int(rng.choice([1, 2, 3] if binary else [1, 2]))
        codes[j] = c
        live[out] = False
        if op != int(TapeOp.INPUT):
            if c in (1, 2) and a != IMM12:
                live[a] = True
            if binary and c in (1, 3) and b != IMM12:
                live[b] = True
    return codes


def pack_action_codes(codes):
    """[T, L] action codes -> [T, ceil(L/16)] int32 words, 16 per word,
    row j at bits (j % 16) * 2 of word j / 16."""
    T, L = codes.shape
    lw = -(-L // 16)
    padded = np.zeros((T, lw * 16), np.uint32)
    padded[:, :L] = codes
    shifts = (np.arange(16, dtype=np.uint32) * 2)[None, None, :]
    words = (padded.reshape(T, lw, 16) << shifts).sum(axis=2, dtype=np.uint32)
    return words.view(np.int32)
