"""Seeded procedural scenes that the port's checks render and mesh.

`standin_shape` stands in for prospero in 2D (`param_standin_shape`
with two shape parameters, for gradients), `gyroid_sphere` is the 3D
gyroid sphere of the reference's own tests, and `sphere_union_shape` is
a tape-heavy 3D union; the last two are also the mesher's scenes.
`linkage_system` and `chain_system` are equation sets for the solver.
Every scene function uses only the graph API that this package and the
reference package share, so a test can build the same scene in both and
compare the tapes they lower to.
`seeded_action_codes` makes per-tile action codes for the coded leaf
kernel without an interval pass; `adversarial_arena` and
`interleave_op_arena` hand-pack tapes that stress the interpreters'
staging and the two-stream probe's semantics,
`prefixed_random_tapes` gives that probe random tapes that read no
register before writing it, and `mixed_class_tapes` random tapes that
mix its classed rows with rows of its opcode switch.
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


def standin_shape(ctx, n=800, seed=0, x=None):
    """Seeded 2D stand-in of prospero's size: n circles (radii
    0.01-0.06, centres in [-1, 1]), every third clipped to a horizontal
    band by a `max`, reduced by a balanced tree of `min`s. Lowered:
    7,203 ops, 13 registers, 1,066 choices. `x` replaces the x axis
    node (see `param_standin_shape`)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, size=(n, 2))
    r = rng.uniform(0.01, 0.06, size=n)
    x = ctx.x() if x is None else x
    y = ctx.y()
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


def param_standin_shape(ctx, shift, grow, n=800, seed=0):
    """`standin_shape` with two shape parameters, the context nodes
    `shift` and `grow` (e.g. `ctx.input(var)`): every circle moves by
    `shift` along x, and the field is offset by `-grow`, which grows
    every part alike. Four inputs (x, y and the two vars). Lowered with
    two `Var`s at n = 800: 7,207 ops, 14 registers, 1,066 choices."""
    parts = standin_shape(ctx, n, seed, x=ctx.sub(ctx.x(), shift))
    return ctx.sub(parts, grow)


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


#: `gyroid_sphere(pkg)` at its default scale as a `.rhai` script: the
#: script engine traces it to the same 28-op tape
GYROID_SPHERE_RHAI = """\
let scale = 4.0;
let xs = x * scale;
let ys = y * scale;
let zs = z * scale;
let g = xs.sin() * ys.cos() + ys.sin() * zs.cos() + zs.sin() * xs.cos();
let sphere = (xs.square() + ys.square() + zs.square()).sqrt() - scale * 0.8;
draw(sphere.max(g.abs() - 0.2));
"""


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


def linkage_system(pkg):
    """The constraint demo's linkage (demos/constraints.py:24-37, after
    the reference's demos/constraints/src/main.rs:166-211) in `pkg`'s
    `Tree` and `Var`: p0 pinned at the origin, |p1 - p0| = 1,
    |p2 - p1| = 1 and p2 on the x axis, from the demo's start. Returns
    (equations, start), `start` mapping each Var to (value, free)."""
    pts = [(pkg.Var.new(), pkg.Var.new()) for _ in range(3)]
    t = [(pkg.Tree.var(vx), pkg.Tree.var(vy)) for vx, vy in pts]

    def dist2(a, b):
        return (a[0] - b[0]).square() + (a[1] - b[1]).square()

    eqs = [dist2(t[0], t[1]) - 1.0, dist2(t[1], t[2]) - 1.0, t[2][1]]
    values = [(0.0, 0.0, False), (0.3, 1.2, True), (1.5, 0.4, True)]
    start = {}
    for (vx, vy), (x0, y0, free) in zip(pts, values):
        start[vx] = (x0, free)
        start[vy] = (y0, free)
    return eqs, start


def chain_system(pkg, n):
    """A chain of n points in `pkg`'s `Tree` and `Var`: p0 fixed at the
    origin, |p_{k+1} - p_k|^2 - 1 = 0 for k < n - 1 and
    p_k.y - 0.5 sin(0.3 k) = 0 for k >= 1, from x_k = 0.9 k, y_k = 0:
    2 (n - 1) equations over 2 (n - 1) free variables. Returns
    (equations, start), `start` mapping each Var to (value, free)."""
    pts = [(pkg.Var.new(), pkg.Var.new()) for _ in range(n)]
    t = [(pkg.Tree.var(vx), pkg.Tree.var(vy)) for vx, vy in pts]
    eqs = [
        (t[k + 1][0] - t[k][0]).square() + (t[k + 1][1] - t[k][1]).square()
        - 1.0
        for k in range(n - 1)
    ]
    eqs += [t[k][1] - 0.5 * float(np.sin(0.3 * k)) for k in range(1, n)]
    start = {}
    for k, (vx, vy) in enumerate(pts):
        start[vx] = (0.9 * k, k > 0)
        start[vy] = (0.0, k > 0)
    return eqs, start


def seeded_action_codes(w1, w2, n, nf, rng, any_row=False):
    """Seeded 2-bit action codes [L] for the first n rows of one packed
    tape (canonical op order) that mix all four values and keep the
    dataflow valid, so that no executed row reads a register a skipped
    row should have written: a reverse liveness walk that picks keep /
    COPY-from-a / COPY-from-b at random for every executed row and
    skips the rows that leaves dead. COPY-from-b is picked only on
    binary rows, or (`any_row`) on every row but INPUT and OUTPUT, where
    it copies the row's raw b field (the immediate if it is IMM12); a
    non-binary row then keeps with odds 1/2, so that chains of unary
    rows run on.
    Registers are clamped to nf - 1, as the kernels clamp them."""
    from .compiler.pack import IMM12
    from .compiler.tape import BINARY_MASK, TapeOp

    codes = np.zeros(len(w1), np.uint32)
    live = np.zeros(nf, bool)
    for j in reversed(range(n)):
        op = int(w1[j]) & 127
        out = min((int(w1[j]) >> 7) & 0xFFF, nf - 1)
        a = (int(w1[j]) >> 19) & 0xFFF
        b = int(w2[j]) & 0xFFF
        if op != int(TapeOp.OUTPUT) and not live[out]:
            continue
        binary = (BINARY_MASK >> op) & 1 == 1
        if op in (int(TapeOp.OUTPUT), int(TapeOp.INPUT)):
            c = 1
        else:
            c = int(rng.choice([1, 2, 3])) if binary else (
                int(rng.choice([1, 2, 3], p=[0.5, 0.3, 0.2])) if any_row
                else int(rng.choice([1, 2])))
        codes[j] = c
        live[out] = False
        if op != int(TapeOp.INPUT) or c > 1:
            if c in (1, 2) and a != IMM12:
                live[min(a, nf - 1)] = True
            if (binary and c == 1 or c == 3) and b != IMM12:
                live[min(b, nf - 1)] = True
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


#: canonical opcodes the adversarial tapes use (compiler/tape.py TapeOp)
_OUTPUT, _INPUT, _COPY, _MAX, _SUB, _ADD, _MIN, _NEG = range(8)
_MUL, _ABS = 10, 12
_IMM12 = 0xFFF


def adversarial_arena(chunk, liveness=False):
    """Hand-packed tapes built to break the staging of the interpreter
    kernels, which copy a tape through shared memory `chunk` rows at a
    time (the liveness pass from the end backwards). Returns a dict:
    `w1`, `w2`, `imm` ([T, L] with L = 3 * chunk + 5) and `lengths`
    ([T]) in the layout of compiler/pack.py, canonical opcode order;
    `names` ([T]); `nf` = 6 registers, `n_inputs` = 2, `n_outputs` = 2;
    `n_choices`, the most choice rows of any tape.

    The tapes, every op of which f32 rounds correctly:

    - `len0`: no rows (both outputs stay 0); `len1`: one OUTPUT of an
      immediate;
    - `chain<n>` for n = chunk - 1, chunk, chunk + 1, 3 * chunk + 5 and
      `over`, whose length claims 7 rows more than L holds: two INPUT
      rows, then a chain in which every row reads the result of the row
      before it (ADD, MIN, MUL, MAX, ABS, SUB, NEG by turns, against an
      immediate or the second input; ABS names the second input in its
      unused b field; every 17th row restarts the chain from immediate
      + immediate), then OUTPUT 0 of the chain. The MIN
      and MAX rows are choices 0, 1, 2, ... of one lane, sixteen to a
      word, and past 16 * c_words they fold into the last word;
    - `apart`: three accumulators by turns, so that no row reads the
      result of the row before it; OUTPUT 0, then OUTPUT 1 of another
      accumulator (two OUTPUT rows);
    - `clamp`: names register 9 of a 6-register file, which reads and
      writes register 5.

    `liveness=True` adds tapes that only the liveness pass reads (the
    value modes have no opcode past 30):

    - `unknown`: rows with opcodes 31 (past the 31 kernel opcodes, but
      inside the 32-bit op masks) and 40 and 127 (past them), whose b
      fields name a register that nothing else reads: such an op takes
      no b, and its a counts as a register;
    - `rawclamp`: choice rows whose raw a or b differs from out where
      the clamped registers (of the 6) are equal, and one where the raw
      fields are equal, so that a COPY is elided by the raw fields only;
      a choice index of 100 folds into the last of 2 words.
    """
    L = 3 * chunk + 5
    tapes = {}

    def row(op, out=0, a=0, b=0, aux=0, imm=0.0):
        return (op | out << 7 | a << 19, b | aux << 12, imm)

    def chain(n):
        """n rows: INPUT x -> r0, INPUT y -> r1, a dependent chain on
        r2..r5, OUTPUT 0 last."""
        rows = [row(_INPUT, out=0, aux=0), row(_INPUT, out=1, aux=1)]
        prev, choice = 0, 0
        steps = (
            (_ADD, None, 0.37), (_MIN, 1, 0.0), (_MUL, None, 0.83),
            (_MAX, None, -1.25), (_ABS, 1, 0.0), (_SUB, 1, 0.0),
            (_NEG, None, 0.0), (_MIN, None, 0.6),
        )
        j = 0
        while len(rows) < n - 1:
            out = 2 + j % 4
            if j % 17 == 16:
                rows.append(row(_ADD, out, _IMM12, _IMM12, imm=0.21))
            else:
                op, b, imm = steps[j % len(steps)]
                aux = 0
                if op in (_MIN, _MAX):
                    aux, choice = choice, choice + 1
                rows.append(row(op, out, prev, _IMM12 if b is None else b,
                                aux, imm))
            prev, j = out, j + 1
        rows.append(row(_OUTPUT, out=prev, a=prev, aux=0))
        return rows, choice

    n_choices = 0
    tapes["len0"] = ([], 0)
    tapes["len1"] = ([row(_OUTPUT, a=_IMM12, aux=0, imm=1.5)], 1)
    for n in (chunk - 1, chunk, chunk + 1, L):
        rows, c = chain(n)
        n_choices = max(n_choices, c)
        tapes[f"chain{n}"] = (rows, n)
    tapes["over"] = (chain(L)[0], L + 7)

    rows = [row(_INPUT, out=0, aux=0), row(_INPUT, out=1, aux=1),
            row(_COPY, out=2, a=0), row(_COPY, out=3, a=1),
            row(_SUB, out=4, a=0, b=1)]
    choice = 0
    for j in range(2 * chunk):
        acc = 2 + j % 3
        if j % 5 == 4:
            rows.append(row(_MAX, acc, acc, 0, aux=choice))
            choice += 1
        else:
            rows.append(row(_MUL if j % 2 else _ADD, acc, acc, _IMM12,
                            imm=0.91 if j % 2 else 0.13))
    n_choices = max(n_choices, choice)
    rows += [row(_OUTPUT, out=2, a=2, aux=0), row(_OUTPUT, out=3, a=3, aux=1)]
    tapes["apart"] = (rows, len(rows))

    tapes["clamp"] = ([
        row(_INPUT, out=0, aux=0), row(_INPUT, out=9, aux=1),
        row(_ADD, out=5, a=5, b=0), row(_SUB, out=2, a=9, b=_IMM12, imm=0.5),
        row(_OUTPUT, out=2, a=2, aux=0), row(_OUTPUT, out=9, a=9, aux=1),
    ], 6)

    if liveness:
        tapes["unknown"] = ([
            row(_INPUT, out=0, aux=0), row(_INPUT, out=1, aux=1),
            row(31, out=2, a=0, b=1), row(40, out=3, a=2, b=1),
            row(_MIN, out=4, a=3, b=_IMM12, aux=0, imm=0.25),
            row(127, out=5, a=4, b=1), row(_OUTPUT, out=5, a=5, aux=0),
        ], 7)
        tapes["rawclamp"] = ([
            row(_INPUT, out=0, aux=0), row(_INPUT, out=9, aux=1),
            row(_MIN, out=5, a=9, b=0, aux=0),
            row(_MAX, out=9, a=9, b=0, aux=1),
            row(_MIN, out=9, a=0, b=5, aux=2),
            row(_MAX, out=7, a=0, b=7, aux=100),
            row(_OUTPUT, out=9, a=9, aux=0), row(_OUTPUT, out=7, a=7, aux=1),
        ], 8)

    T = len(tapes)
    w1 = np.zeros((T, L), np.int32)
    w2 = np.zeros((T, L), np.int32)
    imm = np.zeros((T, L), np.float32)
    lengths = np.zeros(T, np.int32)
    for t, (rows, n) in enumerate(tapes.values()):
        for j, (a, b, c) in enumerate(rows):
            w1[t, j], w2[t, j], imm[t, j] = a, b, c
        lengths[t] = n
    return dict(w1=w1, w2=w2, imm=imm, lengths=lengths, names=list(tapes),
                nf=6, n_inputs=2, n_outputs=2, n_choices=n_choices)


#: special values the op checks pair with each other: signed zeros,
#: units, halves, pi multiples, large and huge values, NaN, infinities,
#: integers past 2^23 and the float just below one half
SPICY = np.array(
    [
        0.0, -0.0, 1.0, -1.0, 0.5, -0.5, 2.0, -2.0, 100.0, -100.0,
        np.pi, -np.pi, np.pi / 2, -np.pi / 2, 2 * np.pi,
        0.1, -0.1, 1e6, -1e6, np.nan, np.inf, -np.inf,
        8388609.0, -8388609.0, 2.5, -2.5, 0.49999997,
    ],
    dtype=np.float32,
)

#: the opcodes `interleave_op_arena` covers: every dispatchable one and
#: three past the switch
INTERLEAVE_OPCODES = tuple(range(31)) + (31, 40, 127)
#: (name, a, b, immediate) of the op row per (instance parity, stream);
#: 1 and 2 are registers, None the immediate operand
_INTERLEAVE_VARIANTS = {
    (0, 0): ("reg_reg", 1, 2, 0.0),
    (0, 1): ("imm_reg", None, 2, 0.5),
    (1, 0): ("reg_imm", 1, None, -2.0),
    (1, 1): ("reg_reg_swapped", 2, 1, 0.0),
}


def interleave_op_arena(s0, nf=8, V=3, past_nf=False):
    """Two-stream tapes (the probe `interp_float2`) with one op row each:
    two instances per opcode of INTERLEAVE_OPCODES, whose four streams
    put the op's operands as register-register, immediate-register,
    register-immediate and swapped registers. Every stream first loads
    register k from input k (nf INPUT rows; aux k past V - 1 clamps to
    the last input), then runs the op into register 5 with aux V + 3
    (INPUT then reads past V) and copies register 5 to register 0, the
    stream's result. Input 1 and 2 pair every SPICY value with every
    other across the lanes (s0 * 128 >= len(SPICY)^2), input 0 is a
    ramp. `past_nf` adds an instance whose registers lie past nf - 1 in
    both streams (the port clamps them; the reference does not).

    Returns (w1a, w2a, imma, w1b, w2b, immb, vars_, labels) as numpy
    arrays, labels[(t, s)] = (opcode, variant)."""
    from .compiler.pack import IMM12
    from .compiler.tape import TapeOp

    lanes = s0 * 128
    n = len(SPICY)
    if lanes < n * n or nf < 6:
        raise ValueError(f"needs s0 * 128 >= {n * n} lanes and nf >= 6")

    def word(op, out, a, b, aux=0):
        return (op | (out << 7) | (a << 19)), (b | (aux << 12))

    def stream(op, a, b):
        rows = [word(int(TapeOp.INPUT), k, 0, 0, k) for k in range(nf)]
        rows.append(word(op, 5, IMM12 if a is None else a,
                         IMM12 if b is None else b, V + 3))
        rows.append(word(int(TapeOp.COPY), 0, 5, 0))
        return rows

    tapes, imms, labels = [], [], {}
    for i, op in enumerate(INTERLEAVE_OPCODES):
        for par in (0, 1):
            pair, pimm = [], []
            for s in (0, 1):
                name, a, b, iv = _INTERLEAVE_VARIANTS[(par, s)]
                pair.append(stream(op, a, b))
                pimm.append(iv)
                labels[(2 * i + par, s)] = (op, name)
            tapes.append(pair)
            imms.append(pimm)
    if past_nf:
        far = nf + 7
        for s in (0, 1):
            labels[(len(tapes), s)] = (int(TapeOp.ADD), "registers past nf")
        rows = [word(int(TapeOp.INPUT), k, 0, 0, k) for k in range(nf)]
        tapes.append([rows + [word(int(TapeOp.ADD), far, 1, far),
                              word(int(TapeOp.COPY), 0, far, 0)],
                      rows + [word(int(TapeOp.ADD), far, 1, 2),
                              word(int(TapeOp.MUL), 0, far, far)]])
        imms.append([0.0, 0.0])
    T, L = len(tapes), nf + 2
    w1 = np.zeros((2, T, L), np.int64)
    w2 = np.zeros((2, T, L), np.int64)
    imm = np.zeros((2, T, L), np.float32)
    for t, pair in enumerate(tapes):
        for s, rows in enumerate(pair):
            w1[s, t] = [r[0] for r in rows]
            w2[s, t] = [r[1] for r in rows]
            imm[s, t, nf] = imms[t][s]
    vars_ = np.zeros((T, V, lanes), np.float32)
    vars_[:, 0] = np.linspace(-4.0, 4.0, lanes, dtype=np.float32)
    pa = np.pad(np.repeat(SPICY, n), (0, lanes - n * n))
    pb = np.pad(np.tile(SPICY, n), (0, lanes - n * n))
    if V > 1:
        vars_[:, 1] = pa
    if V > 2:
        vars_[:, 2] = pb
    w1, w2 = w1.astype(np.int32), w2.astype(np.int32)
    return (w1[0], w2[0], imm[0], w1[1], w2[1], imm[1],
            vars_.reshape(T, V, s0, 128), labels)


def prefixed_random_tapes(T, L, nf, V, seed):
    """T `random_tape`s of the two-stream probe (demos/exp_interleave.py)
    drawn in turn from one seeded generator, each behind nf INPUT rows
    that load register k from input k % V, so that no row reads a
    register the walk has not written. Returns numpy (w1, w2, imm, rng):
    [T, nf + L] words, normal immediates, and the generator for the
    caller's inputs."""
    from .compiler.tape import TapeOp
    from .demos.exp_interleave import random_tape

    rng = np.random.default_rng(seed)
    pre1 = np.array([int(TapeOp.INPUT) | (k << 7) for k in range(nf)],
                    np.int32)
    pre2 = np.array([(k % V) << 12 for k in range(nf)], np.int32)
    w1 = np.zeros((T, nf + L), np.int32)
    w2 = np.zeros((T, nf + L), np.int32)
    for i in range(T):
        a, b = random_tape(L, nf, rng)
        w1[i] = np.concatenate([pre1, a])
        w2[i] = np.concatenate([pre2, b])
    imm = rng.normal(size=w1.shape).astype(np.float32)
    return w1, w2, imm, rng


#: the opcodes of `mixed_class_tapes`: the two-stream kernel's classed
#: rows (demos/exp_interleave.py `ROW_CLASSES`) and rows of its switch
#: whose results f32 rounds correctly on every device
MIXED_CLASSED = ("ADD", "SUB", "MUL", "MIN", "MAX", "COPY", "OUTPUT")
MIXED_SWITCH = ("INPUT", "NEG", "ABS", "SQUARE", "SQRT", "DIV", "FLOOR",
                "CEIL", "ROUND", "NOT", "AND", "OR", "COMPARE", "MOD")


def mixed_class_tapes(T, L, nf, V, seed):
    """T tapes of the two-stream probe that mix classed and switch rows
    in every chunk: nf INPUT rows as in `prefixed_random_tapes`, then L
    rows, three in four drawn from MIXED_CLASSED and one in four from
    MIXED_SWITCH, with random registers (some past nf), immediate
    operands one time in eight (one immediate in twenty a signed zero,
    NaN or an infinity, the rest normal) and INPUT's aux up to V + 1.
    Returns numpy (w1, w2, imm, rng) as `prefixed_random_tapes` does."""
    from .compiler.tape import TapeOp

    rng = np.random.default_rng(seed)
    classed = [int(TapeOp[n]) for n in MIXED_CLASSED]
    switch = [int(TapeOp[n]) for n in MIXED_SWITCH]
    op = np.where(rng.random((T, L)) < 0.75, rng.choice(classed, (T, L)),
                  rng.choice(switch, (T, L)))
    reg = lambda: rng.integers(0, nf + 2, (T, L))
    imm_or = lambda r: np.where(rng.random((T, L)) < 0.125, 0xFFF, r)
    out, a, b = reg(), imm_or(reg()), imm_or(reg())
    aux = rng.integers(0, V + 2, (T, L))
    pre1 = np.array([int(TapeOp.INPUT) | (k << 7) for k in range(nf)],
                    np.int64)
    pre2 = np.array([(k % V) << 12 for k in range(nf)], np.int64)
    w1 = np.concatenate([np.broadcast_to(pre1, (T, nf)),
                         op | (out << 7) | (a << 19)], axis=1)
    w2 = np.concatenate([np.broadcast_to(pre2, (T, nf)), b | (aux << 12)],
                        axis=1)
    special = np.array([0.0, -0.0, np.nan, np.inf, -np.inf], np.float32)
    imm = np.where(rng.random((T, nf + L)) < 0.05,
                   rng.choice(special, (T, nf + L)),
                   rng.normal(size=(T, nf + L))).astype(np.float32)
    return w1.astype(np.int32), w2.astype(np.int32), imm, rng
