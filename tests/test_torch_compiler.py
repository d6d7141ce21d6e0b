"""The port's host compiler against fidget_tpu's: identical tapes and
bit-identical packed words, through both routes a shape can take into
the port (`Tape.from_arrays` on the reference's fields, and `.vm` text
through the port's own parser and `lower`), plus the guards that keep
the port free of JAX.
"""

import doctest
import subprocess
import sys

import numpy as np
import pytest

import fidget_tpu as ref
import fidget_tpu.compiler.pack as ref_pack
import fidget_tpu_torch as port
import fidget_tpu_torch.compiler.bytecode
import fidget_tpu_torch.compiler.lower
import fidget_tpu_torch.compiler.pack as port_pack
import fidget_tpu_torch.compiler.tape
import fidget_tpu_torch.core.context
import fidget_tpu_torch.core.tree
import fidget_tpu_torch.core.var
import fidget_tpu_torch.eval.unrolled
import fidget_tpu_torch.gui
import fidget_tpu_torch.render.region
import fidget_tpu_torch.script
import fidget_tpu_torch.shape
import fidget_tpu_torch.shapes
import fidget_tpu_torch.solver


def _circle(ctx):
    x, y = ctx.x(), ctx.y()
    return ctx.sub(ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y))), 0.6)


def _spiky(ctx):
    x, y = ctx.x(), ctx.y()
    r = ctx.sqrt(ctx.add(ctx.square(x), ctx.square(y)))
    return ctx.min(
        ctx.sub(r, 0.8),
        ctx.max(ctx.sub(ctx.abs(x), 0.3), ctx.sub(ctx.abs(y), 0.9)),
    )


def circle_union(ctx, n=40, seed=0):
    """Balanced min-union of n seeded circles (~8 ops each)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, size=(n, 2))
    r = rng.uniform(0.05, 0.3, size=n)
    x, y = ctx.x(), ctx.y()
    parts = [
        ctx.sub(
            ctx.sqrt(ctx.add(
                ctx.square(ctx.sub(x, float(c[i, 0]))),
                ctx.square(ctx.sub(y, float(c[i, 1]))),
            )),
            float(r[i]),
        )
        for i in range(n)
    ]
    while len(parts) > 1:
        nxt = [ctx.min(parts[i], parts[i + 1])
               for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    return parts[0]


SHAPES = {"circle": _circle, "spiky": _spiky, "union": circle_union}


def _assert_same_tape(t_port, t_ref):
    for f in ("op", "out", "a", "b", "imm", "aux"):
        np.testing.assert_array_equal(
            getattr(t_port, f), getattr(t_ref, f), err_msg=f
        )
    for f in ("reg_count", "mem_count", "choice_count", "output_count"):
        assert getattr(t_port, f) == getattr(t_ref, f), f
    assert [v.kind for v in t_port.var_map] == [v.kind for v in t_ref.var_map]


def _assert_same_pack(p_port, p_ref):
    for f in ("w1", "w2", "imm", "lengths", "n_choices"):
        a, b = getattr(p_port, f), getattr(p_ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32
                                      else a,
                                      b.view(np.uint32) if b.dtype == np.float32
                                      else b, err_msg=f)
    assert (p_port.nf, p_port.n_inputs, p_port.n_outputs) == (
        p_ref.nf, p_ref.n_inputs, p_ref.n_outputs
    )


def port_tape_from_ref(t):
    """The hand-over route: the reference's Tape fields as numpy arrays."""
    return port.Tape.from_arrays(
        t.op, t.out, t.a, t.b, t.imm, t.aux, t.reg_count, t.mem_count,
        t.choice_count, t.output_count, [v.kind for v in t.var_map],
    )


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_from_arrays_route_packs_identically(name):
    ctx = ref.Context()
    t_ref = ref.lower(ctx, [SHAPES[name](ctx)])
    t_port = port_tape_from_ref(t_ref)
    _assert_same_tape(t_port, t_ref)
    _assert_same_pack(
        port_pack.pack_tapes([t_port], capacity=1 << 10),
        ref_pack.pack_tapes([t_ref], capacity=1 << 10),
    )


@pytest.mark.parametrize("reg_limit", [255, 3])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_vm_route_lowers_and_packs_identically(name, reg_limit):
    """Reference .vm text through each package's own parser and lower;
    reg_limit=3 forces spills (LOAD/STORE -> unified-file COPY)."""
    ctx = ref.Context()
    text = ctx.export(SHAPES[name](ctx))
    rc, rroot = ref.Context.from_text(text)
    pc, proot = port.Context.from_text(text)
    t_ref = ref.lower(rc, [rroot], reg_limit=reg_limit)
    t_port = port.lower(pc, [proot], reg_limit=reg_limit)
    if reg_limit == 3 and name != "circle":
        assert t_ref.mem_count > 0
    _assert_same_tape(t_port, t_ref)
    assert port_pack.frequency_op_order(t_port) == ref_pack.frequency_op_order(
        t_ref
    )
    order = ref_pack.frequency_op_order(t_ref)
    for op_order in (None, order):
        _assert_same_pack(
            port_pack.pack_tapes([t_port, t_port], op_order=op_order),
            ref_pack.pack_tapes([t_ref, t_ref], op_order=op_order),
        )
    np.testing.assert_array_equal(
        port_pack._op_rank(order), ref_pack._op_rank(order)
    )
    assert port_pack.IMM12 == ref_pack.IMM12


def test_union_tape_is_a_few_hundred_ops():
    ctx = port.Context()
    t = port.lower(ctx, [circle_union(ctx)])
    assert 250 <= len(t) <= 400
    assert t.choice_count == 39


def test_tree_import_matches_reference():
    x, y, _ = port.Tree.axes()
    rx, ry, _ = ref.Tree.axes()
    pt = port.tree_min((x.square() + y.square()).sqrt() - 0.5, x.abs() - 0.2)
    rt = ref.tree_min((rx.square() + ry.square()).sqrt() - 0.5, rx.abs() - 0.2)
    pc, rc = port.Context(), ref.Context()
    assert pc.export(pc.import_tree(pt)) == rc.export(rc.import_tree(rt))


def test_vm_parse_errors():
    with pytest.raises(fidget_tpu_torch.core.context.ParseError):
        port.Context.from_text("a var-x\nb frob a")
    with pytest.raises(fidget_tpu_torch.core.context.ParseError):
        port.Context.from_text("# nothing\n")


DOC_MODULES = [
    fidget_tpu_torch.core.context,
    fidget_tpu_torch.core.tree,
    fidget_tpu_torch.core.var,
    fidget_tpu_torch.compiler.lower,
    fidget_tpu_torch.compiler.tape,
    fidget_tpu_torch.eval.unrolled,
    fidget_tpu_torch.mesh,
    fidget_tpu_torch.render.region,
    fidget_tpu_torch.shape,
    fidget_tpu_torch.compiler.bytecode,
    fidget_tpu_torch.gui,
    fidget_tpu_torch.script,
    fidget_tpu_torch.shapes,
    fidget_tpu_torch.solver,
]


@pytest.mark.parametrize("mod", DOC_MODULES, ids=lambda m: m.__name__)
def test_port_doctests(mod):
    res = doctest.testmod(
        mod, optionflags=doctest.NORMALIZE_WHITESPACE, verbose=False
    )
    assert res.failed == 0
    assert res.attempted > 0


def test_port_imports_no_jax():
    code = (
        "import sys, fidget_tpu_torch, fidget_tpu_torch.render.render2d, "
        "fidget_tpu_torch.render.render3d, fidget_tpu_torch.shape, "
        "fidget_tpu_torch.scenes, fidget_tpu_torch.eval.cuda, "
        "fidget_tpu_torch.compiler.simplify, "
        "fidget_tpu_torch.eval.simplify_device, fidget_tpu_torch.eval.bulk, "
        "fidget_tpu_torch.mesh.collapse, fidget_tpu_torch.native, "
        "fidget_tpu_torch.io.image, fidget_tpu_torch.io.models, "
        "fidget_tpu_torch.gui, fidget_tpu_torch.shapes, "
        "fidget_tpu_torch.script, fidget_tpu_torch.render.effects, "
        "fidget_tpu_torch.render.compose, fidget_tpu_torch.cli, "
        "fidget_tpu_torch.viewer, fidget_tpu_torch.utils, "
        "fidget_tpu_torch.compiler.bytecode, fidget_tpu_torch.serve, "
        "fidget_tpu_torch.solver, fidget_tpu_torch.parallel.sharding\n"
        "from fidget_tpu_torch import BoundShape, CancelToken, eval_script, "
        "solve\n"
        "fidget_tpu_torch.native.compile_vm('x var-x\\n')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fidget_tpu' or m.startswith('fidget_tpu.')]\n"
        "assert not bad, bad\n"
    )
    root = __import__("pathlib").Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root,
                   timeout=120)


def test_port_sources_name_no_jax():
    """AST scan: no module of the port imports jax or fidget_tpu."""
    import ast
    import pathlib

    pkg = pathlib.Path(fidget_tpu_torch.__file__).resolve().parent
    paths = list(pkg.rglob("*.py"))
    for module in ("solver/__init__.py", "parallel/sharding.py"):
        assert pkg / module in paths, module
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "fidget_tpu"), (path, n)


def test_public_api_covers_the_reference():
    """Every name the reference exports, the port exports too."""
    missing = set(ref.__all__) - set(port.__all__)
    assert not missing, missing
    for name in ref.__all__:
        assert getattr(port, name) is not None


def test_renderer_without_device_raises_without_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = port.Context()
    tape = port.lower(ctx, [_circle(ctx)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.PixelRenderer(tape, port.ImageSize(64, 64))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.render2d(tape, port.ImageSize(64, 64))


def test_prospero_standin_lowers_identically():
    """The 2D main path's procedural stand-in: 7,203 ops, 13 registers
    and 1,066 choices built directly in either package, identical tapes
    packed bit-identically into its 8192-row bucket, and identical tapes
    through the .vm route too."""
    from fidget_tpu_torch.scenes import standin_shape

    ctx = ref.Context()
    root = standin_shape(ctx)
    t_ref = ref.lower(ctx, [root])
    pc = port.Context()
    t_port = port.lower(pc, [standin_shape(pc)])
    assert (len(t_ref), t_ref.reg_count, t_ref.choice_count) == (7203, 13, 1066)
    _assert_same_tape(t_port, t_ref)
    _assert_same_pack(
        port_pack.pack_tapes([t_port], capacity=8192),
        ref_pack.pack_tapes([t_ref], capacity=8192),
    )
    text = ctx.export(root)
    rc, rroot = ref.Context.from_text(text)
    pc, proot = port.Context.from_text(text)
    _assert_same_tape(port.lower(pc, [proot]), ref.lower(rc, [rroot]))
