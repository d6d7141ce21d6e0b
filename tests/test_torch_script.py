"""The port's script engine and shape library against fidget_tpu's.

Every script source in tests/test_script.py (each first argument of
`ev`, `eval_script`, `engine().run` and `engine().eval` there, read off
its syntax tree) runs through both engines: the traced shapes must
export (`Context.export`) to the same `.vm` text, the colors and the
trailing value must be equal, and a script that fails must raise the
same `ScriptError` type with the same message. The shape library's
registry must hold the same names and fields, and every shape class,
built with the same fields (defaults, and every field moved off its
default), must export the same `.vm` text. All exact.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

import fidget_tpu as ref
import fidget_tpu.core.tree as ref_tree
import fidget_tpu.script as ref_script
import fidget_tpu.shapes as ref_shapes
import fidget_tpu_torch as port
import fidget_tpu_torch.core.tree as port_tree
import fidget_tpu_torch.script as port_script
import fidget_tpu_torch.shapes as port_shapes
from fidget_tpu_torch.scenes import GYROID_SPHERE_RHAI

HERE = pathlib.Path(__file__).resolve().parent


def _script_sources():
    """The script literals of tests/test_script.py, in file order."""
    tree = ast.parse((HERE / "test_script.py").read_text())
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        name = f.id if isinstance(f, ast.Name) else (
            f.attr if isinstance(f, ast.Attribute) else None)
        arg = node.args[0]
        if (name in ("ev", "eval_script", "run", "eval")
                and isinstance(arg, ast.Constant)
                and isinstance(arg.value, str) and arg.value not in out):
            out.append(arg.value)
    return out


SOURCES = _script_sources()
#: the engine features of the bundled models, which are not in this
#: repository: loops, fns, closures, transforms and colored draws
EXTRA_SOURCES = [
    GYROID_SPHERE_RHAI,
    "fn ring(r, n) { let s = []; for i in 0..n { let a = 2.0 * PI * i / n; "
    "s.push(circle(#{ center: [r * cos(a), r * sin(a)], radius: 0.1 })); } "
    "union(s) } draw_rgb(ring(0.6, 7), 1.0, 0.5, 0.25); "
    "draw(box(#{ corner: [-0.2, -0.2, -0.2] }).rotate_z(30.0));",
    "let c = sphere(#{ radius: 0.5 }).scale([1.0, 2.0, 0.5]); "
    "let d = c.move([0.1, 0.2, 0.3]); draw(difference(d, x - 0.25));",
]


def _export(pkg_tree, pkg, t):
    """`.vm` text of a Tree, or the error its export raises."""
    ctx = pkg.Context()
    try:
        return ctx.export(pkg_tree.import_tree(ctx, t))
    except ValueError as e:
        return ("error", type(e).__name__, str(e))


def _summary(pkg_script, pkg_tree, pkg, src):
    """What a script traced, in package-free terms."""
    try:
        res = pkg_script.engine().run(src)
    except Exception as e:  # noqa: BLE001 - compared between packages
        return ("raised", type(e).__name__, str(e))
    last = res.last
    if isinstance(last, pkg.Tree):
        last = _export(pkg_tree, pkg, last)
    elif callable(last) or hasattr(last, "__dict__"):
        last = type(last).__name__
    return (
        [_export(pkg_tree, pkg, s) for s in res.shapes],
        [None if c is None else tuple(c) for c in res.colors],
        repr(last),
    )


def test_sources_were_found():
    assert len(SOURCES) >= 60


@pytest.mark.parametrize("src", SOURCES + EXTRA_SOURCES,
                         ids=[f"s{i}" for i in range(len(SOURCES + EXTRA_SOURCES))])
def test_script_traces_the_same_vm(src):
    want = _summary(ref_script, ref_tree, ref, src)
    got = _summary(port_script, port_tree, port, src)
    assert got == want


def test_script_error_is_a_value_error():
    assert issubclass(port_script.ScriptError, ValueError)
    with pytest.raises(port_script.ScriptError, match="step limit"):
        port.eval_script("let i = 0; while true { i = i + 1; }")


def test_gyroid_script_is_the_scene():
    """`GYROID_SPHERE_RHAI` traces to the tape of `gyroid_sphere`."""
    from fidget_tpu_torch.compiler.bytecode import as_bytes
    from fidget_tpu_torch.scenes import gyroid_sphere

    shape = port.Shape.from_tree(port.eval_script(GYROID_SPHERE_RHAI).tree)
    assert as_bytes(shape.tape()) == as_bytes(gyroid_sphere(port).tape())
    assert len(shape.tape()) == 28


def test_registry_names_and_fields():
    assert sorted(port_shapes.SHAPE_REGISTRY) == sorted(ref_shapes.SHAPE_REGISTRY)
    assert port_shapes.__all__ == ref_shapes.__all__
    for name, cls in ref_shapes.SHAPE_REGISTRY.items():
        mine = port_shapes.SHAPE_REGISTRY[name]
        specs = [(n, getattr(t, "__name__", str(t)), d)
                 for n, t, d in mine.field_specs()]
        want = [(n, getattr(t, "__name__", str(t)), d)
                for n, t, d in cls.field_specs()]
        assert specs == want, name


def _inputs(s):
    """Three child trees of the shape library `s`, made alike."""
    return [
        s.Circle((0.1, -0.2), 0.7).to_tree(),
        s.Sphere((0.3, 0.2, -0.1), 0.4).to_tree(),
        s.Box((-0.5, -0.4, -0.3), (0.2, 0.6, 0.5)).to_tree(),
    ]


def _value(pkg_shapes, f, default, inputs, moved):
    """A field value made alike in both packages: the default, or (when
    `moved`) a value off it; tree fields get the package's child
    trees, a shape's second tree field the second tree."""
    kind = str(f.type)
    if "Tree" in kind and default is None:
        return inputs[1] if f.name in ("b", "cutout") else inputs[0]
    if default is dataclasses.MISSING:
        if "list" in kind:
            return list(inputs)
        raise AssertionError(f"no value for {f.name}: {kind}")
    if not moved:
        return default
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return float(default) + 0.375
    if isinstance(default, tuple):
        return tuple(float(v) + 0.125 * (k + 1) for k, v in enumerate(default))
    if isinstance(default, ref_shapes.Axis) or isinstance(default, port_shapes.Axis):
        return pkg_shapes.Axis((1.0, 2.0, 3.0))
    if isinstance(default, ref_shapes.Plane) or isinstance(default, port_shapes.Plane):
        return pkg_shapes.Plane(pkg_shapes.Axis((1.0, -2.0, 0.5)), 0.25)
    if isinstance(default, list):
        return list(inputs)
    return default


def _build(pkg_shapes, name, moved):
    cls = pkg_shapes.SHAPE_REGISTRY[name]
    inputs = _inputs(pkg_shapes)
    kw = {}
    for f in dataclasses.fields(cls):
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        kw[f.name] = _value(pkg_shapes, f, default, inputs, moved)
    return cls(**kw).to_tree()


@pytest.mark.parametrize("moved", [False, True], ids=["defaults", "moved"])
@pytest.mark.parametrize("name", sorted(ref_shapes.SHAPE_REGISTRY))
def test_shape_class_exports_the_same_vm(name, moved):
    want = _export(ref_tree, ref, _build(ref_shapes, name, moved))
    got = _export(port_tree, port, _build(port_shapes, name, moved))
    assert got == want
    assert not isinstance(got, tuple), got


def test_functional_helpers_export_the_same_vm():
    for fn in ("union", "intersection", "difference", "blend"):
        a = [c.to_tree() for c in (ref_shapes.Circle((0, 0), 1.0),
                                   ref_shapes.Circle((1.5, 0), 0.5))]
        b = [c.to_tree() for c in (port_shapes.Circle((0, 0), 1.0),
                                   port_shapes.Circle((1.5, 0), 0.5))]
        args = (0.2,) if fn == "blend" else ()
        want = _export(ref_tree, ref, getattr(ref_shapes, fn)(*a, *args))
        got = _export(port_tree, port, getattr(port_shapes, fn)(*b, *args))
        assert got == want, fn


def test_eval_matches_on_points():
    """The traced trees evaluate alike (the host evaluator of each
    package) at seeded points, as a check of the comparison itself."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, size=(8, 3))
    t_ref = ref.eval_script(GYROID_SPHERE_RHAI).tree
    t_port = port.eval_script(GYROID_SPHERE_RHAI).tree
    for x, y, z in pts:
        assert t_port.eval(x, y, z) == t_ref.eval(x, y, z)
