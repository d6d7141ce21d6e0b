"""The port's native tape compiler and bytecode against fidget_tpu's.

`fidget_tpu_torch.native.compile_vm` (tape_compiler.cpp, built by g++
into fidget_tpu_torch/_build/native-<hash>/) must give exactly the
reference compiler's tape fields (op, out, a, b, imm, aux, the counts
and the VarMap) on the 7,203-op stand-in exported to `.vm`, on the
opcode matrix and spill chain of tests/test_native.py, and on the
reference's own regressions; malformed input must raise the same
ValueError message. `compiler.bytecode` must give the same words and
bytes (`encode`, `as_bytes`, `save_tape`) and decode them to the same
tapes. All exact. Unlike the reference, the port's compiler never
returns None: a failed build raises.
"""

import os
import pathlib
import subprocess
import tempfile

import numpy as np
import pytest

import fidget_tpu as ref
from fidget_tpu import native as ref_native
from fidget_tpu.compiler import bytecode as ref_bc
import fidget_tpu_torch as port
from fidget_tpu_torch import native
from fidget_tpu_torch.compiler import bytecode as bc
from fidget_tpu_torch.scenes import (
    GYROID_SPHERE_RHAI,
    sphere_union_shape,
    standin_shape,
)

ALL_OPS = """
a var-x
b var-y
c var-z
n0 neg a
n1 abs b
n2 recip c
n3 sqrt n1
n4 square a
n5 floor b
n6 ceil c
n7 round a
n8 sin b
n9 cos c
n10 tan a
n11 asin b
n12 acos c
n13 atan a
n14 exp b
n15 ln n1
n16 not a
k0 const 0.5
s0 add n0 n1
s1 sub s0 n2
s2 mul s1 n3
s3 div s2 n4
s4 atan2 s3 n5
s5 min s4 n6
s6 max s5 n7
s7 compare s6 n8
s8 mod s7 n9
s9 and s8 n10
s10 or s9 n11
s11 add s10 n12
s12 add s11 n13
s13 add s12 n14
s14 add s13 n15
s15 add s14 n16
s16 mul s15 k0
"""


def _spill_chain():
    lines = ["x var-x", "y var-y"]
    names = []
    for i in range(40):
        lines.append(f"m{i} mul x y")
        lines.append(f"x2_{i} add x m{i}")
        names.append(f"x2_{i}")
    acc = names[0]
    for i, n in enumerate(names[1:]):
        lines.append(f"acc{i} add {acc} {n}")
        acc = f"acc{i}"
    return "\n".join(lines)


def _exported(pkg, build):
    ctx = pkg.Context()
    return ctx.export(build(ctx))


SOURCES = {
    "standin": lambda: _exported(ref, standin_shape),
    "sphere_union": lambda: _exported(ref, sphere_union_shape),
    "gyroid": lambda: _exported(
        ref, lambda c: ref.core.tree.import_tree(
            c, ref.eval_script(GYROID_SPHERE_RHAI).tree)),
    "all_ops": lambda: ALL_OPS,
    "spill": _spill_chain,
    "const_unary": lambda: "a const 1.5\nb neg a\nx var-x\nc add x b\n",
    "const_min": lambda: "a const 2\nb const 3\nc min a b\nx var-x\nd mul x c\n",
    "const_sqrt": lambda: "a const 4\nb sqrt a\nx var-x\nc add x b\n",
    "dead_subtree": lambda: "x var-x\nt1 sin x\nt2 mul t1 t1\nout add x x\n",
    "unused_axis": lambda: "a var-x\nb var-z\nc add a a\n",
    "round_large": lambda: "a const 8388609\nb round a\nc var-x\nout add b c\n",
}


def ref_native_compiler():
    """`fidget_tpu.native` with its library loaded, built in a directory
    of this process's own when no earlier load of the process succeeded.

    The reference's loader builds through one temporary file in a shared
    directory (`fidget_tpu/native/__init__.py:66-72`) and keeps a failed
    first load for the life of the process (`_TRIED`): test workers that
    build at once from an empty cache lose that race and get None. Here
    the load runs with `FIDGET_TPU_CACHE` pointing at a directory named
    after the worker and the process (set only around the load), and a
    failed earlier load is tried again; the reference is not changed."""
    if ref_native._LIB is None:
        worker = os.environ.get("PYTEST_XDIST_WORKER", "main")
        own = os.path.join(tempfile.gettempdir(),
                           f"fidget_tpu_native_{worker}_{os.getpid()}")
        saved = os.environ.get("FIDGET_TPU_CACHE")
        os.environ["FIDGET_TPU_CACHE"] = own
        ref_native._TRIED = False
        try:
            ref_native._load()
        finally:
            if saved is None:
                os.environ.pop("FIDGET_TPU_CACHE", None)
            else:
                os.environ["FIDGET_TPU_CACHE"] = saved
    return ref_native


def _fields(t):
    return (
        [np.asarray(getattr(t, f)).tolist() for f in
         ("op", "out", "a", "b", "aux")],
        np.asarray(t.imm, np.float32).view(np.uint32).tolist(),
        (t.reg_count, t.mem_count, t.choice_count, t.output_count),
        [(v.kind, v.ident) for v in t.var_map],
    )


@pytest.mark.parametrize("reg_limit", [255, 4])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_compile_vm_fields_exact(name, reg_limit):
    import fidget_tpu.core.tree  # noqa: F401 - `ref.core.tree` above

    text = SOURCES[name]()
    want = ref_native_compiler().compile_vm(text, reg_limit)
    assert want is not None, "the reference's native compiler did not build"
    got = native.compile_vm(text, reg_limit)
    assert isinstance(got, port.Tape)
    assert _fields(got) == _fields(want)


def test_spill_chain_spills():
    assert native.compile_vm(_spill_chain(), reg_limit=4).mem_count > 0


def test_standin_evaluates_as_the_python_lowering():
    """The compiled stand-in has the size of the port's `lower` of it
    and the same values at seeded points (the two may order independent
    subtrees differently, as in tests/test_native.py, but every node
    computes the same f32 operation on the same operands)."""
    from fidget_tpu_torch.eval.arith import FloatMode
    from fidget_tpu_torch.eval.unrolled import eval_tape

    text = SOURCES["standin"]()
    ctx, root = port.Context.from_text(text)
    t = native.compile_vm(text)
    lowered = port.lower(ctx, [root])
    assert (len(t), t.reg_count, t.choice_count) == (7203, 13, 1066)
    assert (len(lowered), lowered.choice_count) == (7203, 1066)
    pts = np.random.RandomState(0).uniform(-1, 1, (2, 4096)).astype(np.float32)

    def ev(tape):
        ins = [pts[0] if v.kind == "x" else pts[1] for v in tape.var_map]
        with np.errstate(all="ignore"):
            (d,), _ = eval_tape(tape, FloatMode(np), ins)
        return d

    np.testing.assert_array_equal(ev(t), ev(lowered))


@pytest.mark.parametrize("text", [
    "a bogus x", "a add undefined1 undefined2", "", "x var-x\no neg x\n",
    "x var-x\ny var-q\n", "x var-x\ny add x\n",
])
def test_malformed_input_raises_the_same_error(text):
    reg_limit = 1 if text == "x var-x\no neg x\n" else 255
    with pytest.raises(Exception) as want:
        ref_native_compiler().compile_vm(text, reg_limit)
    with pytest.raises(Exception) as got:
        native.compile_vm(text, reg_limit)
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


def test_available_builds_and_returns_true():
    assert native.available() is True
    lib = next(p for p in native._BUILD_ROOT.glob("native-*/libtape_compiler.so"))
    assert lib.stat().st_size > 0


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent None: a g++ that fails makes compile_vm raise."""
    bad = tmp_path / "tape_compiler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_HERE", tmp_path)
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native, "_LIBS", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for tape_compiler.cpp"):
        native.compile_vm("x var-x\n")


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_bytecode_words_and_bytes_equal(name):
    text = SOURCES[name]()
    t_ref = ref_native_compiler().compile_vm(text)
    t_port = native.compile_vm(text)
    w_ref = np.asarray(ref_bc.encode(t_ref))
    w_port = np.asarray(bc.encode(t_port))
    assert w_port.dtype == w_ref.dtype
    np.testing.assert_array_equal(w_port, w_ref)
    assert bc.as_bytes(t_port) == ref_bc.as_bytes(t_ref)
    assert bc.save_tape(t_port) == ref_bc.save_tape(t_ref)
    assert bc.repack_map(t_port) == ref_bc.repack_map(t_ref)
    back = bc.decode(w_port, t_port.var_map)
    want = ref_bc.decode(w_ref, t_ref.var_map)
    assert _fields(back) == _fields(want)
    assert _fields(bc.load_tape(bc.save_tape(t_port))) == _fields(
        ref_bc.load_tape(ref_bc.save_tape(t_ref)))


def test_bytecode_with_shape_vars_round_trips():
    ctx = port.Context()
    v = port.Var.new()
    x = ctx.x()
    t = port.lower(ctx, [ctx.sub(ctx.mul(x, ctx.input(v)), 0.5)])
    back = bc.load_tape(bc.save_tape(t))
    assert _fields(back) == _fields(t)
    with pytest.raises(ValueError, match="bad magic"):
        bc.load_tape(b"\0" * 16)


def test_load_vm_tape_uses_the_native_compiler(tmp_path, monkeypatch):
    from fidget_tpu_torch.io import models

    (tmp_path / "m.vm").write_text(ALL_OPS)
    monkeypatch.setattr(models, "_CANDIDATES", [str(tmp_path)])
    assert models.has_model("m.vm") and not models.has_model("n.vm")
    t = models.load_vm_tape("m.vm")
    assert _fields(t) == _fields(native.compile_vm(ALL_OPS))


def test_iter_ops_and_opcode_tables_equal():
    assert list(bc.iter_ops()) == list(ref_bc.iter_ops())
    assert {int(k): v for k, v in bc._CANONICAL.items()} == {
        int(k): v for k, v in ref_bc._CANONICAL.items()}


def test_native_source_is_the_reference_compiler():
    """The port's C++ is the reference's, but for a comment."""
    a = pathlib.Path(native.__file__).with_name("tape_compiler.cpp")
    b = pathlib.Path(ref_native.__file__).with_name("tape_compiler.cpp")
    diff = subprocess.run(["diff", str(b), str(a)], capture_output=True,
                          text=True).stdout
    changed = [ln for ln in diff.splitlines() if ln[:1] in "<>"]
    assert all(ln.lstrip("<> ").startswith("//") for ln in changed), changed
