"""Mini script engine for shape construction.

A Python re-implementation of the reference's Rhai binding surface
(fidget-rhai/src/{lib,tree,shapes,types,constants}.rs): scripts are
general-purpose programs evaluated once to *trace* a math expression —
`x + y` builds `Add(Var::X, Var::Y)`, it does no arithmetic.

The language is the Rhai subset used by the bundled models and the
reference's doctests: `let`, `fn`, `for .. in a..b`, `if/else`,
blocks-as-expressions, method chaining, arrays, `#{}` object maps,
operator overloading on trees, and reflection-driven shape builders
(map form, transform chaining, binary/reduce/positional dispatch, the
coercion rules documented at fidget-rhai/src/lib.rs:85-225).

Entry points: `engine()` -> Engine with `.run(script)`; `eval_script`
returns the traced shapes (from `draw`/`draw_rgb` calls, falling back
to a trailing Tree expression).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field, fields as dc_fields

from ..core.tree import Tree, tree_min
from ..shapes import SHAPE_REGISTRY, Axis, Plane, ShapeDef

__all__ = ["Engine", "ScriptError", "ScriptResult", "engine", "eval_script"]


class ScriptError(ValueError):
    pass


# =====================================================================
# tokenizer

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d+(?:[eE][+-]?\d+)?|\d+\.(?!\.)(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<op>\#\{|\.\.=?|=>|==|!=|<=|>=|&&|\|\||\+=|-=|\*=|/=|%=|[-+*/%(){}\[\],;:.<>=!|&])
    """,
    re.VERBOSE | re.DOTALL,
)

_KEYWORDS = {"let", "fn", "for", "in", "if", "else", "return", "true", "false", "while", "break", "continue", "switch"}


def tokenize(src: str):
    pos = 0
    out = []
    while pos < len(src):
        mm = _TOKEN_RE.match(src, pos)
        if not mm:
            raise ScriptError(f"unexpected character {src[pos]!r} at {pos}")
        pos = mm.end()
        if mm.lastgroup == "ws":
            continue
        kind = mm.lastgroup
        text = mm.group()
        if kind == "num":
            val = float(text)
            is_int = re.fullmatch(r"\d+", text) is not None
            out.append(("num", int(text) if is_int else val))
        elif kind == "ident":
            if text in _KEYWORDS:
                out.append((text, text))
            else:
                out.append(("ident", text))
        elif kind == "str":
            out.append(("str", text[1:-1]))
        else:
            out.append((text, text))
    out.append(("eof", None))
    return out


# =====================================================================
# parser (recursive descent + Pratt expressions)

_BINARY_PREC = {
    "||": 1, "&&": 2,
    "==": 3, "!=": 3,
    "<": 4, "<=": 4, ">": 4, ">=": 4,
    "..": 5, "..=": 5,
    "+": 6, "-": 6,
    "*": 7, "/": 7, "%": 7,
}


class Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind):
        t = self.next()
        if t[0] != kind:
            raise ScriptError(f"expected {kind!r}, got {t[0]!r}")
        return t

    def accept(self, kind):
        if self.peek()[0] == kind:
            return self.next()
        return None

    # -- statements ---------------------------------------------------

    def parse_program(self):
        stmts = []
        while self.peek()[0] != "eof":
            stmts.append(self.parse_stmt())
        return ("block", stmts)

    def parse_block(self):
        self.expect("{")
        stmts = []
        while self.peek()[0] != "}":
            stmts.append(self.parse_stmt())
        self.expect("}")
        return ("block", stmts)

    def parse_stmt(self):
        k = self.peek()[0]
        if k == "let":
            self.next()
            name = self.expect("ident")[1]
            self.expect("=")
            e = self.parse_expr()
            self.accept(";")
            return ("let", name, e)
        if k == "fn":
            self.next()
            name = self.expect("ident")[1]
            self.expect("(")
            params = []
            while self.peek()[0] != ")":
                params.append(self.expect("ident")[1])
                if not self.accept(","):
                    break
            self.expect(")")
            body = self.parse_block()
            return ("fndef", name, params, body)
        if k == "for":
            self.next()
            var = self.expect("ident")[1]
            self.expect("in")
            it = self.parse_expr()
            body = self.parse_block()
            return ("for", var, it, body)
        if k == "while":
            self.next()
            cond = self.parse_expr()
            body = self.parse_block()
            return ("while", cond, body)
        if k == "return":
            self.next()
            e = None
            if self.peek()[0] not in (";", "}", "eof"):
                e = self.parse_expr()
            self.accept(";")
            return ("return", e)
        if k == "break":
            self.next()
            self.accept(";")
            return ("break",)
        if k == "continue":
            self.next()
            self.accept(";")
            return ("continue",)
        # assignment or expression statement
        e = self.parse_expr()
        nk = self.peek()[0]
        if nk == "=" and e[0] in ("ident", "prop", "index"):
            self.next()
            rhs = self.parse_expr()
            self.accept(";")
            return ("assign", e, rhs)
        if nk in ("+=", "-=", "*=", "/=", "%=") and e[0] in ("ident", "prop", "index"):
            op = self.next()[0][0]
            rhs = self.parse_expr()
            self.accept(";")
            return ("assign", e, ("binop", op, e, rhs))
        self.accept(";")
        return ("expr", e)

    # -- expressions ----------------------------------------------------

    def parse_expr(self, min_prec: int = 0):
        lhs = self.parse_unary()
        while True:
            k = self.peek()[0]
            prec = _BINARY_PREC.get(k)
            if prec is None or prec < min_prec:
                return lhs
            self.next()
            if k in ("..", "..="):
                rhs = self.parse_expr(prec + 1)
                lhs = ("range", lhs, rhs, k == "..=")
            else:
                rhs = self.parse_expr(prec + 1)
                lhs = ("binop", k, lhs, rhs)

    def parse_unary(self):
        k = self.peek()[0]
        if k == "-":
            self.next()
            return ("neg", self.parse_unary())
        if k == "!":
            self.next()
            return ("not", self.parse_unary())
        if k == "+":
            self.next()
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            k = self.peek()[0]
            if k == ".":
                self.next()
                name = self.expect("ident")[1]
                if self.peek()[0] == "(":
                    args = self.parse_args()
                    e = ("method", e, name, args)
                else:
                    e = ("prop", e, name)
            elif k == "(" and e[0] == "ident":
                args = self.parse_args()
                e = ("call", e[1], args)
            elif k == "(":
                # calling a non-ident callee: closure values, e.g.
                # (make_adder(1))(2) or fns[0](x)
                args = self.parse_args()
                e = ("callv", e, args)
            elif k == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                e = ("index", e, idx)
            else:
                return e

    def parse_args(self):
        self.expect("(")
        args = []
        while self.peek()[0] != ")":
            args.append(self.parse_expr())
            if not self.accept(","):
                break
        self.expect(")")
        return args

    def parse_primary(self):
        t = self.next()
        k, v = t
        if k == "num":
            return ("num", v)
        if k == "str":
            return ("strlit", v)
        if k == "true":
            return ("bool", True)
        if k == "false":
            return ("bool", False)
        if k == "ident":
            return ("ident", v)
        if k == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if k == "[":
            items = []
            while self.peek()[0] != "]":
                items.append(self.parse_expr())
                if not self.accept(","):
                    break
            self.expect("]")
            return ("array", items)
        if k == "#{":
            pairs = []
            while self.peek()[0] != "}":
                key = self.expect("ident")[1]
                self.expect(":")
                pairs.append((key, self.parse_expr()))
                if not self.accept(","):
                    break
            self.expect("}")
            return ("map", pairs)
        if k == "if":
            cond = self.parse_expr()
            then = self.parse_block()
            els = None
            if self.accept("else"):
                if self.peek()[0] == "if":
                    self.next()
                    # else-if chain: re-parse as nested if expression
                    self.i -= 1
                    els = ("block", [("expr", self.parse_primary())])
                else:
                    els = self.parse_block()
            return ("if", cond, then, els)
        if k == "{":
            self.i -= 1
            return self.parse_block()
        if k in ("|", "||"):
            # anonymous function / closure: |a, b| expr  (Rhai's
            # closure syntax; `||` is the zero-parameter form)
            params = []
            if k == "|":
                while self.peek()[0] != "|":
                    params.append(self.expect("ident")[1])
                    if not self.accept(","):
                        break
                self.expect("|")
            body = self.parse_expr()
            return ("closure", params, body)
        if k == "switch":
            val = self.parse_expr()
            self.expect("{")
            arms = []
            while self.peek()[0] != "}":
                if self.peek() == ("ident", "_"):
                    self.next()
                    pats = None  # default arm
                else:
                    pats = [self.parse_expr()]
                    while self.accept("|"):
                        pats.append(self.parse_expr())
                guard = None
                if self.accept("if"):
                    guard = self.parse_expr()
                self.expect("=>")
                body = self.parse_expr()
                arms.append((pats, guard, body))
                if not self.accept(","):
                    break
            self.expect("}")
            return ("switch", val, arms)
        raise ScriptError(f"unexpected token {k!r}")


# =====================================================================
# interpreter

class _Break(Exception):
    pass


class _Continue(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


@dataclass
class _Closure:
    """An anonymous-function value (Rhai `|x| ...`).

    Captures the defining environment chain by reference — mutations to
    captured variables are visible in both directions, matching Rhai's
    shared-variable closure capture (fidget embeds full Rhai:
    fidget-rhai/src/lib.rs:74-120)."""

    params: list
    body: tuple
    env: list

    def __repr__(self) -> str:
        return f"<closure({', '.join(self.params)})>"


@dataclass
class ScriptResult:
    """Shapes traced by a script: `draw` calls plus an optional trailing
    Tree expression. `colors` holds (r, g, b) for draw_rgb entries."""

    shapes: list = field(default_factory=list)
    colors: list = field(default_factory=list)
    last: object = None

    @property
    def tree(self) -> Tree:
        if len(self.shapes) == 1:
            return self.shapes[0]
        if not self.shapes:
            raise ScriptError("script did not draw any shapes")
        return tree_min(*self.shapes)


_CONSTANTS = {
    "PI": math.pi, "E": math.e, "TAU": math.tau,
    "PHI": (1 + math.sqrt(5)) / 2, "GOLDEN_RATIO": (1 + math.sqrt(5)) / 2,
    "SQRT_2": math.sqrt(2), "SQRT_3": math.sqrt(3),
    "FRAC_PI_2": math.pi / 2, "FRAC_PI_3": math.pi / 3,
    "FRAC_PI_4": math.pi / 4, "FRAC_PI_6": math.pi / 6,
    "FRAC_PI_8": math.pi / 8, "FRAC_1_PI": 1 / math.pi,
    "LN_2": math.log(2), "LN_10": math.log(10),
    "INFINITY": math.inf,
}

_TREE_UNARY = {
    "abs", "sqrt", "square", "floor", "ceil", "round", "sin", "cos",
    "tan", "asin", "acos", "atan", "exp", "ln", "recip",
}
_NUM_UNARY = {
    "abs": abs, "sqrt": math.sqrt, "square": lambda v: v * v,
    "floor": math.floor, "ceil": math.ceil, "round": round,
    "sin": math.sin, "cos": math.cos, "tan": math.tan,
    "asin": math.asin, "acos": math.acos, "atan": math.atan,
    "exp": math.exp, "ln": math.log, "recip": lambda v: 1.0 / v,
}


def _is_num(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_treeish(v):
    return isinstance(v, (Tree, ShapeDef))


def _as_tree(v):
    """Tree coercion incl. list-of-trees union reduction
    (fidget-rhai/src/lib.rs:216-225)."""
    if isinstance(v, Tree):
        return v
    if isinstance(v, ShapeDef):
        return v.to_tree()
    if _is_num(v):
        return Tree.constant(float(v))
    if isinstance(v, list) and v and all(
        isinstance(t, (Tree, ShapeDef)) for t in v
    ):
        return tree_min(*[_as_tree(t) for t in v])
    raise ScriptError(f"cannot convert {type(v).__name__} to Tree")


def _snake(name: str) -> str:
    return re.sub(r"(?<=[a-z0-9])([A-Z])", r"_\1", name).lower()


def _coerce_field(value, default, name):
    """Coerces a script value to a shape-field value using the field's
    default as the type hint (the build_tagged_value analog,
    fidget-rhai/src/shapes.rs:32-52)."""
    if isinstance(default, tuple) and not isinstance(default, Axis):
        n = len(default)
        if _is_num(value):
            raise ScriptError(f"field {name}: expected a {n}-vector")
        seq = list(value) if isinstance(value, (list, tuple)) else None
        if seq is None:
            raise ScriptError(f"field {name}: expected a {n}-vector")
        if len(seq) == n - 1:
            seq = seq + [default[-1]]  # vec2 -> vec3 with field default z
        if len(seq) != n:
            raise ScriptError(f"field {name}: expected a {n}-vector")
        return tuple(float(s) for s in seq)
    if isinstance(default, Axis) or name == "axis":
        if isinstance(value, Axis):
            return value
        return Axis(tuple(float(s) for s in value))
    if isinstance(default, Plane) or name == "plane":
        if isinstance(value, Plane):
            return value
        if isinstance(value, dict):
            ax = value.get("axis", Axis.Z)
            if not isinstance(ax, Axis):
                ax = Axis(tuple(float(s) for s in ax))
            return Plane(ax, float(value.get("offset", 0.0)))
        raise ScriptError(f"field {name}: expected a plane")
    if isinstance(default, float) or default is None and name in ("radius",):
        if not _is_num(value):
            raise ScriptError(f"field {name}: expected a number")
        return float(value)
    if isinstance(default, list):  # Vec<Tree>
        if isinstance(value, (Tree, ShapeDef)):
            return [_as_tree(value)]
        return [_as_tree(t) for t in value]
    # Tree-typed fields (default None)
    return _as_tree(value)


class _ShapeBuilder:
    """Callable implementing the reference's dispatch strategies for one
    shape type (fidget-rhai/src/shapes.rs:120-190)."""

    def __init__(self, cls):
        self.cls = cls
        self.fields = dc_fields(cls)
        self.defaults = {}
        for f in self.fields:
            import dataclasses

            if f.default is not dataclasses.MISSING:
                self.defaults[f.name] = f.default
            elif f.default_factory is not dataclasses.MISSING:
                self.defaults[f.name] = f.default_factory()

    def _build(self, kwargs):
        vals = {}
        for f in self.fields:
            d = self.defaults.get(f.name)
            if f.name in kwargs:
                vals[f.name] = _coerce_field(kwargs[f.name], d, f.name)
            else:
                vals[f.name] = d
        return self.cls(**vals).to_tree()

    def __call__(self, *args):
        fl = self.fields
        # 1. single object map
        if len(args) == 1 and isinstance(args[0], dict):
            return self._build(dict(args[0]))
        # 2. reduce form: Vec<Tree> field takes array or tree varargs
        if len(fl) == 1 and isinstance(self.defaults.get(fl[0].name), list):
            if len(args) == 1 and isinstance(args[0], list):
                return self._build({fl[0].name: args[0]})
            return self._build({fl[0].name: list(args)})
        # 3. transform chaining: tree-ish first arg
        if args and (_is_treeish(args[0]) or (
            isinstance(args[0], list)
            and args[0]
            and all(_is_treeish(t) for t in args[0])
        )):
            kwargs = {fl[0].name: _as_tree(args[0])}
            rest = list(args[1:])
            # two-tree form (e.g. difference(a, b))
            if (
                len(fl) >= 2
                and self.defaults.get(fl[1].name) is None
                and rest
                and (_is_treeish(rest[0]) or isinstance(rest[0], list))
            ):
                kwargs[fl[1].name] = _as_tree(rest.pop(0))
            if rest and isinstance(rest[0], dict):
                kwargs.update(rest.pop(0))
            elif rest:
                # positional values fill the next COMPATIBLE unset
                # fields (type-driven like case 4, so rotate(shape,
                # 45.0) lands the float in `angle`, not `axis`)
                for a in rest:
                    placed = False
                    for f in fl[1:]:
                        if f.name in kwargs:
                            continue
                        d = self.defaults.get(f.name)
                        try:
                            kwargs[f.name] = _coerce_field(a, d, f.name)
                            placed = True
                            break
                        except (ScriptError, TypeError, ValueError):
                            continue
                    if not placed:
                        raise ScriptError(
                            f"cannot place argument {a!r} for "
                            f"{self.cls.__name__}"
                        )
                rest = []
            if rest:
                raise ScriptError(f"too many arguments for {self.cls.__name__}")
            return self._build(kwargs)
        # 4. unique-typed positional dispatch
        kwargs = {}
        for a in args:
            placed = False
            for f in fl:
                if f.name in kwargs:
                    continue
                d = self.defaults.get(f.name)
                try:
                    kwargs[f.name] = _coerce_field(a, d, f.name)
                    placed = True
                    break
                except (ScriptError, TypeError, ValueError):
                    continue
            if not placed:
                raise ScriptError(
                    f"cannot place argument {a!r} for {self.cls.__name__}"
                )
        return self._build(kwargs)


class Engine:
    """The fidget_rhai::engine() analog: a configured interpreter with
    tree overloads, shape builders, constants, and draw bindings."""

    MAX_STEPS = 500_000

    def __init__(self):
        self.builders = {}
        for name, cls in SHAPE_REGISTRY.items():
            self.builders[_snake(name)] = _ShapeBuilder(cls)
        # the reference registers fidget_shapes::types::Plane as "plane"
        self.builders["plane"] = self.builders["half_plane"]

    # -- public API ------------------------------------------------------

    def run(self, src: str) -> ScriptResult:
        ast = Parser(tokenize(src)).parse_program()
        result = ScriptResult()
        env = [dict(_CONSTANTS)]
        env[0].update(
            x=Tree.x(), y=Tree.y(), z=Tree.z(),
        )
        self._steps = 0
        self._result = result
        self._fns = {}
        try:
            last = self._exec_block(ast, env)
        except _Return as r:
            # Rhai allows a top-level `return`: it terminates the
            # script with that value
            last = r.value
        except (_Break, _Continue):
            raise ScriptError("break/continue outside of a loop")
        result.last = last
        if not result.shapes and isinstance(last, (Tree, ShapeDef)):
            result.shapes.append(_as_tree(last))
        return result

    def eval(self, src: str):
        return self.run(src).last

    # -- execution -------------------------------------------------------

    def _tick(self):
        self._steps += 1
        if self._steps > self.MAX_STEPS:
            raise ScriptError("script exceeded execution step limit")

    def _exec_block(self, block, env):
        assert block[0] == "block"
        last = None
        for st in block[1]:
            last = self._exec_stmt(st, env)
        return last

    def _lookup(self, env, name):
        for scope in reversed(env):
            if name in scope:
                return scope[name]
        raise ScriptError(f"undefined variable {name!r}")

    def _exec_stmt(self, st, env):
        self._tick()
        k = st[0]
        if k == "let":
            env[-1][st[1]] = self._eval(st[2], env)
            return None
        if k == "fndef":
            self._fns[st[1]] = (st[2], st[3])
            return None
        if k == "assign":
            target, rhs = st[1], st[2]
            val = self._eval(rhs, env)
            if target[0] == "ident":
                name = target[1]
                for scope in reversed(env):
                    if name in scope:
                        scope[name] = val
                        return None
                env[-1][name] = val
                return None
            if target[0] == "index":
                obj = self._eval(target[1], env)
                idx = self._eval(target[2], env)
                obj[int(idx)] = val
                return None
            if target[0] == "prop":
                obj = self._eval(target[1], env)
                if isinstance(obj, dict):
                    obj[target[2]] = val
                    return None
                raise ScriptError(
                    f"cannot assign property {target[2]!r} on "
                    f"{type(obj).__name__}"
                )
            raise ScriptError("unsupported assignment target")
        if k == "for":
            var = st[1]
            it = self._eval(st[2], env)
            if isinstance(it, range):
                seq = it
            elif isinstance(it, list):
                seq = it
            else:
                raise ScriptError("for loop needs a range or array")
            env.append({})
            try:
                for v in seq:
                    env[-1][var] = v
                    try:
                        self._exec_block(st[3], env)
                    except _Continue:
                        continue
                    except _Break:
                        break
            finally:
                env.pop()
            return None
        if k == "while":
            env.append({})
            try:
                while self._truthy(self._eval(st[1], env)):
                    self._tick()
                    try:
                        self._exec_block(st[2], env)
                    except _Continue:
                        continue
                    except _Break:
                        break
            finally:
                env.pop()
            return None
        if k == "return":
            raise _Return(None if st[1] is None else self._eval(st[1], env))
        if k == "break":
            raise _Break()
        if k == "continue":
            raise _Continue()
        if k == "expr":
            return self._eval(st[1], env)
        raise ScriptError(f"unknown statement {k!r}")

    def _truthy(self, v):
        if isinstance(v, bool):
            return v
        if _is_num(v):
            return v != 0
        raise ScriptError("condition must be a boolean (trees not allowed)")

    # -- expressions -----------------------------------------------------

    def _eval(self, e, env):
        self._tick()
        k = e[0]
        if k == "num":
            return e[1]
        if k == "strlit":
            return e[1]
        if k == "bool":
            return e[1]
        if k == "ident":
            return self._lookup(env, e[1])
        if k == "neg":
            v = self._eval(e[1], env)
            return -v
        if k == "not":
            return not self._truthy(self._eval(e[1], env))
        if k == "binop":
            return self._binop(e[1], self._eval(e[2], env), self._eval(e[3], env))
        if k == "range":
            a = int(self._eval(e[1], env))
            b = int(self._eval(e[2], env))
            return range(a, b + 1 if e[3] else b)
        if k == "array":
            return [self._eval(x, env) for x in e[1]]
        if k == "map":
            return {key: self._eval(val, env) for key, val in e[1]}
        if k == "if":
            if self._truthy(self._eval(e[1], env)):
                env.append({})
                try:
                    return self._exec_block(e[2], env)
                finally:
                    env.pop()
            elif e[3] is not None:
                env.append({})
                try:
                    return self._exec_block(e[3], env)
                finally:
                    env.pop()
            return None
        if k == "block":
            env.append({})
            try:
                return self._exec_block(e, env)
            finally:
                env.pop()
        if k == "prop":
            obj = self._eval(e[1], env)
            return self._prop(obj, e[2])
        if k == "index":
            obj = self._eval(e[1], env)
            return obj[int(self._eval(e[2], env))]
        if k == "call":
            args = [self._eval(a, env) for a in e[2]]
            return self._call(e[1], args, env)
        if k == "callv":
            fn = self._eval(e[1], env)
            args = [self._eval(a, env) for a in e[2]]
            if not isinstance(fn, _Closure):
                raise ScriptError(
                    f"cannot call a {type(fn).__name__} value"
                )
            return self._invoke_closure(fn, args)
        if k == "method":
            obj = self._eval(e[1], env)
            args = [self._eval(a, env) for a in e[3]]
            return self._call(e[2], [obj] + args, env)
        if k == "closure":
            return _Closure(e[1], e[2], list(env))
        if k == "switch":
            v = self._eval(e[1], env)
            default = None
            for pats, guard, body in e[2]:
                if pats is None:
                    default = (guard, body)
                    continue
                for p in pats:
                    pv = self._eval(p, env)
                    if isinstance(pv, range):
                        hit = (
                            isinstance(v, (int, float))
                            and not isinstance(v, bool)
                            and pv.start <= v < pv.stop
                        )
                    else:
                        hit = type(v) is type(pv) and v == pv
                    if hit and (
                        guard is None
                        or self._truthy(self._eval(guard, env))
                    ):
                        return self._eval(body, env)
            if default is not None:
                guard, body = default
                if guard is None or self._truthy(self._eval(guard, env)):
                    return self._eval(body, env)
            return None
        raise ScriptError(f"unknown expression {k!r}")

    def _invoke_closure(self, c: _Closure, args):
        if len(args) != len(c.params):
            raise ScriptError(
                f"closure expects {len(c.params)} args, got {len(args)}"
            )
        env2 = c.env + [dict(zip(c.params, args))]
        try:
            return self._eval(c.body, env2)
        except _Return as r:
            return r.value

    def _prop(self, obj, name):
        if isinstance(obj, dict):
            if name not in obj:
                raise ScriptError(f"missing map property {name!r}")
            return obj[name]
        if isinstance(obj, (tuple, list)):
            idx = {"x": 0, "y": 1, "z": 2, "w": 3}.get(name)
            if idx is not None and idx < len(obj):
                return obj[idx]
        raise ScriptError(f"no property {name!r} on {type(obj).__name__}")

    def _binop(self, op, a, b):
        treeish = _is_treeish(a) or _is_treeish(b)
        if treeish:
            ta = _as_tree(a) if _is_treeish(a) else a
            tb = _as_tree(b) if _is_treeish(b) else b
            if op == "+":
                return ta + tb
            if op == "-":
                return ta - tb
            if op == "*":
                return ta * tb
            if op == "/":
                return ta / tb
            if op == "%":
                return (ta if isinstance(ta, Tree) else Tree.constant(ta)).modulo(tb)
            raise ScriptError(
                f"comparison {op!r} is not allowed on trees "
                "(fidget-rhai/src/tree.rs:123)"
            )
        if op == "&&":
            return self._truthy(a) and self._truthy(b)
        if op == "||":
            return self._truthy(a) or self._truthy(b)
        if op == "==":
            return a == b
        if op == "!=":
            return a != b
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        both_int = isinstance(a, int) and isinstance(b, int) and not (
            isinstance(a, bool) or isinstance(b, bool)
        )
        if op == "+":
            return a + b
        if op == "-":
            return a - b
        if op == "*":
            return a * b
        if op == "/":
            if both_int:
                return int(a / b) if b != 0 else _raise(ScriptError("integer division by zero"))
            return a / b
        if op == "%":
            if both_int:
                if b == 0:
                    raise ScriptError("integer modulo by zero")
                return int(math.fmod(a, b))
            if b == 0:
                return math.nan  # Rust f32 % 0.0 semantics
            return math.fmod(a, b)
        raise ScriptError(f"unknown operator {op!r}")

    # -- calls -------------------------------------------------------------

    def _call(self, name, args, env):
        # closure values: `f(x)` where f is a variable holding a
        # closure, and the explicit `f.call(x)` form
        if name == "call" and args and isinstance(args[0], _Closure):
            return self._invoke_closure(args[0], args[1:])
        if name not in self._fns:
            for scope in reversed(env):
                if name in scope:
                    v = scope[name]
                    if isinstance(v, _Closure):
                        return self._invoke_closure(v, args)
                    break

        # user-defined functions (checked before builtins: Rhai lets
        # script fns shadow the standard library)
        if name in self._fns:
            params, body = self._fns[name]
            if len(args) != len(params):
                raise ScriptError(
                    f"{name} expects {len(params)} args, got {len(args)}"
                )
            scope = dict(zip(params, args))
            env2 = [env[0], scope]
            try:
                return self._exec_block(body, env2)
            except _Return as r:
                return r.value
            except (_Break, _Continue):
                # must not leak across the call boundary and break the
                # CALLER's loop (Rhai errors on break outside a loop)
                raise ScriptError(
                    f"break/continue outside of a loop in fn {name}"
                )

        # array / map builtins (the Rhai standard-library subset that
        # the reference's scripts lean on)
        if args and isinstance(args[0], list):
            arr, rest = args[0], args[1:]
            if name == "len" and not rest:
                return len(arr)
            if name == "is_empty" and not rest:
                return len(arr) == 0
            if name == "push" and len(rest) == 1:
                arr.append(rest[0])
                return None
            if name == "pop" and not rest:
                if not arr:
                    raise ScriptError("pop from an empty array")
                return arr.pop()
            if name == "contains" and len(rest) == 1:
                return rest[0] in arr
            if name == "reverse" and not rest:
                arr.reverse()
                return None
            if name == "map" and len(rest) == 1 and isinstance(rest[0], _Closure):
                return [self._invoke_closure(rest[0], [v]) for v in arr]
            if name == "filter" and len(rest) == 1 and isinstance(rest[0], _Closure):
                return [
                    v for v in arr
                    if self._truthy(self._invoke_closure(rest[0], [v]))
                ]
            if name == "reduce" and rest and isinstance(rest[0], _Closure):
                f = rest[0]
                if len(rest) == 2:
                    acc = rest[1]
                    items = arr
                elif arr:
                    acc = arr[0]
                    items = arr[1:]
                else:
                    return None
                for v in items:
                    acc = self._invoke_closure(f, [acc, v])
                return acc
        if isinstance(args[0] if args else None, dict):
            m, rest = args[0], args[1:]
            if name == "len" and not rest:
                return len(m)
            if name == "contains" and len(rest) == 1:
                return rest[0] in m
            if name == "keys" and not rest:
                return list(m.keys())
            if name == "values" and not rest:
                return list(m.values())

        # tree / math builtins
        if name in _TREE_UNARY and len(args) == 1:
            (a,) = args
            if _is_treeish(a):
                return getattr(_as_tree(a), "abs" if name == "abs" else name)()
            if _is_num(a):
                return _NUM_UNARY[name](a)
        if name in ("min", "max") and len(args) == 2:
            a, b = args
            if _is_treeish(a) or _is_treeish(b):
                t = _as_tree(a)
                return t.min(_as_tree(b)) if name == "min" else t.max(_as_tree(b))
            return min(a, b) if name == "min" else max(a, b)
        if name == "atan2" and len(args) == 2:
            a, b = args
            if _is_treeish(a) or _is_treeish(b):
                return _as_tree(a).atan2(_as_tree(b))
            return math.atan2(a, b)
        if name == "modulo" and len(args) == 2:
            a, b = args
            if _is_treeish(a) or _is_treeish(b):
                return _as_tree(a).modulo(_as_tree(b))
            return a - b * math.floor(a / b)
        if name == "compare" and len(args) == 2:
            return _as_tree(args[0]).compare(_as_tree(args[1]))
        if name == "pow" and len(args) == 2:
            return args[0] ** args[1]

        if name == "axes":
            return {"x": Tree.x(), "y": Tree.y(), "z": Tree.z()}
        if name in ("vec2", "vec3", "vec4"):
            n = int(name[-1])
            if len(args) != n:
                raise ScriptError(f"{name} expects {n} arguments")
            return tuple(float(a) for a in args)
        if name == "remap":
            obj, *rest = args
            t = _as_tree(obj)
            if len(rest) == 3:
                return t.remap_xyz(*rest)
            if len(rest) == 2:
                return t.remap_xyz(rest[0], rest[1], Tree.z())
            raise ScriptError("remap expects 2 or 3 coordinates")
        if name == "draw":
            self._result.shapes.append(_as_tree(args[0]))
            self._result.colors.append(None)
            return None
        if name == "draw_rgb":
            self._result.shapes.append(_as_tree(args[0]))
            self._result.colors.append(tuple(float(a) for a in args[1:4]))
            return None

        # shape builders (union/intersection/difference/move/... included)
        if name in self.builders:
            return self.builders[name](*args)

        raise ScriptError(f"unknown function {name!r}")


def _raise(exc):
    raise exc


def engine() -> Engine:
    """Builds a configured script engine (fidget_rhai::engine analog)."""
    return Engine()


def eval_script(src: str) -> ScriptResult:
    """Evaluates a script and returns the traced shapes.

    >>> from fidget_tpu_torch.script import eval_script
    >>> res = eval_script(
    ...     "let c = circle(#{ center: [0, 0], radius: 1 }); draw(c);"
    ... )
    >>> len(res.shapes)
    1
    """
    return engine().run(src)
